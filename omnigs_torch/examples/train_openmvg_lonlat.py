"""Train an omnidirectional Gaussian field from an openMVG scene.

The port's copy of `examples/train_openmvg_lonlat.py`: the same arguments
and the same output tree (cameras.json, cfg_args, the metric files and
images of each record and of the shutdown record, the iteration-numbered
PLYs, `used_times/`, `DevicePeakUsageMB.txt`), plus ``--device``.

    python -m omnigs_torch.examples.train_openmvg_lonlat CFG_YAML OUTPUT_DIR \\
        SFM_JSON POINTS_PLY [--image-root DIR] [--iters N] [--seed S] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def main(argv=None) -> dict:
    """Run the CLI; returns what the loop did (iterations, windows, single
    steps, host seconds of the loop, last EMA loss, live Gaussians, the
    output directory)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("cfg")
    ap.add_argument("output_dir")
    ap.add_argument("sfm_json")
    ap.add_argument("points_ply")
    ap.add_argument("--image-root", default=None)
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument(
        "--viewer", type=int, default=0, metavar="PORT",
        help="the live viewer is not ported yet (ROADMAP queue 1 item 7)",
    )
    ap.add_argument("--viewer-width", type=int, default=960)
    ap.add_argument(
        "--seed", type=int, default=0,
        help="training RNG seed (keyframe sampling, densify splits) — the"
        " quality gate runs two seeds and gates on their median",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.viewer:
        raise NotImplementedError(
            "--viewer: the live viewer is not ported to omnigs_torch yet "
            "(ROADMAP queue 1 item 7)"
        )

    from omnigs_torch.config import load_config
    from omnigs_torch.io.openmvg import load_openmvg_scene
    from omnigs_torch.train.eval import render_and_record_all_keyframes
    from omnigs_torch.train.record import (
        save_cameras_json,
        save_model_params,
        save_ply_checkpoint,
        write_keyframe_used_times,
    )
    from omnigs_torch.train.trainer import Trainer
    from omnigs_torch.utils.profiling import write_peak_memory

    cfg = load_config(args.cfg)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    print("Loading scene…", flush=True)
    scene = load_openmvg_scene(
        args.sfm_json,
        args.points_ply,
        image_root=args.image_root,
        znear=cfg.pipe.z_near,
        zfar=cfg.pipe.z_far,
    )
    print(
        f"{len(scene.keyframes)} keyframes, {len(scene.points)} SfM points",
        flush=True,
    )

    tr = Trainer(scene, cfg, output_dir=out, seed=args.seed, device=args.device)
    tr.init_from_sfm()
    save_cameras_json(scene, out)
    save_model_params(
        out, cfg.model.sh_degree, cfg.model.white_background, args.sfm_json, str(out)
    )

    def record(name_suffix=""):
        return render_and_record_all_keyframes(
            tr.model,
            scene,
            tr.sh_degree,
            tr.raster_cfg,
            tr.bg,
            result_dir=out,
            name_suffix=name_suffix,
            skip_bottom_ratio=cfg.opt.skip_bottom_ratio,
            record_rendered_image=cfg.mapper.record_rendered_image,
            record_ground_truth_image=cfg.mapper.record_ground_truth_image,
            record_loss_image=cfg.mapper.record_loss_image,
        )

    n_iters = args.iters or cfg.opt.max_num_iterations
    record_interval = cfg.mapper.all_keyframes_record_interval
    fuse = cfg.tpu.fuse_steps
    windows = window_steps = single_steps = 0
    loop_s = 0.0
    t_last, it_last = time.time(), 0
    while tr.iteration < n_iters:
        t0 = time.time()
        budget = n_iters - tr.iteration
        for interval in (args.log_every, record_interval):
            if interval:
                budget = min(budget, interval - tr.iteration % interval)
        took = tr.train_window(min(budget, fuse)) if fuse > 1 else 0
        if took:
            windows += 1
            window_steps += took
        else:
            tr.train_iteration()
            single_steps += 1
        it = tr.iteration
        if args.log_every and it % args.log_every == 0:
            now = time.time()
            rate = (now - t_last) / max(it - it_last, 1) * 1000
            t_last, it_last = now, it
            print(
                f"iter {it}/{n_iters} loss={tr.drain_losses():.4f} "
                f"ema={tr.ema_loss:.4f} n={int(tr.model.num_active)} "
                f"{rate:.0f} ms/it",
                flush=True,
            )
        loop_s += time.time() - t0
        if record_interval and it % record_interval == 0:
            means = record()
            print(f"eval @ {it}: {means}", flush=True)
            save_ply_checkpoint(tr.model, out, it)

    # the shutdown record
    tr.drain_losses()
    write_peak_memory(out, tr.peak_memory)
    write_keyframe_used_times(tr.sampler, out / "used_times", "_shutdown")
    record("_shutdown")
    save_ply_checkpoint(tr.model, out, tr.iteration)
    print("done.", flush=True)
    return dict(
        iterations=tr.iteration, windows=windows, window_steps=window_steps,
        single_steps=single_steps, loop_s=loop_s, ema_loss=tr.ema_loss,
        live=int(tr.model.num_active), truncated=tr.total_truncated,
        overflow=tr.total_overflow, output_dir=str(out),
    )


if __name__ == "__main__":
    main()
