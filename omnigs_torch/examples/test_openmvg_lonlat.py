"""Evaluate a trained PLY on a test split.

The port's copy of `examples/test_openmvg_lonlat.py`: the same arguments
and output files (`image_test/`, `render_time_test.txt`,
`dssim_test.txt`, `psnr_test.txt`, `psnr_gaussian_splatting_test.txt`),
plus ``--device``.

    python -m omnigs_torch.examples.test_openmvg_lonlat CFG_YAML OUTPUT_DIR \\
        SFM_JSON MODEL_PLY [--image-root DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> dict:
    """Run the CLI; returns the mean metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("cfg")
    ap.add_argument("output_dir")
    ap.add_argument("sfm_json")
    ap.add_argument("model_ply")
    ap.add_argument("--image-root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from omnigs_torch.config import load_config, raster_config_from
    from omnigs_torch.io.openmvg import load_openmvg_scene
    from omnigs_torch.io.ply import load_gaussian_ply
    from omnigs_torch.train.eval import render_and_record_all_keyframes

    cfg = load_config(args.cfg)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    scene = load_openmvg_scene(
        args.sfm_json,
        None,
        image_root=args.image_root,
        znear=cfg.pipe.z_near,
        zfar=cfg.pipe.z_far,
    )
    # rendered at the configured maximum SH degree
    model = load_gaussian_ply(args.model_ply, capacity=cfg.tpu.capacity,
                              device=args.device)
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                    device=args.device)
    means = render_and_record_all_keyframes(
        model,
        scene,
        cfg.model.sh_degree,
        raster_config_from(cfg),
        bg,
        result_dir=out,
        name_suffix="_test",
        skip_bottom_ratio=cfg.opt.skip_bottom_ratio,
        record_rendered_image=cfg.mapper.record_rendered_image,
        record_ground_truth_image=cfg.mapper.record_ground_truth_image,
        record_loss_image=cfg.mapper.record_loss_image,
    )
    print(means, flush=True)
    return means


if __name__ == "__main__":
    main()
