"""The sharded training window on (data × gauss) meshes: windows of
`ParallelTrainer.train_window` against the eager iterations they stand
for, on every rank.

Each rank builds two `ParallelTrainer`s from one scene (``--views``
keyframes whose ground truths are renders of `example.example_model`,
the SfM cloud its means plus N(0, 0.02) noise) with the production YAML
on a compressed schedule (densify every 1000, no opacity reset), starts
both at ``--start``, and takes ``--windows`` windows of ``--steps`` on one
and as many `train_iteration`s on the other. On cards under NCCL the
windows run in `window_mode` "graph" (replays of one captured sharded
step, whose collectives cross the ranks for every mesh but 1x1); with
``--device cpu`` the ranks are CPU processes under gloo and the windows
run "eager" (small sizes; its times are not device numbers). One JSON
line per mesh: every rank's mode, captures and replays, whether its final
model, Adam state, losses and counters equal the eager run's bit for bit,
ms a step of both, the first window's ms (its warm-up steps, capture and
replays) and the device memory it reserved (the graph's pool, the banks
and the window's buffers);
whether the ranks logged the same losses. A mesh needs one card per rank; a mesh the host cannot hold is
reported and skipped. Raises on any mismatch.

    python -m omnigs_torch.scripts.sharded_window_bench [--meshes 1x2 2x1 2x2]
        [--width 1920 --height 960] [--gaussians 131072] [--capacity 524288]
        [--views 4] [--steps 12] [--windows 2] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import math
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CONFIG = Path(__file__).resolve().parents[2] / "cfg" / "lonlat" / "360roam_lonlat.yaml"
SEED = 0
INIT_NOISE = 0.02
# a rank still running after this long is stuck: it prints every thread's
# stack and exits (a full-size mesh takes about a minute)
RANK_TIMEOUT_S = 300


def _scene(args, device):
    """``args.views`` keyframes looking along yaw k·2π/V with a small pitch
    and offset, each ground truth the render of the example model; the SfM
    cloud its means plus noise, with its dc colors."""
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.config import load_config, raster_config_from
    from omnigs_torch.ops.sh import sh2rgb
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.scene.scene import Scene
    from omnigs_torch.scripts.example import SH_DEGREE, example_model
    from omnigs_torch.train.renderer import render_model

    model = example_model(args.gaussians, device)
    camera = Camera(CameraType.LONLAT, args.width, args.height)
    cfg = raster_config_from(load_config(CONFIG))
    scene = Scene()
    for k in range(args.views):
        yaw, pitch = k * 2 * math.pi / args.views, 0.1 * (k - 1.5)
        cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
        rot = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32) @ np.array(
            [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        campos = np.array([0.05 * k, -0.03 * k, 0.02 * k], np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = rot, -rot @ campos
        with torch.inference_mode():
            image = render_model(model, camera, torch.from_numpy(vm).to(device),
                                 torch.from_numpy(campos).to(device),
                                 torch.zeros(3, device=device), SH_DEGREE, cfg).image
        scene.add_keyframe(Keyframe(k, camera, rot, vm[:3, 3].copy(),
                                    image=image.permute(1, 2, 0).cpu().numpy()))
    xyz = model.xyz.detach().cpu().numpy()
    rng = np.random.default_rng(SEED + 1)
    scene.points = (xyz + rng.normal(size=xyz.shape) * INIT_NOISE).astype(np.float32)
    scene.colors = torch.clamp(sh2rgb(model.features_dc.detach()[:, 0]), 0, 1).cpu().numpy()
    return scene


def _config(args, data, gauss):
    from omnigs_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.tpu = dataclasses.replace(cfg.tpu, capacity=args.capacity, mesh_data=data,
                                  mesh_gauss=gauss)
    # no event inside the windows: densify every 1000 from a start past the
    # last SH bump, no opacity reset
    cfg.opt.densification_interval = 1000
    cfg.opt.opacity_reset_interval = 0
    return cfg


def _state(tr):
    from omnigs_torch.model.gaussians import FIELD_NAMES

    out = {f"model/{k}": getattr(tr.model, k).detach().clone() for k in FIELD_NAMES}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v.clone() for k, v in getattr(tr.opt_state, m).items()})
    out["count"] = tr.opt_state.count.clone()
    return out


def _reserved_mb(device) -> float:
    """The device memory PyTorch's allocator holds, MB (0 off a card)."""
    return torch.cuda.memory_reserved(device) / 2**20 if device.type == "cuda" else 0.0


def _rank(rank, world, data, gauss, args, init_method, queue):
    """One rank: the window run against the eager run → its results."""
    from omnigs_torch.parallel.distributed import initialize
    from omnigs_torch.train.trainer_parallel import ParallelTrainer
    from omnigs_torch.utils import profiling

    faulthandler.dump_traceback_later(RANK_TIMEOUT_S, exit=True)
    try:
        device = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        initialize("nccl" if device.type == "cuda" else "gloo", init_method=init_method,
                   rank=rank, world_size=world)
        scene = _scene(args, device)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        out = {"rank": rank}
        runs = {}
        for name in ("window", "eager"):
            tr = ParallelTrainer(scene, _config(args, data, gauss), seed=SEED,
                                 device=str(device))
            tr.init_from_sfm()
            tr.iteration = args.start
            sync()
            replays = profiling.counters()["replays"]
            t0 = time.perf_counter()
            for w in range(args.windows):
                if name == "window":
                    if w == 0 and device.type == "cuda":
                        # the first window's growth: its graph's pool, the
                        # banks and the window's buffers
                        torch.cuda.empty_cache()
                    reserved, t1 = _reserved_mb(device), time.perf_counter()
                    took = tr.train_window(args.steps)
                    if took != args.steps:
                        raise RuntimeError(f"a window took {took} steps, not {args.steps}")
                    if w == 0:
                        sync()
                        out.update(first_window_ms=(time.perf_counter() - t1) * 1e3,
                                   first_window_reserved_mb=_reserved_mb(device) - reserved)
                else:
                    for _ in range(args.steps):
                        tr.train_iteration()
            sync()
            out[f"{name}_ms_per_step"] = (
                (time.perf_counter() - t0) * 1e3 / (args.windows * args.steps))
            losses = torch.cat([x.reshape(-1) for x, _, _ in tr._pending_losses])
            counts = [int(sum(int(p[i]) for p in tr._pending_losses)) for i in (1, 2)]
            runs[name] = (_state(tr), losses, counts)
            if name == "window":
                out.update(mode=tr.window_mode, captures=tr.step_graph.captures,
                           replays=profiling.counters()["replays"] - replays,
                           gt_bank_grows=tr.gt_bank_grows)
            del tr
        (sw, lw, cw), (se, le, ce) = runs["window"], runs["eager"]
        out["unequal"] = [k for k in sw if not torch.equal(sw[k], se[k])]
        out["losses_equal"] = bool(torch.equal(lw, le))
        out["counters"] = [cw, ce]
        out["losses"] = lw.tolist()
    except BaseException:
        # reported at once: tearing the group down would wait for the
        # other ranks, and the parent ends this process
        queue.put((rank, f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    queue.put((rank, out))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh(args, data: int, gauss: int) -> list:
    """Every rank's results of a (data, gauss) mesh, in rank order (ranks
    as spawned processes)."""
    world = data * gauss
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, world, data, gauss, args, init_method, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            rank, res = queue.get(timeout=RANK_TIMEOUT_S + 60)
            if isinstance(res, str):  # the first failure ends the mesh
                raise RuntimeError(f"sharded_window_bench {data}x{gauss}: {res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", nargs="*", default=["1x2", "2x1", "2x2"])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    ap.add_argument("--capacity", type=int, default=1 << 19)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--start", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("sharded_window_bench: no CUDA device (pass --device cpu to run "
                           "the ranks on the CPU)")
    n_cards = torch.cuda.device_count() if args.device == "cuda" else None
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    if args.device == "cuda":
        from omnigs_torch import cuda_build

        # once here, not in every rank
        cuda_build.build(["composite_seg_fwd", "composite_seg_bwd"])
    out, fails = [], []
    for spec in args.meshes:
        data, gauss = (int(v) for v in spec.split("x"))
        if n_cards is not None and data * gauss > n_cards:
            line = {"mesh": spec, "skipped": f"needs {data * gauss} cards, this host has {n_cards}"}
        else:
            t0 = time.perf_counter()
            ranks = run_mesh(args, data, gauss)
            line = {"mesh": spec, "device": name, "seconds": time.perf_counter() - t0,
                    "lockstep_bitwise": all(r["losses"] == ranks[0]["losses"] for r in ranks),
                    "ranks": ranks}
            for r in ranks:
                if (r["unequal"] or not r["losses_equal"] or r["counters"][0] != r["counters"][1]
                        or r["replays"] != (args.windows * args.steps
                                            if r["mode"] == "graph" else 0)
                        or r["captures"] != (1 if r["mode"] == "graph" else 0)):
                    fails.append(f"{spec} rank {r['rank']}: {r}")
            if not line["lockstep_bitwise"]:
                fails.append(f"{spec}: the ranks logged different losses")
        print(json.dumps(line), flush=True)
        out.append(line)
    if fails:
        raise RuntimeError(f"sharded_window_bench: {fails}")
    return out


if __name__ == "__main__":
    main()
