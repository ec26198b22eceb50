"""Weak-scaling harness: pixels/s of the sharded training step over
(data × gauss) meshes.

The port's copy of `scripts/scaling_bench.py`: the same arguments and the
same production config (the segmented kernels, packed binning, the
retuned caps), on the model of `kernel_ablate.example_model` (P Gaussians,
all active). First the unsharded `train_step` on one device, then
`parallel/shard.sharded_train_step` per mesh at the same config and loss,
so the 1x1 mesh's ratio to the unsharded step is the shard tax (what the
mesh plumbing costs with nothing to share). A mesh of N ranks takes N
processes, each owning one card under NCCL; a mesh that needs more cards
than the host has is reported and skipped. ``--device cpu`` runs the ranks
as CPU processes under gloo (small sizes; its times are not device
numbers). The backend follows from ``--device``: NCCL for cards, gloo for
the CPU.

    python -m omnigs_torch.scripts.scaling_bench [--width 1920 --height 960]
        [--gaussians 131072] [--meshes 1x1 1x2 2x2 ...] [--iters 10]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model import optimizer as opt_ops
from omnigs_torch.model.gaussians import FIELD_NAMES, GaussianModel
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.scripts.kernel_ablate import example_model

# the production config on both sides, so the 1x1 mesh measures the
# sharding alone
PROD_CFG = RasterConfig(
    max_instances=18 << 16, backend="pallas", tight_culling=True, tile_culling=True,
    aligned_cap=8288 * 128, want_ncontrib=False, gather_reduce=True, depth_presort=True,
    segmented=True,
)


def _per_step_s(step, iters: int, device) -> float:
    """Seconds per call of ``step(i)`` over ``iters`` calls after one
    warm-up call, ending in a synchronise on a card."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step(1)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        step(i + 2)
    sync()
    return (time.perf_counter() - t0) / iters


def _views(args, n, device):
    vms = torch.eye(4, device=device).expand(n, 4, 4).contiguous()
    return vms, torch.zeros(n, 3, device=device), torch.zeros(
        n, 3, args.height, args.width, device=device
    )


def unsharded_s(args, device) -> float:
    from omnigs_torch.train.trainer import train_step

    model = example_model(args.gaussians, device)
    state = opt_ops.init_adam(model.params())
    vms, cps, gts = _views(args, 1, device)
    camera = Camera(CameraType.LONLAT, args.width, args.height)
    return _per_step_s(
        lambda i: train_step(
            model, state, vms[0], cps[0], gts[0], i, camera=camera, sh_degree=3,
            raster_cfg=PROD_CFG, lr_cfg=opt_ops.LRConfig(), spatial_lr_scale=1.0,
            bg=torch.zeros(3, device=device),
        ),
        args.iters, device,
    )


def _backend(device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _sharded_rank(rank, world, data, gauss, args, init_method, queue=None):
    """One rank of a mesh: its shard of the model, the same view on every
    data row → seconds per step (on every rank)."""
    from omnigs_torch.parallel.distributed import initialize
    from omnigs_torch.parallel.mesh import GAUSS_AXIS, axis_index, make_mesh
    from omnigs_torch.parallel.shard import sharded_train_step

    device = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(_backend(device), init_method=init_method, rank=rank, world_size=world)
    try:
        mesh = make_mesh(data, gauss, device_type=device.type)
        full = example_model(args.gaussians, device)
        n = args.gaussians // gauss
        lo = axis_index(mesh, GAUSS_AXIS) * n
        model = GaussianModel(
            {k: getattr(full, k).detach()[lo : lo + n].clone() for k in FIELD_NAMES}
        )
        del full
        state = opt_ops.init_adam(model.params())
        vms, cps, gts = _views(args, 1, device)
        camera = Camera(CameraType.LONLAT, args.width, args.height)
        secs = _per_step_s(
            lambda i: sharded_train_step(
                mesh, model, state, vms, cps, gts, i, camera=camera, sh_degree=3,
                raster_cfg=PROD_CFG, lr_cfg=opt_ops.LRConfig(), spatial_lr_scale=1.0,
                bg=torch.zeros(3, device=device),
            ),
            args.iters, device,
        )
    finally:
        dist.destroy_process_group()
    if queue is not None:
        queue.put((rank, secs))
    return secs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_s(args, data: int, gauss: int) -> float:
    """Seconds per sharded step on a (data, gauss) mesh: one rank in this
    process, more as spawned processes (rank 0's time)."""
    world = data * gauss
    init_method = f"tcp://localhost:{_free_port()}"
    if world == 1:
        return _sharded_rank(0, 1, data, gauss, args, init_method)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [
        ctx.Process(target=_sharded_rank,
                    args=(r, world, data, gauss, args, init_method, queue))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    try:
        secs = dict(queue.get(timeout=1800) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return secs[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    ap.add_argument("--meshes", nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scaling_bench: no CUDA device (pass --device cpu to run "
                           "the ranks on the CPU)")
    n_cards = torch.cuda.device_count() if device.type == "cuda" else None
    meshes = args.meshes or [f"1x{n}" for n in (1, 2, 4, 8) if n <= (n_cards or 1)]
    pixels = args.width * args.height
    out = []

    def report(line):
        print(json.dumps(line), flush=True)
        out.append(line)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    base_s = unsharded_s(args, device)
    report({"mesh": "unsharded", "ms_per_step": base_s * 1e3,
            "pixels_per_s": pixels / base_s, "device": name})
    per_rank = None
    for spec in meshes:
        data, gauss = (int(v) for v in spec.split("x"))
        if args.gaussians % gauss:
            raise ValueError(f"{args.gaussians} Gaussians do not split over {gauss} ranks")
        if n_cards is not None and data * gauss > n_cards:
            report({"mesh": spec, "skipped": f"needs {data * gauss} cards, this host has {n_cards}"})
            continue
        secs = sharded_s(args, data, gauss)
        px_s = pixels * data / secs
        if per_rank is None:
            per_rank = px_s / (data * gauss)
        line = {"mesh": spec, "ms_per_step": secs * 1e3, "pixels_per_s": px_s,
                "scaling_efficiency": px_s / (per_rank * data * gauss),
                "backend": _backend(device)}
        if data * gauss == 1:
            line["shard_tax"] = secs / base_s
        report(line)
    return out


if __name__ == "__main__":
    main()
