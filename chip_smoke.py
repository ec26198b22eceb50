#!/usr/bin/env python3
"""Drive the PyTorch port's render path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check raises, so the
script exits non-zero:

1. device — the card's name and power limit (nvidia-smi) and PyTorch's view.
2. build  — every CUDA kernel of the path, built from the repository's
   sources (`omnigs_torch/cuda_build.py`), with nvcc's register and
   shared-memory report.
3. kernel — at full width (1920×960 lonlat, P = 131,072 at SH degree 3):
   the instance slab of one pose through the port's preprocess, binning
   and re-lay; the CUDA kernel against its plain PyTorch version on it
   (max |Δ| ≤ 1e-4, 99.9th percentile ≤ 1e-5 over image and final_T); both
   timed with CUDA events; the work this slab needs, for the bound. Then
   the device time of each stage of that render (CUDA events).
4. render — four serving requests through `render_model` with the
   production config of cfg/lonlat/360roam_lonlat.yaml under
   `torch.inference_mode()`, with the launch counters set to 0 just before
   and read just after: every kernel of the path must have launched, no
   instance may be truncated, every image must be finite.
5. ply    — save → load → render one pose again: bit-identical image.

Then the `kernels` line, nvidia-smi's line, and last the result line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT = 1920, 960
P = 1 << 17
SH_DEGREE = 3
SEED = 0
N_REQUESTS = 4
CONFIG = REPO / "cfg" / "lonlat" / "360roam_lonlat.yaml"
# H100 SXM published peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per pixel-instance pair in the kernel: every visited
# pair (dx, dy, quadratic form, clamp, exp, opacity, clamp, two tests) and
# every live pair on top (log1p, exp of the log-T, test, weight, 3 color
# multiply-adds, 2 log sums); a transcendental counts as one operation
OPS_PER_VISITED_PAIR = 17
OPS_PER_LIVE_PAIR = 13
MAX_ERR_BAR = 1e-4
P999_ERR_BAR = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_model(np, device):
    """P Gaussians around the origin, all active, from a fixed seed: the
    distribution of the JAX package's bench model (unit directions at radius
    1–5, log-scales N(−3.5, 0.3), opacity logits N(0, 1), dc N(0, 0.5)),
    plus small degree-1..3 coefficients so SH degree 3 does real work."""
    from omnigs_torch.model.gaussians import GaussianModel

    rng = np.random.default_rng(SEED)
    d = rng.normal(size=(P, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    fields = dict(
        xyz=d * (1.0 + rng.uniform(size=(P, 1)) * 4.0),
        features_dc=rng.normal(size=(P, 1, 3)) * 0.5,
        features_rest=rng.normal(size=(P, 15, 3)) * 0.05,
        scaling=rng.normal(size=(P, 3)) * 0.3 - 3.5,
        rotation=rng.normal(size=(P, 4)),
        opacity=rng.normal(size=(P, 1)),
        max_radii2d=np.zeros(P),
        xyz_gradient_accum=np.zeros(P),
        denom=np.zeros(P),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields["active"] = np.ones(P, bool)
    fields["exist_since_iter"] = np.zeros(P, np.int32)
    return GaussianModel.from_numpy(fields, device=device)


def poses(torch, device):
    """Request k looks along yaw k·90° with a small pitch and offset."""
    out = []
    for k in range(N_REQUESTS):
        yaw, pitch = k * math.pi / 2, 0.1 * (k - 1.5)
        cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
        ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = torch.tensor([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        rot = (rx @ ry).to(torch.float32)
        campos = torch.tensor([0.05 * k, -0.03 * k, 0.02 * k])
        vm = torch.eye(4)
        vm[:3, :3] = rot
        vm[:3, 3] = -rot @ campos
        out.append((vm.to(device), campos.to(device)))
    return out


def slab_for(model, camera, vm, campos, cfg, mark=None):
    """The compositor's inputs for one pose, through the port's own chain
    (preprocess → bin_instances_packed → segment_relay → _build_inst_seg);
    ``mark(stage)`` is called after each stage."""
    import torch

    from omnigs_torch.ops.binning import bin_instances_packed, segment_relay
    from omnigs_torch.ops.composite_seg import CHUNK, _build_inst_seg
    from omnigs_torch.ops.preprocess import preprocess, tile_grid

    mark = mark or (lambda stage: None)
    gx, gy = tile_grid(camera)
    prep = preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(),
        model.get_opacity(), model.get_features(), camera, vm, campos,
        SH_DEGREE, active_mask=model.active, tight_culling=cfg.tight_culling,
    )
    mark("preprocess")
    inst = bin_instances_packed(
        prep, gx, gy, cfg.max_instances, tile_cull=cfg.tile_culling
    )
    mark("bin_instances_packed")
    r8 = cfg.aligned_cap or -(-cfg.max_instances // CHUNK) * CHUNK
    seg = segment_relay(
        inst.sorted_g, inst.starts, inst.counts, r8, P, inst.sorted_key
    )
    mark("segment_relay")
    slab = _build_inst_seg(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, seg.sorted_g8,
        inst.perm, seg.ride_d, seg.ride_t,
    )
    mark("_build_inst_seg")
    torch.cuda.synchronize()
    return slab, seg, inst, gx, gx * gy


def stage_phase(torch, model, camera, pose, cfg, reps=3):
    """Device time of each stage of one render (CUDA events between the
    stages, launch gaps included), averaged over ``reps`` after a warm-up."""
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops.rasterize import _tiles_to_image

    vm, campos = pose
    bg = torch.zeros(3, device=vm.device)
    totals = {}
    for rep in range(reps + 1):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        with torch.inference_mode():
            slab, seg, _, gx, num_tiles = slab_for(
                model, camera, vm, campos, cfg, mark
            )
            mark("sync")
            color, final_t = cs.composite_seg_fwd(
                slab, seg.starts8, seg.counts, seg.live8, num_tiles, gx
            )
            mark("composite_seg_fwd")
            color = color + final_t[:, None, :] * bg[None, :, None]
            _tiles_to_image(color, gx, num_tiles // gx, WIDTH, HEIGHT)
            _tiles_to_image(final_t, gx, num_tiles // gx, WIDTH, HEIGHT)
            mark("blend+_tiles_to_image")
        torch.cuda.synchronize()
        if rep == 0:
            continue
        for (_, a), (stage, b) in zip(events, events[1:]):
            if stage != "sync":
                totals[stage] = totals.get(stage, 0.0) + a.elapsed_time(b) / reps
    emit({"phase": "stages", "pose": 0, "stage_ms": totals,
          "sum_ms": sum(totals.values())})
    return totals


def time_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, model, camera, pose, cfg):
    from omnigs_torch.ops import composite_seg as cs

    vm, campos = pose
    with torch.inference_mode():
        slab, seg, inst, gx, num_tiles = slab_for(model, camera, vm, campos, cfg)
        args = (slab, seg.starts8, seg.counts, seg.live8, num_tiles, gx)
        kc, kt = cs.composite_seg_fwd(*args)
        torch.cuda.synchronize()
        pc, pt, n_used, n_live = cs.composite_seg_fwd_plain(
            slab, seg.starts8, seg.counts, num_tiles, gx
        )
        diff = torch.cat([(kc - pc).abs().flatten(), (kt - pt).abs().flatten()])
        max_err = float(diff.max())
        p999 = float(torch.sort(diff).values[int(0.999 * (diff.numel() - 1))])
        finite = bool(torch.isfinite(kc).all() and torch.isfinite(kt).all())
        kernel_ms = time_ms(torch, lambda: cs.composite_seg_fwd(*args), reps=20)
        plain_ms = time_ms(
            torch,
            lambda: cs.composite_seg_fwd_plain(
                slab, seg.starts8, seg.counts, num_tiles, gx
            ),
            reps=3, warmup=1,
        )
    visited = int(n_used.to(torch.int64).sum())
    live = int(n_live.to(torch.int64).sum())
    instances = int(seg.counts.to(torch.int64).sum())
    ops = visited * OPS_PER_VISITED_PAIR + live * OPS_PER_LIVE_PAIR
    nbytes = 9 * 4 * instances + 2 * 4 * num_tiles + 4 * 4 * 256 * num_tiles
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    result = {
        "phase": "kernel",
        "name": "composite_seg_fwd",
        "tiles": num_tiles,
        "emitted_instances": int(inst.num_instances),
        "segment_instances": instances,
        "live8": int(seg.live8),
        "visited_pairs": visited,
        "live_pairs": live,
        "ops": ops,
        "bytes": nbytes,
        "max_abs_err": max_err,
        "p999_abs_err": p999,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    emit(result)
    if not finite:
        raise RuntimeError("kernel output is not finite")
    if max_err > MAX_ERR_BAR or p999 > P999_ERR_BAR:
        raise RuntimeError(
            f"kernel disagrees with its plain version: max {max_err:.3g} "
            f"(bar {MAX_ERR_BAR}), p99.9 {p999:.3g} (bar {P999_ERR_BAR})"
        )
    return result


def render_phase(torch, model, camera, pose_list, cfg):
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.train.renderer import render_model

    bg = torch.zeros(3, device=model.xyz.device)
    # the layout counts of each request, computed outside the timed region
    layout = []
    with torch.inference_mode():
        for vm, campos in pose_list:
            _, seg, inst, _, _ = slab_for(model, camera, vm, campos, cfg)
            layout.append((int(inst.num_instances), int(seg.live8)))
    images = []
    torch.cuda.reset_peak_memory_stats()
    cs.composite_seg_fwd.launches = 0
    for k, (vm, campos) in enumerate(pose_list):
        before = cs.composite_seg_fwd.launches
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = render_model(model, camera, vm, campos, bg, SH_DEGREE, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        img = res.image
        emit({
            "phase": "render",
            "request": k,
            "host_ms": host_ms,
            "emitted_instances": layout[k][0],
            "live8": layout[k][1],
            "truncated": int(res.truncated),
            "kernel_launches": cs.composite_seg_fwd.launches - before,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "image_min": float(img.min()),
            "image_mean": float(img.mean()),
            "image_max": float(img.max()),
        })
        if int(res.truncated) != 0:
            raise RuntimeError(f"request {k}: {int(res.truncated)} instances truncated")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"request {k}: image is not finite")
        if tuple(img.shape) != (3, HEIGHT, WIDTH):
            raise RuntimeError(f"request {k}: image shape {tuple(img.shape)}")
        images.append(img)
    launches = cs.composite_seg_fwd.launches
    if launches != len(pose_list):
        raise RuntimeError(
            f"composite_seg_fwd launched {launches} times in {len(pose_list)} requests"
        )
    return images, launches


def ply_phase(torch, model, camera, pose, cfg, image0):
    from omnigs_torch.io.ply import load_gaussian_ply, save_gaussian_ply
    from omnigs_torch.train.renderer import render_model

    path = REPO / "build" / "omnigs_torch" / "chip_smoke.ply"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        save_gaussian_ply(path, model)
        loaded = load_gaussian_ply(path, device=model.xyz.device)
    finally:
        path.unlink(missing_ok=True)
    vm, campos = pose
    with torch.inference_mode():
        res = render_model(
            loaded, camera, vm, campos, torch.zeros(3, device=vm.device), SH_DEGREE, cfg
        )
    torch.cuda.synchronize()
    identical = bool(torch.equal(res.image, image0))
    emit({"phase": "ply", "gaussians": loaded.capacity, "bit_identical": identical})
    if not identical:
        diff = float((res.image - image0).abs().max())
        raise RuntimeError(f"PLY round trip changed the render (max |Δ| {diff})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "omnigs_torch").is_dir():
        print("chip_smoke: the omnigs_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np

    from omnigs_torch import cuda_build
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.config import load_config, raster_config_from

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({
        "phase": "device",
        "nvidia_smi": smi,
        "name": name,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })

    kernels = ["composite_seg_fwd"]
    t0 = time.perf_counter()
    cuda_build.build(kernels)
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "report": {k: cuda_build.BUILD_REPORT.get(k, "cached") for k in kernels},
    })

    cfg = raster_config_from(load_config(CONFIG))
    camera = Camera(CameraType.LONLAT, WIDTH, HEIGHT)
    model = synthetic_model(np, "cuda")
    pose_list = poses(torch, "cuda")

    kres = kernel_phase(torch, model, camera, pose_list[0], cfg)
    stage_phase(torch, model, camera, pose_list[0], cfg)
    images, launches = render_phase(torch, model, camera, pose_list, cfg)
    ply_phase(torch, model, camera, pose_list[0], cfg, images[0])

    emit({"kernels": [{
        "name": "composite_seg_fwd",
        "route": "cuda",
        "source": "omnigs_torch/csrc/composite_seg_fwd.cu",
        "replaces": "omnigs_tpu/ops/pallas_seg.py:237",
        "tpu_kernel": "omnigs_tpu/ops/pallas_seg.py::_fwd_seg_kernel",
        "launches": launches,
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["kernel_ms"],
        "kernel_ms": kres["kernel_ms"],
        "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"],
        "bound_by": kres["bound_by"],
        # no single PyTorch call composites depth-sorted splats per tile
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
