"""The converged-scene leg of the benchmark, standalone: the full
differentiable render (L1 loss → every parameter's gradient) of a trained
model, timed on one card.

The port's copy of `scripts/converged_bench.py` (the second workload of
`bench.py`): a PLY loaded at capacity 2^19, rendered at lonlat 1920×960
from the first train view of an openMVG scene through the production
layout (packed binning, the segmented kernels #1 / #2, tight and tile
culling, 2^22 instance slots, a 40·2^16-lane slab; ``gather_reduce`` asks
for the gather reduction, which the segmented route switches off, as in
the JAX package), 10 steps after 2. It prints one JSON line: pixels/s, ms
a step (host clock around the 10 steps, which end in a synchronise), the
composited instances per tile (the compact binning at 2^22 slots of the
same pose, as the JAX script counts them), the PLY and the device.

    python -m omnigs_torch.scripts.converged_bench [PLY] [SCENE_JSON] [--device cpu]

PLY and SCENE_JSON default to the protocol run's outputs under
``results_local/`` (the 32,010-iteration checkpoint of
`scripts/protocol_run.sh`); `run` takes smaller sizes for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.io.openmvg import load_openmvg_scene
from omnigs_torch.io.ply import load_gaussian_ply
from omnigs_torch.ops import loss as loss_ops
from omnigs_torch.ops.binning import bin_instances
from omnigs_torch.ops.preprocess import preprocess, tile_grid
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.train.renderer import render_model

_REPO = Path(__file__).resolve().parents[2]
DEFAULT_PLY = _REPO / "results_local" / "proto_out" / "32010" / "ply" / "point_cloud.ply"
DEFAULT_SCENE = _REPO / "results_local" / "scene_fullres" / "sfm_data_train.json"
SH_DEGREE = 3
# the JAX script's sizes: model capacity, instance slots, slab lanes
CAPACITY, MAX_INSTANCES, ALIGNED_CAP = 1 << 19, 1 << 22, 40 << 16


def composited_per_tile(model, camera, vm, cp, max_instances) -> float:
    """Mean composited instances per tile: the compact binning with tile
    culling of the pose's preprocess (the JAX script's expressions)."""
    gx, gy = tile_grid(camera)
    with torch.no_grad():
        prep = preprocess(
            model.xyz, torch.exp(model.scaling),
            model.rotation / torch.linalg.vector_norm(model.rotation, dim=-1, keepdim=True),
            torch.sigmoid(model.opacity[:, 0]),
            torch.cat([model.features_dc, model.features_rest], dim=1),
            camera, vm, cp, SH_DEGREE, tight_culling=True, active_mask=model.active,
        )
        inst = bin_instances(prep, gx, gy, max_instances, tile_cull=True)
        return int(torch.sum(inst.counts)) / (gx * gy)


def bench_config(max_instances: int, aligned_cap: int) -> RasterConfig:
    """`bench.py`'s committed RasterConfig at ``max_instances`` slots and
    an ``aligned_cap``-lane slab: packed binning, the segmented kernels,
    tight and tile culling (``gather_reduce`` asked for, which the
    segmented route switches off)."""
    return RasterConfig(
        max_instances=max_instances, backend="pallas", tight_culling=True,
        tile_culling=True, aligned_cap=aligned_cap, want_ncontrib=False,
        gather_reduce=True, depth_presort=True, segmented=True,
    )


def grad_step(model, camera, vm, cp, cfg):
    """One step: the render of the pose over a black background, its L1
    loss against zeros, every parameter's gradient → (the gradients by
    parameter name, the instances the render dropped)."""
    dev = model.xyz.device
    bg = torch.zeros(3, device=dev)
    gt = torch.zeros(3, camera.height, camera.width, device=dev)
    params = model.params()
    res = render_model(model, camera, vm, cp, bg, SH_DEGREE, cfg)
    grads = torch.autograd.grad(loss_ops.l1_loss(res.image, gt), list(params.values()))
    return dict(zip(params, grads)), res.truncated


def time_grad_steps(model, camera, vm, cp, cfg, iters=10, warmup=2):
    """Seconds a step of ``iters`` `grad_step`s after ``warmup`` (host
    clock, ending in a synchronise on a card) → (seconds, instances the
    last step's render dropped, the last step's gradients)."""
    dev = model.xyz.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        grad_step(model, camera, vm, cp, cfg)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        grads, truncated = grad_step(model, camera, vm, cp, cfg)
    sync()
    return (time.perf_counter() - t0) / iters, int(truncated), grads


def load_view(ply, scene_json, device, width=1920, height=960, capacity=CAPACITY):
    """The PLY's model at ``capacity`` and the scene's first train view →
    (model, camera, view matrix, camera position)."""
    dev = torch.device(device)
    camera = Camera(CameraType.LONLAT, width, height)
    model = load_gaussian_ply(ply, capacity=capacity, device=dev)
    scene = load_openmvg_scene(scene_json, None, image_root=None)
    kf = scene.keyframes[sorted(scene.keyframes)[0]]
    vm = torch.as_tensor(kf.viewmatrix, dtype=torch.float32, device=dev)
    cp = torch.as_tensor(kf.campos, dtype=torch.float32, device=dev)
    return model, camera, vm, cp


def run(ply, scene_json, device, width=1920, height=960, capacity=CAPACITY,
        max_instances=MAX_INSTANCES, aligned_cap=ALIGNED_CAP, iters=10, warmup=2) -> dict:
    """Time ``iters`` gradient steps after ``warmup`` → the JSON line's
    values, unrounded, the instances the last step's render dropped
    (``truncated``) and its gradients (``grads``)."""
    dev = torch.device(device)
    model, camera, vm, cp = load_view(ply, scene_json, dev, width, height, capacity)
    cfg = bench_config(max_instances, aligned_cap)  # the JAX script's config
    dt, truncated, grads = time_grad_steps(model, camera, vm, cp, cfg, iters, warmup)
    return {
        "truncated": truncated,
        "px_s": width * height / dt,
        "ms_per_step": dt * 1e3,
        "instances_per_tile": composited_per_tile(model, camera, vm, cp, max_instances),
        "ply": str(ply),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "grads": grads,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ply", nargs="?", default=str(DEFAULT_PLY))
    ap.add_argument("scene_json", nargs="?", default=str(DEFAULT_SCENE))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.ply, args.scene_json, args.device)
    print(json.dumps({
        "metric": "converged_scene_px_s",
        "value": round(out["px_s"], 1),
        "unit": "pixels/s",
        "ms_per_step": round(out["ms_per_step"], 2),
        "instances_per_tile": round(out["instances_per_tile"], 1),
        "ply": out["ply"],
        "device": out["device"],
    }), flush=True)
    return out


if __name__ == "__main__":
    main()
