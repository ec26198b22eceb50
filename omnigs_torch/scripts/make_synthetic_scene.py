"""Synthesize a self-contained openMVG-format lonlat dataset.

The port's copy of `scripts/make_synthetic_scene.py`: a ground-truth
Gaussian cloud (a colored shell around the camera volume plus a floor
disk) is rendered from posed virtual cameras, and the images,
``sfm_data_{train,test}.json`` and a noisy initial point cloud are
written, so that the training and test CLIs
(`omnigs_torch/examples/`) run on it unmodified. Its randomness is numpy's
and the render draws none, so ``points.ply`` and the JSON files (but for
``root_path``) are byte-equal to the JAX script's for the same arguments.
The render runs the kernel path on a card and the dense plain compositor
(``backend="xla"``) on the CPU, as the JAX script picks by platform.

    python -m omnigs_torch.scripts.make_synthetic_scene OUT_DIR [--width 512]
        [--height 256] [--gaussians 4096] [--train-views 12]
        [--test-views 4] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.io.ply import save_points_ply
from omnigs_torch.model.gaussians import GaussianModel, inverse_sigmoid
from omnigs_torch.ops import sh as sh_ops
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.scene.keyframe import pose_from_center
from omnigs_torch.train.eval import save_image
from omnigs_torch.train.renderer import render_model

PTR_WRAPPER_ID = 2147483649
POLYMORPHIC_ID = 1073741824


def _sfm_json(views, width, height, root_path):
    json_views, json_extrs = [], []
    for i, (R_cw, center, fname) in enumerate(views):
        json_views.append(
            {
                "key": i,
                "value": {
                    "polymorphic_id": POLYMORPHIC_ID,
                    "ptr_wrapper": {
                        "id": PTR_WRAPPER_ID + i,
                        "data": {
                            "local_path": "",
                            "filename": fname,
                            "width": width,
                            "height": height,
                            "id_view": i,
                            "id_intrinsic": 0,
                            "id_pose": i,
                        },
                    },
                },
            }
        )
        json_extrs.append(
            {
                "key": i,
                "value": {"rotation": R_cw.tolist(), "center": center.tolist()},
            }
        )
    intr = [
        {
            "key": 0,
            "value": {
                "polymorphic_id": POLYMORPHIC_ID,
                "polymorphic_name": "spherical",
                "ptr_wrapper": {
                    "id": PTR_WRAPPER_ID,
                    "data": {"value0": {"width": width, "height": height}},
                },
            },
        }
    ]
    return {
        "sfm_data_version": "0.3",
        "root_path": str(root_path),
        "views": json_views,
        "intrinsics": intr,
        "extrinsics": json_extrs,
        "structure": [],
        "control_points": [],
    }


def _yaw_matrix(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def synthesize(out_dir, width=512, height=256, gaussians=4096, train_views=12,
               test_views=4, seed=0, device="cuda") -> Dict[str, np.ndarray]:
    """Write the dataset into ``out_dir``; returns each view's float
    render, (3, H, W) before quantization, by file name."""
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = gaussians

    # ground-truth cloud: a colored shell (radius 2-6) around the camera
    # volume plus a floor disk, so the background never dominates the loss
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    r = 2.0 + 4.0 * rng.random((n, 1))
    xyz = d * r
    floor = rng.random(n) < 0.25
    xyz[floor, 1] = -1.5
    colors = 0.15 + 0.7 * rng.random((n, 3))

    gt = GaussianModel.empty(n, device=device)
    with torch.no_grad():
        gt.xyz.copy_(torch.as_tensor(xyz, dtype=torch.float32))
        gt.features_dc.copy_(
            sh_ops.rgb2sh(torch.as_tensor(colors, dtype=torch.float32))[:, None, :]
        )
        gt.scaling.fill_(float(np.float32(np.log(0.12))))
        gt.rotation.copy_(torch.tensor([1.0, 0, 0, 0]).expand(n, 4))
        gt.opacity.fill_(float(inverse_sigmoid(torch.tensor(0.8))))
    gt.active.fill_(True)

    camera = Camera(CameraType.LONLAT, width, height)
    backend = "pallas" if torch.device(device).type == "cuda" else "xla"
    cfg = RasterConfig(
        max_instances=1 << 20,
        backend=backend,
        tile_cap=2048,
        tight_culling=True,
        tile_culling=backend == "pallas",
    )
    bg = torch.zeros(3, device=device)
    renders: Dict[str, np.ndarray] = {}

    def make_views(count, tag):
        views = []
        for i in range(count):
            center = np.array(
                [rng.uniform(-1, 1), rng.uniform(-0.5, 0.5), rng.uniform(-1, 1)]
            )
            R_wc = _yaw_matrix(rng.uniform(0, 2 * np.pi))
            R_cw_in = R_wc.T  # openMVG stores R_cw with the camera center
            R_cw, t_cw = pose_from_center(
                R_cw_in.astype(np.float32), center.astype(np.float32)
            )
            vm = np.eye(4, dtype=np.float32)
            vm[:3, :3] = R_cw
            vm[:3, 3] = t_cw
            with torch.no_grad():
                img = render_model(
                    gt, camera, torch.as_tensor(vm, device=device),
                    torch.as_tensor(center, dtype=torch.float32, device=device),
                    bg, sh_degree=0, config=cfg,
                ).image.cpu().numpy()
            fname = f"{tag}_{i:03d}.png"
            save_image(out / "images" / fname, img)
            renders[fname] = img
            views.append((R_cw_in, center, fname))
        return views

    train = make_views(train_views, "train")
    test = make_views(test_views, "test")
    for tag, views in (("train", train), ("test", test)):
        (out / f"sfm_data_{tag}.json").write_text(
            json.dumps(_sfm_json(views, width, height, out / "images"), indent=1)
        )

    # noisy initial cloud: GT positions + 2% jitter, half the points
    keep = rng.random(n) < 0.5
    pts = xyz[keep] + rng.normal(scale=0.08, size=(keep.sum(), 3))
    save_points_ply(
        out / "points.ply",
        np.asarray(pts, np.float32),
        np.asarray(colors[keep], np.float32),
    )
    print(
        f"wrote {train_views} train + {test_views} test views, "
        f"{int(keep.sum())} seed points -> {out}"
    )
    return renders


def main(argv=None) -> Dict[str, np.ndarray]:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--gaussians", type=int, default=4096)
    ap.add_argument("--train-views", type=int, default=12)
    ap.add_argument("--test-views", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return synthesize(args.out_dir, args.width, args.height, args.gaussians,
                      args.train_views, args.test_views, args.seed, args.device)


if __name__ == "__main__":
    main()
