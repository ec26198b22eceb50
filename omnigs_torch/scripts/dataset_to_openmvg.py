"""Dataset → openMVG sfm_data converter (360Roam / EgoNeRF pose_c2w.json).

The port's copy of `scripts/dataset_to_openmvg.py`: reads each scene's
`pose_c2w.json` split and writes the spherical-intrinsics openMVG JSON the
training CLI reads (`openMVG/data_openmvg.json`, or
`data_openmvg_<split>.json`). openMVG's triangulation is not available,
so ``--make-points N`` writes `openMVG/scene_init.ply`, N points uniform
in a ball around the camera centres (numpy, seed 0), through the port's
`save_points_ply`. The JSONs and the PLY are byte-equal to the JAX
script's.

    python -m omnigs_torch.scripts.dataset_to_openmvg --dataset-dir D \\
        --scene-list L --img-width W --img-height H [--split train|test] \\
        [--make-points N]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from omnigs_torch.io.ply import save_points_ply

PTR_WRAPPER_ID = 2147483649
POLYMORPHIC_ID = 1073741824


def convert_scene(scene_dir: Path, img_width: int, img_height: int,
                  split: str = "train", make_points: int = 0) -> Path:
    """One scene's split → its openMVG JSON (returned), and with
    ``make_points`` on the train split the initial cloud."""
    with open(scene_dir / "pose_c2w.json") as f:
        frames = json.load(f)[split]

    views, extrinsics, centers = [], [], []
    for idx, frame in enumerate(frames):
        views.append({
            "key": idx,
            "value": {
                "polymorphic_id": POLYMORPHIC_ID,
                "ptr_wrapper": {
                    "id": PTR_WRAPPER_ID + idx,
                    "data": {
                        "local_path": "",
                        "filename": frame["rgb_file"],
                        "width": img_width,
                        "height": img_height,
                        "id_view": idx,
                        "id_intrinsic": 0,
                        "id_pose": idx,
                    },
                },
            },
        })
        Twc = np.array(frame["transform_matrix"])
        Rwc, twc = Twc[:3, :3], Twc[:3, 3]
        centers.append(twc)
        extrinsics.append({
            "key": idx,
            "value": {"rotation": np.linalg.inv(Rwc).tolist(), "center": twc.tolist()},
        })
    intrinsics = [{
        "key": 0,
        "value": {
            "polymorphic_id": PTR_WRAPPER_ID,
            "polymorphic_name": "spherical",
            "ptr_wrapper": {
                "id": PTR_WRAPPER_ID + len(frames),
                "data": {"value0": {"width": img_width, "height": img_height}},
            },
        },
    }]

    out_dir = scene_dir / "openMVG"
    out_dir.mkdir(exist_ok=True)
    name = "data_openmvg.json" if split == "train" else f"data_openmvg_{split}.json"
    with open(out_dir / name, "w") as f:
        json.dump({
            "sfm_data_version": "0.3",
            "root_path": str(scene_dir / "images"),
            "views": views,
            "intrinsics": intrinsics,
            "extrinsics": extrinsics,
            "structure": [],
            "control_points": [],
        }, f)

    if make_points and split == "train":
        centers = np.stack(centers)
        avg = centers.mean(0)
        radius = float(np.linalg.norm(centers - avg, axis=-1).max()) * 3.0 + 1.0
        rng = np.random.default_rng(0)
        d = rng.normal(size=(make_points, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        r = radius * np.cbrt(rng.random((make_points, 1)))
        pts = (avg + d * r).astype(np.float32)
        save_points_ply(out_dir / "scene_init.ply", pts, np.full((make_points, 3), 0.5, np.float32))
    return out_dir / name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--scene-list", required=True)
    ap.add_argument("--img-width", type=int, required=True)
    ap.add_argument("--img-height", type=int, required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--make-points", type=int, default=0)
    args = ap.parse_args(argv)
    with open(args.scene_list) as f:
        scenes = [line.strip() for line in f if line.strip()]
    for scene in scenes:
        out = convert_scene(Path(args.dataset_dir) / scene, args.img_width, args.img_height,
                            args.split, args.make_points)
        print(f"{scene}: {out}")


if __name__ == "__main__":
    main()
