"""Result recording: cameras.json, cfg_args, keyframe-use stats, PLY saves.

Counterpart of `omnigs_tpu/train/record.py`, writing the same bytes:
`keyframes_to_json` (the 3DGS ecosystem's cameras.json),
`save_model_params` (the `cfg_args` Namespace string 3DGS tooling reads),
`write_keyframe_used_times`, and the iteration-numbered point-cloud PLY
layout.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from omnigs_torch.cameras import CameraType
from omnigs_torch.io.ply import save_gaussian_ply
from omnigs_torch.scene.scene import Scene


def keyframes_to_json(scene: Scene) -> list:
    """One entry per keyframe, in fid order: id, image name, size, the
    camera-to-world position and rotation; fx/fy for a pinhole camera, the
    camera type for a lonlat one."""
    out = []
    for idx, fid in enumerate(sorted(scene.keyframes)):
        kf = scene.keyframes[fid]
        C2W = np.linalg.inv(kf.viewmatrix)
        pos = C2W[:3, 3]
        rot = C2W[:3, :3]
        entry = {
            "id": idx,
            "img_name": kf.img_filename or f"{fid:08d}",
            "width": kf.camera.width,
            "height": kf.camera.height,
            "position": [float(x) for x in pos],
            "rotation": [[float(x) for x in row] for row in rot],
        }
        if kf.camera.camera_type == CameraType.PINHOLE:
            entry["fx"] = kf.camera.fx
            entry["fy"] = kf.camera.fy
        else:
            entry["camera_type"] = int(kf.camera.camera_type)
        out.append(entry)
    return out


def save_cameras_json(scene: Scene, result_dir: Path):
    (Path(result_dir) / "cameras.json").write_text(
        json.dumps(keyframes_to_json(scene))
    )


def save_model_params(result_dir: Path, sh_degree: int, white_background: bool,
                      source_path: str = "", model_path: str = ""):
    """`cfg_args`: the Namespace string of the 3DGS tooling."""
    ns = (
        "Namespace(eval=False, images='images', model_path='{}', "
        "resolution=-1, sh_degree={}, source_path='{}', white_background={})"
    ).format(model_path, sh_degree, source_path, white_background)
    (Path(result_dir) / "cfg_args").write_text(ns)


def write_keyframe_used_times(sampler, result_dir: Path, suffix: str = ""):
    """``keyframe_used_times<suffix>.txt``: "<fid> <count>" per keyframe."""
    path = Path(result_dir)
    path.mkdir(parents=True, exist_ok=True)
    lines = [
        f"{fid} {count}" for fid, count in sorted(sampler.used_times.items())
    ]
    (path / f"keyframe_used_times{suffix}.txt").write_text(
        "\n".join(lines) + "\n"
    )


def save_ply_checkpoint(model, result_dir: Path, iteration: int):
    """``<result>/<iteration>/ply/point_cloud.ply``."""
    d = Path(result_dir) / str(iteration) / "ply"
    d.mkdir(parents=True, exist_ok=True)
    save_gaussian_ply(d / "point_cloud.ply", model)
    return d / "point_cloud.ply"
