"""openMVG sfm_data loaders for 360Roam / EgoNeRF-style datasets.

Counterpart of `omnigs_tpu/io/openmvg.py`: an openMVG `sfm_data.json`
holds spherical ("lonlat") intrinsics, views (filename + pose/intrinsic
ids) and extrinsics (R_cw + camera center); the sparse cloud is a PLY with
float (360Roam) or double (EgoNeRF) xyz. Images load through
`io/native_loader.load_image` at the camera's size. Pinhole intrinsics
(and with them undistortion) are not ported yet: they raise, as the
pinhole camera does (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.io.native_loader import load_image
from omnigs_torch.io.ply import load_points_ply
from omnigs_torch.scene.keyframe import Keyframe, pose_from_center
from omnigs_torch.scene.scene import Scene


def load_openmvg_scene(
    sfm_json: Union[str, Path],
    points_ply: Optional[Union[str, Path]] = None,
    image_root: Optional[Union[str, Path]] = None,
    load_images: bool = True,
    znear: float = 0.01,
    zfar: float = 100.0,
    resolution_scale: float = 1.0,
    image_filter=None,
) -> Scene:
    """Build a Scene from openMVG json (+ optional sparse cloud PLY).

    ``image_filter(fid) -> bool`` restricts which keyframes load their
    ground-truth image (poses always load).
    """
    root = json.loads(Path(sfm_json).read_text())
    scene = Scene()

    for intr in root.get("intrinsics", []):
        cam_id = int(intr["key"])
        name = intr["value"].get("polymorphic_name", "spherical")
        if "pinhole" in name:
            raise NotImplementedError(
                f"openMVG intrinsic {name!r}: pinhole cameras and undistortion "
                "are not ported to omnigs_torch yet (ROADMAP queue 1 item 7)"
            )
        data = intr["value"]["ptr_wrapper"]["data"]
        v0 = data.get("value0", data)
        w, h = int(v0["width"]), int(v0["height"])
        if resolution_scale != 1.0:
            w = int(round(w * resolution_scale))
            h = int(round(h * resolution_scale))
        scene.cameras[cam_id] = Camera(CameraType.LONLAT, w, h)

    extr = {int(e["key"]): e["value"] for e in root.get("extrinsics", [])}
    img_dir = Path(image_root) if image_root else Path(root.get("root_path", "."))

    for view in root.get("views", []):
        fid = int(view["key"])
        data = view["value"]["ptr_wrapper"]["data"]
        pose_id = int(data["id_pose"])
        if pose_id not in extr:
            continue
        e = extr[pose_id]
        R_cw, t_cw = pose_from_center(
            np.asarray(e["rotation"], dtype=np.float32),
            np.asarray(e["center"], dtype=np.float32),
        )
        cam = scene.cameras[int(data["id_intrinsic"])]
        fname = data["filename"]
        image = None
        if load_images and (image_filter is None or image_filter(fid)):
            image = load_image(img_dir / fname, cam.width, cam.height)
        scene.add_keyframe(
            Keyframe(fid=fid, camera=cam, R_cw=R_cw, t_cw=t_cw, image=image,
                     img_filename=fname, znear=znear, zfar=zfar)
        )

    if points_ply is not None:
        scene.points, scene.colors = load_points_ply(points_ply)
    return scene
