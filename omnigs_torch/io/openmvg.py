"""openMVG sfm_data loaders for 360Roam / EgoNeRF-style datasets.

Counterpart of `omnigs_tpu/io/openmvg.py`: an openMVG `sfm_data.json`
holds spherical ("lonlat") intrinsics, views (filename + pose/intrinsic
ids) and extrinsics (R_cw + camera center); the sparse cloud is a PLY with
float (360Roam) or double (EgoNeRF) xyz. Images load through
`io/native_loader.load_image` at the camera's size. Pinhole intrinsics
(``pinhole*`` polymorphic names) carry focal, principal point and radial
distortion; a distorted camera's images are undistorted once at load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np

from omnigs_torch.cameras import (
    Camera,
    CameraType,
    init_undistort_map_and_mask,
    undistort_image,
)
from omnigs_torch.io.native_loader import load_image
from omnigs_torch.io.ply import load_points_ply
from omnigs_torch.scene.keyframe import Keyframe, pose_from_center
from omnigs_torch.scene.scene import Scene


def _pinhole_camera(data, v0, resolution_scale: float) -> Camera:
    """A pinhole intrinsic: size, focal, principal point and openMVG's
    radial k1 / k3 coefficients in OpenCV order (k1, k2, p1, p2, k3)."""
    vv = v0.get("value0", v0)
    w, h = int(vv["width"]), int(vv["height"])
    f = float(v0.get("focal_length", vv.get("focal_length", 0.0)))
    pp = v0.get("principal_point", [w / 2.0, h / 2.0])
    disto = tuple(float(d) for d in data.get("disto_k3", data.get("disto_k1", [])))
    if len(disto) == 1:
        distortion = (disto[0], 0.0, 0.0, 0.0, 0.0)
    elif len(disto) == 3:
        distortion = (disto[0], disto[1], 0.0, 0.0, disto[2])
    else:
        distortion = ()
    if resolution_scale != 1.0:
        w = int(round(w * resolution_scale))
        h = int(round(h * resolution_scale))
        f *= resolution_scale
        pp = [p * resolution_scale for p in pp]
    return Camera(CameraType.PINHOLE, w, h, fx=f, fy=f, cx=float(pp[0]),
                  cy=float(pp[1]), distortion=distortion)


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
    undistort_maps = {}  # camera → (map1, map2, mask), built once

    for intr in root.get("intrinsics", []):
        cam_id = int(intr["key"])
        name = intr["value"].get("polymorphic_name", "spherical")
        data = intr["value"]["ptr_wrapper"]["data"]
        # spherical: {"value0": {"width": W, "height": H}}; the pinhole
        # variants nest value0.value0 + focal/principal (+ disto)
        v0 = data.get("value0", data)
        if "pinhole" in name:
            scene.cameras[cam_id] = _pinhole_camera(data, v0, resolution_scale)
            continue
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
            if cam.distortion:
                if cam not in undistort_maps:
                    undistort_maps[cam] = init_undistort_map_and_mask(cam)
                m1, m2, _ = undistort_maps[cam]
                if m1 is not None:
                    image = undistort_image(image, m1, m2)
        scene.add_keyframe(
            Keyframe(fid=fid, camera=cam, R_cw=R_cw, t_cw=t_cw, image=image,
                     img_filename=fname, znear=znear, zfar=zfar)
        )

    if points_ply is not None:
        scene.points, scene.colors = load_points_ply(points_ply)
    return scene
