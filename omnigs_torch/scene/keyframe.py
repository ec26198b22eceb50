"""Keyframes: pose + camera + ground-truth image + derived transforms.

Counterpart of `omnigs_tpu/scene/keyframe.py`: poses are stored as
(R_cw, t_cw); `viewmatrix` is T_cw (4×4, row-major) and `campos` the camera
center −R_cwᵀ·t_cw. Only the lonlat camera is ported: `full_proj` raises
for a pinhole camera (ROADMAP queue 1 item 7), and the pyramid budgets
wait for the coarse-to-fine pyramid (item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from omnigs_torch.cameras import Camera, CameraType


@dataclasses.dataclass
class Keyframe:
    fid: int
    camera: Camera
    R_cw: np.ndarray  # (3, 3)
    t_cw: np.ndarray  # (3,)
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0, 1]
    img_filename: str = ""
    # clip planes of the pinhole projection (the lonlat one has none)
    znear: float = 0.01
    zfar: float = 100.0
    # keyframe-use budget of the sampler
    remaining_times_of_use: int = 0

    @property
    def viewmatrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R_cw
        m[:3, 3] = self.t_cw
        return m

    @property
    def campos(self) -> np.ndarray:
        return (-self.R_cw.T @ self.t_cw).astype(np.float32)

    @property
    def full_proj(self) -> Optional[np.ndarray]:
        """view·proj for pinhole; None for lonlat (direct projection)."""
        if self.camera.camera_type == CameraType.PINHOLE:
            raise NotImplementedError(
                "the pinhole camera is not ported to omnigs_torch yet "
                "(ROADMAP queue 1 item 7)"
            )
        return None


def pose_from_center(R_cw: np.ndarray, center: np.ndarray):
    """openMVG extrinsics store (rotation R_cw, camera center c);
    t_cw = −R_cw·c."""
    return R_cw.astype(np.float32), (-R_cw @ center).astype(np.float32)
