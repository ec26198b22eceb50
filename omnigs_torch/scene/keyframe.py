"""Keyframes: pose + camera + ground-truth image + derived transforms.

Counterpart of `omnigs_tpu/scene/keyframe.py`: poses are stored as
(R_cw, t_cw); `viewmatrix` is T_cw (4×4, row-major) and `campos` the camera
center −R_cwᵀ·t_cw; for a pinhole camera `full_proj` is the OpenGL-style
view·projection product (float32, row-major).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from omnigs_torch.cameras import Camera, CameraType, focal2fov, getProjectionMatrix


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
    # coarse-to-fine pyramid budgets per sub-level (None until first used)
    pyramid_budgets: Optional[list] = None

    def current_pyramid_level(self, num_sub_levels: int) -> int:
        """Lowest sub-level with remaining budget (consumed), else the full
        resolution level == num_sub_levels."""
        if self.pyramid_budgets is None:
            return num_sub_levels
        for i, b in enumerate(self.pyramid_budgets):
            if b > 0:
                self.pyramid_budgets[i] -= 1
                return i
        return num_sub_levels

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
        if self.camera.camera_type != CameraType.PINHOLE:
            return None
        fovx = focal2fov(self.camera.fx, self.camera.width)
        fovy = focal2fov(self.camera.fy, self.camera.height)
        proj = getProjectionMatrix(self.znear, self.zfar, fovx, fovy).numpy()
        return (proj @ self.viewmatrix).astype(np.float32)


def pose_from_center(R_cw: np.ndarray, center: np.ndarray):
    """openMVG extrinsics store (rotation R_cw, camera center c);
    t_cw = −R_cw·c."""
    return R_cw.astype(np.float32), (-R_cw @ center).astype(np.float32)
