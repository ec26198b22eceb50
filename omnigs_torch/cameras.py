"""Camera models as plain functions on tensors + a small container.

Counterpart of `omnigs_tpu/cameras.py`; conventions are identical:

* ``viewmatrix`` is the world→camera rigid transform ``T_cw`` as a (4, 4)
  row-major matrix: ``t_cam = viewmatrix[:3, :3] @ p_world + viewmatrix[:3, 3]``.
* Pixel coordinates: x right (width), y down (height); screen ("NDC")
  coordinates live in [-1, 1], ``ndc2pix(v, S) = ((v + 1) * S - 1) / 2``.
* Lonlat projection: ``lon = atan2(x, z)``, ``lat = asin(y / r)``, screen =
  ``(lon / pi, 2 * lat / pi)``; depth is the radial distance r.

* Pinhole projection: the world point through the (4, 4) row-major
  view·projection matrix ``full_proj`` and a perspective divide; depth is
  camera z. Lens distortion is removed from the images at load
  (`init_undistort_map_and_mask`, `undistort_image`, cv2 on the host), so
  rendering always works in the rectified model.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import torch


class CameraType(enum.IntEnum):
    """Matches the reference camera enum."""

    INVALID = 0
    PINHOLE = 1
    FISHEYE = 2
    LONLAT = 3


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description."""

    camera_type: CameraType
    width: int
    height: int
    # Pinhole intrinsics (ignored for LONLAT).
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    # Lens distortion coefficients in OpenCV order (k1, k2, p1, p2[, k3]).
    # Nonempty ⇒ an undistort mask multiplies rendered images in the loss,
    # eval and viewer.
    distortion: Tuple[float, ...] = ()

    @property
    def tan_fovx(self) -> float:
        return self.width / (2.0 * self.fx) if self.fx else 0.0

    @property
    def tan_fovy(self) -> float:
        return self.height / (2.0 * self.fy) if self.fy else 0.0


def init_undistort_map_and_mask(camera: Camera):
    """Host-side cv2 undistort rectify maps and the valid-pixel mask (a
    white image remapped: fractional at the warped border). Returns (map1,
    map2, mask (H, W) float32), or (None, None, None) for a camera with no
    distortion."""
    import cv2
    import numpy as np

    if not camera.distortion or not any(camera.distortion):
        return None, None, None
    K = np.array(
        [[camera.fx, 0.0, camera.cx], [0.0, camera.fy, camera.cy], [0.0, 0.0, 1.0]],
        np.float32,
    )
    dist = np.asarray(camera.distortion, np.float32)
    map1, map2 = cv2.initUndistortRectifyMap(
        K, dist, np.eye(3, dtype=np.float32), K,
        (camera.width, camera.height), cv2.CV_32FC1,
    )
    white = np.ones((camera.height, camera.width), np.float32)
    mask = cv2.remap(white, map1, map2, cv2.INTER_LINEAR)
    return map1, map2, mask


def undistort_image(img, map1, map2):
    """Remap a host image through the undistort maps (bilinear)."""
    import cv2

    return cv2.remap(img, map1, map2, cv2.INTER_LINEAR)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """Screen [-1, 1] → pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


_EPS = 1.0e-7  # the reference's +1e-7 pole/seam guards


class _Asin(torch.autograd.Function):
    """``torch.asin`` whose derivative stays finite at |x| = 1.

    The lonlat latitude takes asin(clamp(y / (r + ε), -1, 1)); within ~1e-4
    rad of the camera's pole axis y / (r + ε) rounds to ±1 exactly, where
    autograd's 1 / sqrt(1 - x²) is inf, and the infinities of its paths meet
    in t's gradient as inf − inf = NaN: a NaN position and Adam moments that
    stay in the model (rare: a Gaussian that close to the axis of a view,
    with a gradient). The derivative is autograd's own, ``g · rsqrt(−x·x +
    1)`` in its operation order, with 1 − x² floored at the dtype's eps, the
    least value an |x| < 1 gives: bit for bit autograd's everywhere else, and
    at ±1 that of the nearest value below 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.asin(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.rsqrt(torch.clamp_min(-x * x + 1, torch.finfo(x.dtype).eps))


def world_to_cam(means: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """(..., 3) world points → camera frame under T_cw (a full-f32 matmul,
    see the package docstring)."""
    return means @ viewmatrix[:3, :3].T + viewmatrix[:3, 3]


def lonlat_project(t: torch.Tensor, width: int, height: int):
    """Equirectangular projection of camera-space points.

    Returns (pix (..., 2), radial depth (...,), valid (r² > 0.04)).
    """
    rr = torch.sum(t * t, dim=-1)
    r = torch.sqrt(rr)
    inv_r = 1.0 / (r + _EPS)
    lon = torch.atan2(t[..., 0], t[..., 2])
    lat = _Asin.apply(torch.clamp(t[..., 1] * inv_r, -1.0, 1.0))
    sx = lon * (1.0 / math.pi)
    sy = lat * (2.0 / math.pi)
    pix = torch.stack([ndc2pix(sx, width), ndc2pix(sy, height)], dim=-1)
    valid = rr > 0.04
    return pix, r, valid


def lonlat_jacobian_rows(t: torch.Tensor, width: int, height: int):
    """∂pixel/∂t for the equirect map as component columns
    ((Jx0, Jx1, Jx2), (Jy0, Jy1, Jy2)):

    dpx/dt = (W/2π)·[z, 0, -x] / (x²+z²)
    dpy/dt = (H/π)·[-xy, r_xz², -zy] / (r_xz · r²)
    with the reference's +1e-7 guards at the poles/origin.
    """
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    rxz2 = x * x + z * z
    rxz2_inv = 1.0 / (rxz2 + _EPS)
    rxz = torch.sqrt(rxz2)
    rxz_inv = 1.0 / (rxz + _EPS)
    rr = rxz2 + y * y
    rr_inv = 1.0 / (rr + _EPS)

    w_2pi = width * 0.5 / math.pi
    h_pi = height / math.pi

    zeros = torch.zeros_like(x)
    row_x = (w_2pi * z * rxz2_inv, zeros, -w_2pi * x * rxz2_inv)
    row_y = (
        -h_pi * x * y * rxz_inv * rr_inv,
        h_pi * rxz * rr_inv,
        -h_pi * z * y * rxz_inv * rr_inv,
    )
    return row_x, row_y


def pinhole_project(
    t: torch.Tensor,
    width: int,
    height: int,
    full_proj: torch.Tensor,
    means_world: torch.Tensor,
):
    """Pinhole projection of the *world* points through ``full_proj`` (4, 4,
    row-major: ``hom = full_proj @ [p, 1]``), perspective divide with the
    +1e-7 guard, near cull at camera z ≤ 0.2.

    Returns (pix (..., 2), camera-z depth (...,), valid)."""
    ones = torch.ones_like(means_world[..., :1])
    hom = torch.cat([means_world, ones], dim=-1) @ full_proj.T
    p_w = 1.0 / (hom[..., 3] + _EPS)
    sx = hom[..., 0] * p_w
    sy = hom[..., 1] * p_w
    pix = torch.stack([ndc2pix(sx, width), ndc2pix(sy, height)], dim=-1)
    depth = t[..., 2]
    valid = depth > 0.2
    return pix, depth, valid


def pinhole_jacobian_rows(
    t: torch.Tensor, fx: float, fy: float, tan_fovx: float, tan_fovy: float
):
    """Perspective EWA Jacobian with the 1.3·tan(fov) clamp, as component
    columns (see `lonlat_jacobian_rows`)."""
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    z = t[..., 2]
    tx = torch.clamp(t[..., 0] / z, -limx, limx) * z
    ty = torch.clamp(t[..., 1] / z, -limy, limy) * z
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(z)
    row_x = (fx * inv_z, zeros, -fx * tx * inv_z2)
    row_y = (zeros, fy * inv_z, -fy * ty * inv_z2)
    return row_x, row_y


def pinhole_jacobian(
    t: torch.Tensor, fx: float, fy: float, tan_fovx: float, tan_fovy: float
) -> torch.Tensor:
    """Stacked (..., 2, 3) form of `pinhole_jacobian_rows`."""
    row_x, row_y = pinhole_jacobian_rows(t, fx, fy, tan_fovx, tan_fovy)
    return torch.stack(
        [torch.stack(row_x, dim=-1), torch.stack(row_y, dim=-1)], dim=-2
    )


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov * 0.5))


def getProjectionMatrix(
    znear: float, zfar: float, fovx: float, fovy: float
) -> torch.Tensor:
    """OpenGL-style (4, 4) float32 projection matrix, row-major (on the
    CPU; callers move it with the pose)."""
    tan_half_x = math.tan(fovx / 2.0)
    tan_half_y = math.tan(fovy / 2.0)
    top = tan_half_y * znear
    bottom = -top
    right = tan_half_x * znear
    left = -right
    P = torch.zeros((4, 4), dtype=torch.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P
