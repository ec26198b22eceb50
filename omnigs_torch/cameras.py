"""Camera models as plain functions on tensors + a small container.

Counterpart of `omnigs_tpu/cameras.py`; conventions are identical:

* ``viewmatrix`` is the world→camera rigid transform ``T_cw`` as a (4, 4)
  row-major matrix: ``t_cam = viewmatrix[:3, :3] @ p_world + viewmatrix[:3, 3]``.
* Pixel coordinates: x right (width), y down (height); screen ("NDC")
  coordinates live in [-1, 1], ``ndc2pix(v, S) = ((v + 1) * S - 1) / 2``.
* Lonlat projection: ``lon = atan2(x, z)``, ``lat = asin(y / r)``, screen =
  ``(lon / pi, 2 * lat / pi)``; depth is the radial distance r.

Only the lonlat (equirectangular) model is ported so far; the pinhole
projection and the undistortion helpers follow in a later slice
(ROADMAP queue 1, "side features").
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
    distortion: Tuple[float, ...] = ()


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """Screen [-1, 1] → pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


_EPS = 1.0e-7  # the reference's +1e-7 pole/seam guards


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
    lat = torch.asin(torch.clamp(t[..., 1] * inv_r, -1.0, 1.0))
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
