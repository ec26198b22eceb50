"""Per-Gaussian preprocessing: cull, project, EWA cov2D, SH→RGB, tile rects.

Counterpart of `omnigs_tpu/ops/preprocess.py`. Everything is vectorized
over the Gaussian axis; culling is expressed as masks, never as dynamic
shapes, so the output has one row per input Gaussian.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omnigs_torch.cameras import (
    Camera,
    CameraType,
    lonlat_jacobian_rows,
    lonlat_project,
    pinhole_jacobian_rows,
    pinhole_project,
    world_to_cam,
)
from omnigs_torch.ops import covariance as cov_ops
from omnigs_torch.ops import sh as sh_ops

TILE = 16  # tile edge in pixels; every layout in the port assumes 16


class Preprocessed(NamedTuple):
    """Per-Gaussian rasterization state (all tensors length P on dim 0)."""

    means2d: torch.Tensor  # (P, 2) pixel coordinates
    depths: torch.Tensor  # (P,) camera z (pinhole) / radial distance (lonlat)
    conic: torch.Tensor  # (P, 3) inverse 2D covariance [A, B, C]
    radii: torch.Tensor  # (P,) float screen radius; 0 ⇒ culled
    rgb: torch.Tensor  # (P, 3) clamped colors
    opacity: torch.Tensor  # (P,) activated opacities
    rect: torch.Tensor  # (P, 4) int32 tile rect [x0, y0, x1, y1), clipped
    tiles_touched: torch.Tensor  # (P,) int32 number of covered tiles
    valid: torch.Tensor  # (P,) bool — survives all culls


def tile_grid(camera: Camera):
    return (
        (camera.width + TILE - 1) // TILE,
        (camera.height + TILE - 1) // TILE,
    )


def _floor_tile(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.clamp(torch.floor(v).to(torch.int32), lo, hi)


def compute_rect(means2d: torch.Tensor, radii: torch.Tensor, grid_x: int, grid_y: int):
    """Bounding tile rectangle, non-cyclic (the ±180° seam is clipped, not
    wrapped)."""
    mx, my = means2d[..., 0], means2d[..., 1]
    x0 = _floor_tile((mx - radii) / TILE, 0, grid_x)
    y0 = _floor_tile((my - radii) / TILE, 0, grid_y)
    x1 = _floor_tile((mx + radii + TILE - 1) / TILE, 0, grid_x)
    y1 = _floor_tile((my + radii + TILE - 1) / TILE, 0, grid_y)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    camera: Camera,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    sh_degree: int,
    scale_modifier: float = 1.0,
    full_proj: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    tight_culling: bool = False,
) -> Preprocessed:
    """Vectorized per-Gaussian preprocess.

    Args:
      means3d: (P, 3) world positions.
      scales: (P, 3) *activated* scales (exp already applied).
      quats: (P, 4) *activated* (normalized) quaternions, (w, x, y, z).
      opacities: (P,) activated opacities in (0, 1).
      shs: (P, M, 3) SH coefficients.
      camera: static camera description.
      viewmatrix: (4, 4) T_cw.
      campos: (3,) camera center in world frame.
      sh_degree: active SH degree.
      full_proj: (4, 4) view·projection of a pinhole camera (required
        there, ignored for lonlat).
      active_mask: optional (P,) bool of live capacity slots.
    """
    W, H = camera.width, camera.height
    gx, gy = tile_grid(camera)
    t = world_to_cam(means3d, viewmatrix)

    # NaN hygiene: culled points (e.g. inactive capacity slots at the camera
    # origin) would give NaN gradients through the projection even though
    # their outputs are masked, so a safe point replaces them before any
    # singular math; `in_front` is computed from the true t.
    safe_point = torch.tensor([0.0, 0.0, 1.0], dtype=t.dtype, device=t.device)
    if camera.camera_type == CameraType.LONLAT:
        in_front = torch.sum(t * t, dim=-1) > 0.04  # `too_close` cull
        t_safe = torch.where(in_front[..., None], t, safe_point)
        means2d, depths, _ = lonlat_project(t_safe, W, H)
        j_rows = lonlat_jacobian_rows(t_safe, W, H)
    elif camera.camera_type == CameraType.PINHOLE:
        if full_proj is None:
            raise ValueError("pinhole camera requires full_proj")
        in_front = t[..., 2] > 0.2  # `in_frustum` near cull
        t_safe = torch.where(in_front[..., None], t, safe_point)
        # the world point too: pinhole projects it through full_proj
        means3d_safe = torch.where(
            in_front[..., None], means3d, campos + viewmatrix[:3, :3].T @ safe_point
        )
        means2d, depths, _ = pinhole_project(t_safe, W, H, full_proj, means3d_safe)
        j_rows = pinhole_jacobian_rows(
            t_safe, camera.fx, camera.fy, camera.tan_fovx, camera.tan_fovy
        )
    else:
        raise NotImplementedError(f"camera_type {camera.camera_type}")

    if cov3d_precomp is None:
        cov6 = cov_ops.build_cov3d_components(scales, quats, scale_modifier)
    else:
        cov6 = tuple(cov3d_precomp[..., i] for i in range(6))
    c2a, c2b, c2c = cov_ops.project_cov3d_components(
        cov6, j_rows, viewmatrix[:3, :3]
    )
    (cA, cB, cC), det = cov_ops.invert_cov2d_components(c2a, c2b, c2c)
    conic = torch.stack([cA, cB, cC], dim=-1)
    radii = cov_ops.cov2d_extent_components(
        c2a, c2c, det, opacity=opacities if tight_culling else None
    )

    # The binning layout invariant (per-tile rect-cover counts == emitted
    # instances per tile) needs every consumer to read the SAME rect, so it
    # is computed once here and this one tensor is handed on.
    rect = compute_rect(means2d, radii, gx, gy)
    area = (rect[..., 2] - rect[..., 0]) * (rect[..., 3] - rect[..., 1])

    valid = in_front & (det != 0.0) & (area > 0)
    if active_mask is not None:
        valid = valid & active_mask

    if colors_precomp is None:
        # same NaN hygiene: the view-direction normalization is singular at
        # mean == campos (inactive slots)
        means3d_sh = torch.where(
            in_front[..., None], means3d, campos + safe_point
        )
        rgb = sh_ops.sh_to_rgb(sh_degree, shs, means3d_sh, campos)
    else:
        rgb = colors_precomp

    radii = torch.where(valid, radii, torch.zeros_like(radii))
    tiles = torch.where(valid, area, torch.zeros_like(area)).to(torch.int32)
    return Preprocessed(
        means2d=means2d,
        depths=depths,
        conic=conic,
        radii=radii,
        rgb=rgb,
        opacity=opacities,
        rect=rect,
        tiles_touched=tiles,
        valid=valid,
    )
