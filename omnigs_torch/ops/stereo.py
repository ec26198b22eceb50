"""Stereo / monocular geometry ops (SLAM-heritage point seeding).

Counterpart of `omnigs_tpu/ops/stereo.py`: depth-map back-projection and
the "inactive geometry densify" keypoint seeding of the Photo-SLAM lineage.
The neighbour search is one (N, N) distance matrix, and the reference's
host-side compaction is a static validity mask. The reference's quirks are
kept, as in the JAX package:

* ``max_pixel_dist`` is compared against the **squared** pixel distance
  (the threshold is never squared), exclusive on >;
* ties in the neighbour search go to the lowest keypoint index;
* a keypoint with no positive-depth neighbour gets z = −1 and is masked
  out, and pass-through keypoints with z ≤ 0 are masked out by the same
  z > 0 filter.

``colors`` is a (num_pixels, 3) array indexed by pixel, the JAX package's
deliberate deviation from the reference's interleaved-buffer indexing.
"""

from __future__ import annotations

from typing import Tuple

import torch


def reproject_depth_pinhole(
    depth: torch.Tensor,
    mask: torch.Tensor,
    intr: Tuple[float, float, float, float],
    width: int,
) -> torch.Tensor:
    """(P,) row-major flat depth map → (P, 3) camera-space points
    ((u − cx)·d/fx, (v − cy)·d/fy, d); masked-out pixels give (0, 0, 0)."""
    fx, fy, cx, cy = intr
    idx = torch.arange(depth.shape[0], dtype=torch.int32, device=depth.device)
    v = (idx // width).to(depth.dtype)
    u = (idx % width).to(depth.dtype)
    pts = torch.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth], dim=-1)
    return torch.where(mask[:, None], pts, torch.zeros_like(pts))


def inactive_geo_densify(
    kps_pixel: torch.Tensor,
    kps_has3d: torch.Tensor,
    kps_point_local: torch.Tensor,
    colors: torch.Tensor,
    max_pixel_dist: float,
    intr: Tuple[float, float, float, float],
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seed 3D points for keypoints lacking geometry from their nearest
    triangulated neighbour's depth.

    Keypoints with a local 3D point (``kps_has3d``) pass through; the rest
    take the z of the nearest has-3D keypoint whose squared pixel distance
    is ≤ ``max_pixel_dist`` and back-project it through the pinhole
    intrinsics. Colors are sampled at each keypoint's pixel. Returns
    (points (N, 3), colors (N, 3), valid (N,) bool): ``valid`` is z > 0,
    and invalid keypoints' colors are zeroed.
    """
    fx, fy, cx, cy = intr
    n = kps_pixel.shape[0]
    u, v = kps_pixel[:, 0], kps_pixel[:, 1]
    du = u[:, None] - u[None, :]
    dv = v[:, None] - v[None, :]
    dist2 = du * du + dv * dv
    eligible = kps_has3d[None, :] & ~torch.eye(n, dtype=torch.bool, device=u.device)
    dist2 = torch.where(eligible & (dist2 <= max_pixel_dist), dist2,
                        torch.full_like(dist2, torch.inf))
    nearest = torch.argmin(dist2, dim=1)  # ties → the lowest index
    found = torch.isfinite(torch.gather(dist2, 1, nearest[:, None]))[:, 0]
    depth = torch.where(found, kps_point_local[nearest, 2], torch.full_like(u, -1.0))
    reproj = torch.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth], dim=-1)
    points = torch.where(kps_has3d[:, None], kps_point_local, reproj)
    pix = torch.clamp(
        v.to(torch.int32) * width + u.to(torch.int32), 0, colors.shape[0] - 1
    ).to(torch.int64)
    valid = points[:, 2] > 0.0
    out_colors = torch.where(valid[:, None], colors[pix], torch.zeros_like(colors[pix]))
    return points, out_colors, valid
