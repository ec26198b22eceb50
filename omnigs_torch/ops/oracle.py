"""Brute-force rasterizer — the semantic ground truth for tests.

Counterpart of `omnigs_tpu/ops/oracle.py`: every pixel tests every
Gaussian (masked by the tile binning predicate), in depth order, with the
reference's numerical rules

  * alpha = min(0.99, opacity · G), skipped when G's exponent > 0,
  * skipped when alpha < 1/255,
  * compositing stops once transmittance would drop below 1e-4,

written as masked cumulative products. O(pixels × P): for tests at small
sizes only.
"""

from __future__ import annotations

from typing import Optional

import torch

from omnigs_torch.cameras import Camera
from omnigs_torch.ops.preprocess import TILE, Preprocessed

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1.0e-4


def composite_pixels(
    pix: torch.Tensor,
    order: torch.Tensor,
    prep: Preprocessed,
    bg: torch.Tensor,
    tile_mask_fn=None,
):
    """Composite (N, 2) pixel centers against the Gaussians taken in
    ``order`` (depth-ascending, stable). ``tile_mask_fn(pix)`` optionally
    gives the (N, P) bool of which *sorted* Gaussians each pixel's tile
    contains. Returns (color (N, 3), final_T (N,), n_contrib (N,))."""
    means2d = prep.means2d[order]
    conic = prep.conic[order]
    rgb = prep.rgb[order]
    opacity = prep.opacity[order]

    d = means2d[None, :, :] - pix[:, None, :]  # (N, P, 2)
    power = (
        -0.5
        * (
            conic[None, :, 0] * d[..., 0] * d[..., 0]
            + conic[None, :, 2] * d[..., 1] * d[..., 1]
        )
        - conic[None, :, 1] * d[..., 0] * d[..., 1]
    )
    alpha = torch.clamp_max(opacity[None, :] * torch.exp(power), ALPHA_MAX)
    live = power <= 0.0
    if tile_mask_fn is not None:
        in_tile = tile_mask_fn(pix)
        live = live & in_tile
    else:
        in_tile = torch.ones_like(live)
    live = live & (alpha >= ALPHA_MIN)
    a = torch.where(live, alpha, torch.zeros_like(alpha))

    one_m_a = 1.0 - a
    incl_T = torch.cumprod(one_m_a, dim=-1)  # T after compositing i
    excl_T = incl_T / one_m_a  # T before compositing i (a < 1 ⇒ safe)
    contribute = incl_T >= T_STOP
    w = a * excl_T * contribute

    color = w @ rgb
    final_T = torch.prod(
        torch.where(contribute, one_m_a, torch.ones_like(one_m_a)), dim=-1
    )
    color = color + final_T[:, None] * bg[None, :]

    rank = torch.cumsum(in_tile.to(torch.int32), dim=-1, dtype=torch.int32)
    n_contrib = torch.amax(
        torch.where(live & contribute, rank, torch.zeros_like(rank)), dim=-1
    )
    return color, final_T, n_contrib


def render_oracle(
    prep: Preprocessed,
    camera: Camera,
    bg: torch.Tensor,
    row_chunk: int = 16,
    tile_accurate: bool = True,
    features: Optional[torch.Tensor] = None,
):
    """Render the full image.

    Args:
      tile_accurate: if True a pixel only sees Gaussians whose tile rect
        covers its tile (exact parity with the binned rasterizer); else
        every valid Gaussian is visible to every pixel.
      features: optional (P, C) override of the composited per-Gaussian
        features (e.g. depths for depth rendering).

    Returns (image (3, H, W), final_T (H, W), n_contrib (H, W)).
    """
    W, H = camera.width, camera.height
    dev = prep.means2d.device
    order = torch.sort(prep.depths, stable=True).indices
    prep_r = prep
    if features is not None:
        f = features if features.ndim == 2 else features[:, None]
        if f.shape[1] == 1:
            f = f.expand(-1, 3)
        prep_r = prep._replace(rgb=f)

    rect_sorted = prep.rect[order]
    valid_sorted = prep.valid[order]

    def tile_mask_fn(pix):
        tx = torch.floor(pix[:, 0:1] / TILE).to(torch.int32)
        ty = torch.floor(pix[:, 1:2] / TILE).to(torch.int32)
        m = (
            (rect_sorted[None, :, 0] <= tx)
            & (tx < rect_sorted[None, :, 2])
            & (rect_sorted[None, :, 1] <= ty)
            & (ty < rect_sorted[None, :, 3])
        )
        return m & valid_sorted[None, :]

    def all_valid(pix):
        return valid_sorted[None, :].expand(pix.shape[0], -1)

    mask_fn = tile_mask_fn if tile_accurate else all_valid

    xs = torch.arange(W, dtype=torch.float32, device=dev)
    colors, ts, ns = [], [], []
    for y0 in range(0, H, row_chunk):
        ys = y0 + torch.arange(row_chunk, dtype=torch.float32, device=dev)
        px = torch.stack([xs.repeat(row_chunk), ys.repeat_interleave(W)], dim=-1)
        c, t, n = composite_pixels(px, order, prep_r, bg, mask_fn)
        colors.append(c.reshape(row_chunk, W, 3))
        ts.append(t.reshape(row_chunk, W))
        ns.append(n.reshape(row_chunk, W))
    color = torch.cat(colors)[:H].permute(2, 0, 1)
    final_T = torch.cat(ts)[:H]
    n_contrib = torch.cat(ns)[:H]
    return color, final_T, n_contrib
