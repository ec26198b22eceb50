"""Tile-binned differentiable rasterizer, every layout of it.

Counterpart of `omnigs_tpu/ops/rasterize.py`. With the kernel backend
(``backend="pallas"``) binning takes one of three layouts, as in JAX:

* the depth-presorted packed key (`bin_instances_packed`, ``depth_presort``
  with P ≤ 2^19 and fewer than 8,191 tiles; the production layout);
* the ghost-aligned layout (`bin_instances_aligned`, ``ghost_align``):
  every tile's run padded to a CHUNK multiple inside the sort;
* the compact 2-key layout (`bin_instances`) otherwise;

and the instances go to one of two compositors:

* segmented (``segmented``): segment_relay → _build_inst_seg →
  composite_seg_fwd (Hopper kernel) → _tiles_to_image, with the gradient
  through `composite_seg.composite_instances_seg`;
* tile-major (``segmented=False``, the only kernel path with ``n_contrib``):
  the ``aligned_cap`` trim → _build_inst → composite_tile_fwd (Hopper
  kernel) → _tiles_to_image, with the gradient through
  `composite_tile.composite_instances` (the backward kernel and the scatter
  or gather reduction, or the fused backward).

``backend="xla"`` takes the dense per-tile layout (`bin_gaussians`) and
the chunked compositor `_composite_tiles` in plain PyTorch (the JAX
package's XLA path has no Pallas kernel). Then autograd runs back through
`preprocess`. Binning reads detached inputs, as the JAX path stops their
gradient.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from omnigs_torch.cameras import Camera
from omnigs_torch.ops.binning import (
    RANK_BITS,
    bin_gaussians,
    bin_instances,
    bin_instances_aligned,
    bin_instances_packed,
    segment_relay,
)
from omnigs_torch.ops.composite_seg import (
    ALPHA_MAX,
    ALPHA_MIN,
    CHUNK,
    T_STOP,
    _reduce_rows,
    composite_instances_seg,
)
from omnigs_torch.ops.composite_tile import composite_instances, tile_origins
from omnigs_torch.ops.preprocess import (
    TILE,
    Preprocessed,
    device_constant,
    preprocess,
    tile_grid,
)
from omnigs_torch.utils import profiling

# above this instance cap the gather reduction demotes to the live-bound
# scatter: its inversion sort scales with the static cap (the JAX rule)
GATHER_REDUCE_MAX_R = 1 << 21


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static capacity knobs; same fields and defaults as the JAX
    `RasterConfig` except the TPU-only ``interpret`` (the tensor's device
    picks kernel or plain version here)."""

    max_instances: int = 1 << 20  # instance buffer capacity R
    tile_cap: int = 1024  # max composited instances per tile (XLA backend)
    chunk: int = 32  # instances composited per scan step (XLA backend)
    backend: str = "xla"  # "xla" | "pallas" (the kernel path)
    # opacity-aware radii: fewer instances, output-identical except at
    # the right/bottom rect edge (ROADMAP queue 3)
    tight_culling: bool = False
    tile_culling: bool = False  # exact ellipse–box culling in binning
    aligned_cap: Optional[int] = None  # live-slab cap (counted drops)
    ghost_align: bool = False
    want_ncontrib: bool = True
    fused_reduce: bool = False
    gather_reduce: bool = False
    depth_presort: bool = False  # packed-key binning
    segmented: bool = False  # segmented compositing (else tile-major)

    def __post_init__(self):
        if self.tile_cap % self.chunk != 0:
            raise ValueError("tile_cap must be a multiple of chunk")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.segmented:
            if self.backend != "pallas":
                raise ValueError("segmented needs the pallas backend")
            if self.want_ncontrib:
                raise ValueError("segmented kernels do not compute n_contrib")
            if self.ghost_align or self.fused_reduce:
                raise ValueError("segmented replaces the ghost/fused layouts")
        if (
            self.aligned_cap is not None
            and self.backend == "pallas"
            and self.aligned_cap % CHUNK != 0
        ):
            raise ValueError(
                f"aligned_cap must be a multiple of {CHUNK}, got {self.aligned_cap}"
            )


class RenderResult(NamedTuple):
    image: torch.Tensor  # (3, H, W) channels-first
    radii: torch.Tensor  # (P,) float; 0 ⇒ culled (visibility filter)
    final_T: torch.Tensor  # (H, W) transmittance (no gradient)
    n_contrib: torch.Tensor  # (H, W) int32 (zeros on the segmented path
    # and when want_ncontrib is False)
    overflow: torch.Tensor  # () int32 instances dropped by tile_cap
    truncated: torch.Tensor  # () int32 instances dropped by any cap


def _tile_pixel_coords(
    grid_x: int, grid_y: int, device=None, tile_lo: int = 0, n_tiles=None
) -> torch.Tensor:
    """(n_tiles, TILE², 2) f32 integer pixel coordinates of the tiles
    [tile_lo, tile_lo + n_tiles) of the row-major grid (all by default)."""
    n = grid_x * grid_y if n_tiles is None else n_tiles
    t = tile_lo + torch.arange(n, device=device)
    p = torch.arange(TILE * TILE, device=device)
    x = (t % grid_x)[:, None] * TILE + (p % TILE)[None, :]
    y = (t // grid_x)[:, None] * TILE + (p // TILE)[None, :]
    return torch.stack([x, y], dim=-1).to(torch.float32)


def _chunk_geometry(ids, msk, means2d, conic, opacity, pix):
    """Per-(tile, pixel, instance) geometry of one chunk of the dense
    layout, shared by the forward and the backward: (α masked to the live
    pairs, live, G, dx, dy, conic (T, KC, 3), opacity (T, KC))."""
    xy = means2d[ids]  # (T, KC, 2)
    con = conic[ids]
    op = opacity[ids]
    dx = xy[:, None, :, 0] - pix[:, :, None, 0]  # (T, PX, KC)
    dy = xy[:, None, :, 1] - pix[:, :, None, 1]
    power = (
        -0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy)
        - con[:, None, :, 1] * dx * dy
    )
    G = torch.exp(torch.clamp_max(power, 0.0))
    alpha = torch.clamp_max(op[:, None, :] * G, ALPHA_MAX)
    live = msk[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(live, alpha, 0.0)
    return a, live, G, dx, dy, con, op


def _chunks(tile_ids, tile_mask, chunk):
    """The dense layout's (ids int64, mask) per scan step of ``chunk``."""
    for c in range(tile_ids.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        yield c, tile_ids[:, sl].to(torch.int64), tile_mask[:, sl]


def _composite_tiles_fwd_impl(
    means2d, conic, rgb, opacity, bg, tile_ids, tile_mask, pix, chunk
):
    """Forward compositing of the dense layout, one chunk per scan step →
    (color (T, PX, 3) with the background blended in, final_T (T, PX),
    n_contrib (T, PX) int32)."""
    num_tiles, px = pix.shape[:2]
    dev = means2d.device
    N = torch.ones(num_tiles, px, device=dev)
    T_stop = torch.ones(num_tiles, px, device=dev)
    color = torch.zeros(num_tiles, px, 3, device=dev)
    n_contrib = torch.zeros(num_tiles, px, dtype=torch.int32, device=dev)
    rank = torch.arange(1, chunk + 1, dtype=torch.int32, device=dev)
    for c, ids, msk in _chunks(tile_ids, tile_mask, chunk):
        a, live, *_ = _chunk_geometry(ids, msk, means2d, conic, opacity, pix)
        one_m = 1.0 - a
        N_incl = N[..., None] * torch.cumprod(one_m, dim=-1)
        N_excl = N_incl / one_m
        contrib = N_incl >= T_STOP
        w = a * N_excl * contrib
        color = color + torch.bmm(w, rgb[ids])
        T_stop = T_stop * torch.prod(torch.where(contrib, one_m, 1.0), dim=-1)
        N = N_incl[..., -1]
        ranks = torch.where(live & contrib, rank + c * chunk, 0)
        n_contrib = torch.maximum(n_contrib, ranks.amax(dim=-1))
    color = color + T_stop[..., None] * bg[None, None, :]
    return color, T_stop, n_contrib


def _composite_tiles_bwd(
    means2d, conic, rgb, opacity, tile_ids, tile_mask, pix, chunk, color_full,
    dL_dcolor,
):
    """The dense layout's backward → (P, 9) gradient rows (x, y, A, B, C,
    opacity, r, g, b): per chunk, the per-(tile, instance) partials, summed
    per Gaussian by the deterministic `_reduce_rows` (masked lanes go to its
    discarded rows, the JAX scatter's ``mode="drop"``)."""
    num_tiles, px = pix.shape[:2]
    p = means2d.shape[0]
    dev = means2d.device
    N = torch.ones(num_tiles, px, device=dev)
    prefix = torch.zeros(num_tiles, px, 3, device=dev)
    rows = []
    for _, ids, msk in _chunks(tile_ids, tile_mask, chunk):
        a, live, G, dx, dy, con, op = _chunk_geometry(
            ids, msk, means2d, conic, opacity, pix
        )
        col = rgb[ids]  # (T, KC, 3)
        one_m = 1.0 - a
        N_incl = N[..., None] * torch.cumprod(one_m, dim=-1)
        N_excl = N_incl / one_m
        contrib = N_incl >= T_STOP
        gate = live & contrib
        w = a * N_excl * contrib
        # w_j·c_j accumulated colors: the inclusive in-chunk prefix
        wc = w[..., None] * col[:, None, :, :]  # (T, PX, KC, 3)
        B = color_full[:, :, None, :] - (prefix[:, :, None, :] + torch.cumsum(wc, dim=2))
        # dL/dα = Σ_ch dL_dC·(N_excl·c − B/(1−α)); the 0.99 clamp is
        # ignored, as in the reference
        term1 = N_excl * torch.bmm(dL_dcolor, col.transpose(1, 2))
        term2 = (B * dL_dcolor[:, :, None, :]).sum(-1) / one_m
        dL_da = torch.where(gate, term1 - term2, 0.0)
        dL_dG = op[:, None, :] * dL_da
        gdx, gdy = G * dx, G * dy
        A, Bc, C = (con[:, None, :, i] for i in range(3))
        rows.append(torch.cat([
            torch.stack([
                torch.sum(dL_dG * (-gdx * A - gdy * Bc), dim=1),
                torch.sum(dL_dG * (-gdy * C - gdx * Bc), dim=1),
                torch.sum(-0.5 * gdx * dx * dL_dG, dim=1),
                torch.sum(-gdx * dy * dL_dG, dim=1),
                torch.sum(-0.5 * gdy * dy * dL_dG, dim=1),
                torch.sum(G * dL_da, dim=1),
            ], dim=-1),
            torch.bmm(w.transpose(1, 2), dL_dcolor),
        ], dim=-1))  # (T, KC, 9)
        prefix = prefix + wc.sum(dim=2)
        N = N_incl[..., -1]
    rows = torch.cat(rows, dim=1).reshape(-1, 9)
    sids = torch.where(tile_mask, tile_ids, p).reshape(-1)
    return _reduce_rows(rows.T, sids, p)


class _CompositeTiles(torch.autograd.Function):
    """The JAX ``_composite_tiles`` custom VJP: the chunked forward, and a
    backward that recomputes each chunk's transmittances from the saved
    full color. ``bg`` gets a zero gradient; ``final_T`` and ``n_contrib``
    are non-differentiable."""

    @staticmethod
    def forward(ctx, means2d, conic, rgb, opacity, bg, tile_ids, tile_mask, pix, chunk):
        profiling.mark("composite_fwd", means2d)
        color, final_t, n_contrib = _composite_tiles_fwd_impl(
            means2d, conic, rgb, opacity, bg, tile_ids, tile_mask, pix, chunk
        )
        ctx.save_for_backward(means2d, conic, rgb, opacity, tile_ids, tile_mask, pix, color)
        ctx.chunk, ctx.bg_shape = chunk, bg.shape
        ctx.mark_non_differentiable(final_t, n_contrib)
        return color, final_t, n_contrib

    @staticmethod
    def backward(ctx, dcolor, _dfinal_t, _dncontrib):
        means2d, conic, rgb, opacity, tile_ids, tile_mask, pix, color = ctx.saved_tensors
        profiling.mark("composite_bwd", means2d)
        acc = _composite_tiles_bwd(
            means2d, conic, rgb, opacity, tile_ids, tile_mask, pix, ctx.chunk,
            color, dcolor.contiguous(),
        )
        dbg = color.new_zeros(ctx.bg_shape)
        profiling.mark("preprocess_bwd", means2d)
        return acc[:, 0:2], acc[:, 2:5], acc[:, 6:9], acc[:, 5], dbg, None, None, None, None


def _tiles_to_image(tiles: torch.Tensor, grid_x: int, grid_y: int, W: int, H: int):
    """(num_tiles, TILE²) → (H, W) or (num_tiles, C, TILE²) → (C, H, W)."""
    if tiles.ndim == 3:
        c = tiles.shape[1]
        img = tiles.reshape(grid_y, grid_x, c, TILE, TILE)
        img = img.permute(2, 0, 3, 1, 4).reshape(c, grid_y * TILE, grid_x * TILE)
        return img[:, :H, :W]
    img = tiles.reshape(grid_y, grid_x, TILE, TILE)
    img = img.permute(0, 2, 1, 3).reshape(grid_y * TILE, grid_x * TILE)
    return img[:H, :W]


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    *,
    camera: Camera,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    bg: torch.Tensor,
    sh_degree: int,
    config: RasterConfig = RasterConfig(),
    scale_modifier: float = 1.0,
    full_proj: Optional[torch.Tensor] = None,
    means2d_ndc: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    features_override: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Differentiable render of one view.

    Args:
      full_proj: (4, 4) view·projection of a pinhole camera (required
        there; `Keyframe.full_proj`).
      means2d_ndc: optional (P, 2) zeros whose gradient receives the
        NDC-convention screen-space gradients of the densification
        statistics (the training path).
      features_override: optional (P,) or (P, 3) per-Gaussian features to
        composite instead of RGB (depth rendering).
    """
    W, H = camera.width, camera.height
    gx, gy = tile_grid(camera)
    prep = preprocess(
        means3d,
        scales,
        quats,
        opacities,
        shs,
        camera,
        viewmatrix,
        campos,
        sh_degree,
        scale_modifier,
        full_proj=full_proj,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        active_mask=active_mask,
        tight_culling=config.tight_culling,
    )
    means2d = prep.means2d
    if means2d_ndc is not None:
        half = device_constant((W * 0.5, H * 0.5), means2d.device, torch.get_default_dtype())
        means2d = means2d + means2d_ndc * half

    rgb = prep.rgb
    if features_override is not None:
        f = features_override
        rgb = f[:, None].expand(-1, 3) if f.ndim == 1 else f

    color_t, T_t, n_t, overflow, truncated = _composite(
        config, prep, means2d, rgb, bg, gx, gy
    )
    return RenderResult(
        image=_tiles_to_image(color_t, gx, gy, W, H),
        radii=prep.radii,
        final_T=_tiles_to_image(T_t, gx, gy, W, H).detach(),
        n_contrib=_tiles_to_image(n_t, gx, gy, W, H),
        overflow=overflow,
        truncated=truncated,
    )


def _composite(config, prep, means2d, rgb, bg, gx, gy, tile_lo=0, n_tiles=None):
    """Bin ``prep`` (read detached) into the config's layout and composite
    ``means2d``, ``prep.conic``, ``rgb`` and ``prep.opacity`` over ``bg`` →
    (color (T, 3, PX), final_T (T, PX), n_contrib (T, PX), overflow,
    truncated), differentiable in those four. T is the tile window
    [tile_lo, tile_lo + n_tiles) of the grid (all of it by default: a
    rank of the sharded render composites its own window). Stage marks:
    ``bin``, ``relay`` (the kernel layouts' relay or trim and slab build)
    and ``composite_fwd`` (in the compositor, after the slab build)."""
    num_tiles = gx * gy if n_tiles is None else n_tiles
    window = dict(tile_lo=tile_lo, n_tiles=num_tiles)
    prep_sg = Preprocessed(*(t.detach() for t in prep))
    profiling.mark("bin", means2d)
    if config.backend == "xla":
        binned = bin_gaussians(
            prep_sg, gx, gy, config.max_instances, config.tile_cap, **window
        )
        color_t, T_t, n_t = _CompositeTiles.apply(
            means2d, prep.conic, rgb, prep.opacity, bg, binned.tile_ids,
            binned.tile_mask, _tile_pixel_coords(gx, gy, means2d.device, **window),
            config.chunk,
        )
        # the dense compositor keeps its channels-minor scan layout
        return color_t.transpose(1, 2), T_t, n_t, binned.overflow, binned.truncated
    overflow = torch.zeros((), dtype=torch.int32, device=means2d.device)
    p_gauss = means2d.shape[0]
    gather_reduce = (
        config.gather_reduce
        and config.max_instances <= GATHER_REDUCE_MAX_R
        and not config.segmented
    )
    packable = (
        config.depth_presort
        and not config.ghost_align
        and p_gauss <= (1 << RANK_BITS)
        and gx * gy < (1 << (32 - RANK_BITS)) - 1
    )
    if packable:
        # sorted_g holds depth ranks, mapped by perm
        bin_fn = bin_instances_packed
    elif config.ghost_align:
        # every tile's run padded to a CHUNK multiple with ghost instances
        bin_fn = functools.partial(bin_instances_aligned, chunk=CHUNK)
    else:
        bin_fn = bin_instances
    inst = bin_fn(
        prep_sg, gx, gy, config.max_instances, **window,
        tile_cull=config.tile_culling, with_emission=gather_reduce,
    )
    truncated = inst.truncated
    profiling.mark("relay", means2d)
    if config.segmented:
        r8 = config.aligned_cap
        if r8 is None:
            r8 = -(-config.max_instances // CHUNK) * CHUNK
        seg = segment_relay(
            inst.sorted_g, inst.starts, inst.counts, r8, p_gauss, inst.sorted_key
        )
        color_t, T_t, n_t = composite_instances_seg(
            means2d, prep.conic, rgb, prep.opacity, bg, seg.sorted_g8,
            seg.starts8, seg.counts, seg.live8, seg.ride_d, seg.ride_t,
            inst.perm, inst.inv_perm, num_tiles, gx, tile_lo,
        )
        return color_t, T_t, n_t, overflow, truncated + seg.truncated
    # trim the slab to its live prefix under aligned_cap (dropped tiles
    # counted); sorted_e is not trimmed, the gather reduction needs every
    # survivor rank
    sorted_g, starts, counts = inst.sorted_g, inst.starts, inst.counts
    cap = config.aligned_cap
    if cap is not None and cap < sorted_g.shape[0]:
        if config.ghost_align:
            fits = starts + ((counts + CHUNK - 1) // CHUNK) * CHUNK <= cap
        else:
            fits = starts + counts <= cap
        truncated = truncated + torch.sum(torch.where(fits, 0, counts), dtype=torch.int32)
        counts = torch.where(fits, counts, 0)
        starts = torch.clamp(starts, 0, cap - 1)
        sorted_g = sorted_g[:cap]
    x0, y0 = tile_origins(gx, gy, means2d.device, **window)
    color_t, T_t, n_t = composite_instances(
        means2d, prep.conic, rgb, prep.opacity, bg, sorted_g, starts, counts,
        x0, y0, inst.sorted_e, inst.seg_lo, inst.seg_hi, inst.perm,
        inst.inv_perm, num_tiles, config.want_ncontrib, config.fused_reduce,
    )
    return color_t, T_t, n_t, overflow, truncated
