"""Tile-major compositing: the counterpart of `omnigs_tpu/ops/pallas_raster.py`.

The compact layout: binning leaves each tile's depth-sorted instances in
one contiguous, unaligned segment [starts[t], starts[t] + counts[t]) of the
sorted slab. This path is the only one that computes the per-pixel
contribution counts ``n_contrib``.

* `_build_inst` builds the (NROWS, R + CHUNK) instance slab: rows x, y, A,
  B, C, opacity, r, g, b and zeros, gathered in depth order when ``perm``
  is given; every lane at or past the live high-water mark is zero.
* `composite_tile_fwd` composites it per tile, with the optional
  ``n_contrib``. On a CUDA tensor it launches `csrc/composite_tile_fwd.cu`
  (which replaces `pallas_raster.py::_fwd_kernel`) and counts the launch in
  ``composite_tile_fwd.launches``; on a CPU tensor it runs the plain
  PyTorch version `composite_tile_fwd_plain`.
* `composite_tile_bwd` is its backward, nine gradient rows per instance
  lane (`csrc/composite_tile_bwd.cu`, replacing `_bwd_kernel`), and
  `composite_tile_bwd_fused` the backward with the instance → Gaussian
  reduction fused in (the second kernel of `csrc/composite_tile_bwd.cu`,
  replacing `_bwd_kernel_fused`; atomics into a (P, 16) table, so its
  summation order varies from run to run), each with its plain version
  beside it.
* `_scatter_reduce` (the live-bound scatter) and `gather_reduce_rows` (the
  blocked gather reduction over survivor ranks) reduce instance rows to
  Gaussian rows deterministically.
* `composite_instances` is the JAX custom-VJP function as a
  `torch.autograd.Function` with the JAX routing of the backward (fused
  kernel, gather reduction or scatter reduction), then the ``inv_perm``
  gather. As in the JAX package, ``bg`` gets a zero gradient; ``final_T``
  and ``n_contrib`` are marked non-differentiable.

Kernels #3, #4 and #5 run the segmented kernels' walk
(`csrc/composite_seg_walk.cuh`) from their tiles' origins and unaligned
segment starts; #4 writes its rows at their lanes, #5 adds them into a
table row per id. The plain versions share the walk's plain PyTorch form
(`composite_seg._walk_fwd_plain` / `_walk_bwd_plain`): one instance at a
time with the kernels' operations in their order and the backward's pixel
sums in the kernels' warp tree, so #3 (``n_contrib`` included) and #4
equal them bit for bit; #5 adds its rows with atomics, in no fixed order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops.composite_seg import (
    CHUNK,
    NGRAD,
    NROWS,
    PX,
    _reduce_rows,
    _walk_bwd_plain,
    _walk_fwd_plain,
)
from omnigs_torch.ops.preprocess import TILE

# the fused backward's per-Gaussian table limit: the JAX routing rule
# (the TPU kernel kept the table in on-chip memory), kept so that the fused
# route runs exactly where the reference takes it
FUSED_REDUCE_MAX_P = 160 * 1024
# columns of the fused kernel's per-Gaussian table (`pallas_raster.py:774`
# keeps a (P, 16) table too): 16-byte-aligned rows for vector atomics
FUSED_TABLE_COLS = 16

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# omnigs_composite_tile_fwd(inst, rpad, starts, counts, x0, y0, num_tiles,
#                           want_ncontrib, color, final_t, ncontrib, device,
#                           stream)
_FWD_ARGTYPES = [_VP, _I64, _VP, _VP, _VP, _VP, _I32, _I32, _VP, _VP, _VP, _I32, _VP]
# omnigs_composite_tile_bwd(inst, rpad, starts, counts, x0, y0, color_full,
#                           dcolor, num_tiles, dinst, device, stream)
_BWD_ARGTYPES = [_VP, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _VP, _I32, _VP]
# omnigs_composite_tile_bwd_fused(inst, rpad, ids, n_ids, starts, counts, x0,
#                                 y0, color_full, dcolor, num_tiles, p, table,
#                                 device, stream)
_FUSED_ARGTYPES = [
    _VP, _I64, _VP, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _VP, _I32, _VP
]

# the gather reduction: lanes per chunk of the JAX live-bound loop, rows per
# numerics block, and the bound below which survivor ranks are live
_CH_G = 1 << 16
_SB = 128
_E_LIVE = 1 << 29


def tile_origins(gx: int, gy: int, device=None, tile_lo: int = 0, n_tiles=None):
    """(x0, y0) int32 pixel origins of the tiles [tile_lo, tile_lo +
    n_tiles) of the row-major gx·gy grid (all of it by default)."""
    n = gx * gy if n_tiles is None else n_tiles
    t = tile_lo + torch.arange(n, dtype=torch.int32, device=device)
    return (t % gx) * TILE, (t // gx) * TILE


def _build_inst(
    means2d: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity: torch.Tensor,
    sorted_g: torch.Tensor,
    live: torch.Tensor,
    perm: Optional[torch.Tensor],
) -> torch.Tensor:
    """(NROWS, R + CHUNK) slab: one column gather of the per-Gaussian rows
    (in depth order when ``perm`` is given). Lanes at or past ``live`` (the
    high-water mark max(starts + counts)) and the CHUNK tail lanes gather a
    zero sentinel column, where the JAX function's live-bound loop leaves
    zeros or gathers rows no kernel reads."""
    p = opacity.shape[0]
    rows = torch.cat(
        [
            means2d.T,
            conic.T,
            opacity[None, :],
            rgb.T,
            torch.zeros(NROWS - 9, p, dtype=means2d.dtype, device=means2d.device),
        ]
    )
    if perm is not None:
        rows = rows[:, perm.to(torch.int64)]
    rows = torch.cat([rows, torch.zeros_like(rows[:, :1])], dim=1)
    lane = torch.arange(sorted_g.shape[0], device=sorted_g.device)
    idx = torch.where(lane < live, sorted_g.to(torch.int64), p)
    idx = torch.cat([idx, idx.new_full((CHUNK,), p)])
    return rows.index_select(1, idx)


def _tile_pixels(x0: torch.Tensor, y0: torch.Tensor):
    """(T, PX) f32 absolute pixel coordinates: x0 + p % TILE, y0 + p // TILE
    in integers, converted once (so dx = x − px rounds once)."""
    p = torch.arange(PX, device=x0.device, dtype=torch.int32)
    px = x0.to(torch.int32)[:, None] + (p % TILE)[None, :]
    py = y0.to(torch.int32)[:, None] + (p // TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def composite_tile_fwd_plain(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    num_tiles: int,
    want_ncontrib: bool = True,
    warp_gate: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the tile-major forward kernel: the kernels'
    walk (`composite_seg._walk_fwd_plain`, which also fills ``warp_gate``)
    at the tiles' pixels. Returns (color (T, 3, PX), final_T (T, PX),
    n_contrib (T, PX) int32, n_used, n_live): the last two (T, PX) int32
    counts of the work each pixel needs — the instances it visits up to its
    transmittance stop, and of those the live ones it composites.
    """
    del num_tiles  # = len(counts)
    px, py = _tile_pixels(x0, y0)
    return _walk_fwd_plain(inst_T, starts, counts, px, py, want_ncontrib, warp_gate)


def _check_inputs(inst_T, starts, counts, x0, y0, num_tiles):
    dev = inst_T.device
    if inst_T.dtype != torch.float32 or inst_T.ndim != 2 or inst_T.shape[0] != NROWS:
        raise ValueError(f"inst_T must be ({NROWS}, R) float32, got "
                         f"{tuple(inst_T.shape)} {inst_T.dtype}")
    if not inst_T.is_contiguous():
        raise ValueError("inst_T must be contiguous")
    for name, t in (("starts", starts), ("counts", counts), ("x0", x0), ("y0", y0)):
        if t.dtype != torch.int32 or t.shape != (num_tiles,) or t.device != dev:
            raise ValueError(f"{name} must be ({num_tiles},) int32 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_pixels(inst_T, num_tiles, **planes):
    for name, t in planes.items():
        if (
            t.dtype != torch.float32
            or t.shape != (num_tiles, 3, PX)
            or t.device != inst_T.device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{name} must be contiguous ({num_tiles}, 3, {PX}) float32 on "
                f"{inst_T.device}, got {tuple(t.shape)} {t.dtype} {t.device}"
            )


def _cuda_only(inst_T, what):
    if inst_T.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {inst_T.device}")


def composite_tile_fwd(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    num_tiles: int,
    want_ncontrib: bool = True,
):
    """Tile-major forward → (color (T, 3, PX), final_T (T, PX), n_contrib
    (T, PX) int32).

    Same contract as `omnigs_tpu.ops.pallas_raster.composite_pallas_fwd`:
    tile t composites slab lanes [starts[t], starts[t] + counts[t]) of
    ``inst_T`` (NROWS, R) f32 in order over its pixels at (x0[t] + p % 16,
    y0[t] + p // 16); color excludes the background; empty tiles give color
    0 and final_T 1. n_contrib is, per pixel, the last k + 1 at which it
    composited a live instance (k within the segment), or zeros when
    ``want_ncontrib`` is False.
    """
    if inst_T.device.type == "cpu":
        return composite_tile_fwd_plain(
            inst_T, starts, counts, x0, y0, num_tiles, want_ncontrib
        )[:3]
    _cuda_only(inst_T, "composite_tile_fwd")
    _check_inputs(inst_T, starts, counts, x0, y0, num_tiles)
    dev = inst_T.device
    color = torch.empty(num_tiles, 3, PX, dtype=torch.float32, device=dev)
    final_t = torch.empty(num_tiles, PX, dtype=torch.float32, device=dev)
    ncontrib = torch.empty(num_tiles, PX, dtype=torch.int32, device=dev)
    if num_tiles == 0:
        return color, final_t, ncontrib
    lib, fn = cuda_build.launcher(
        "composite_tile_fwd", "composite_tile_fwd", _FWD_ARGTYPES
    )
    err = fn(
        inst_T.data_ptr(), inst_T.shape[1], starts.data_ptr(), counts.data_ptr(),
        x0.data_ptr(), y0.data_ptr(), num_tiles, int(bool(want_ncontrib)),
        color.data_ptr(), final_t.data_ptr(), ncontrib.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "composite_tile_fwd launch")
    composite_tile_fwd.launches += 1
    return color, final_t, ncontrib


composite_tile_fwd.launches = 0


def composite_tile_bwd_plain(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
    num_tiles: int,
) -> torch.Tensor:
    """Plain PyTorch version of the tile-major backward kernel: the
    kernels' walk (`composite_seg._walk_bwd_plain`) at the tiles' pixels,
    written into a zero (NROWS, R) array (see `composite_tile_bwd`).
    """
    del num_tiles  # = len(counts)
    px, py = _tile_pixels(x0, y0)
    return _walk_bwd_plain(inst_T, starts, counts, px, py, color_full, dcolor)


def composite_tile_bwd(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
    num_tiles: int,
) -> torch.Tensor:
    """Tile-major backward → (NROWS, R) per-instance gradient rows.

    Same contract as `omnigs_tpu.ops.pallas_raster.composite_pallas_bwd`
    after its merge of the per-tile heads: for every lane of tile t's
    segment, rows 0..8 hold dL/d(x, y, A, B, C, opacity, r, g, b) of that
    instance, given ``color_full`` (T, 3, PX), the forward color with
    ``bg·final_T`` blended in, and ``dcolor`` = dL/dcolor_full; every other
    lane and row is 0. The segments are disjoint, so the kernel writes each
    lane from one block: no atomics, deterministic.
    """
    if inst_T.device.type == "cpu":
        return composite_tile_bwd_plain(
            inst_T, starts, counts, x0, y0, color_full, dcolor, num_tiles
        )
    _cuda_only(inst_T, "composite_tile_bwd")
    _check_inputs(inst_T, starts, counts, x0, y0, num_tiles)
    _check_pixels(inst_T, num_tiles, color_full=color_full, dcolor=dcolor)
    dinst = torch.zeros_like(inst_T)
    if num_tiles == 0:
        return dinst
    lib, fn = cuda_build.launcher(
        "composite_tile_bwd", "composite_tile_bwd", _BWD_ARGTYPES
    )
    dev = inst_T.device
    err = fn(
        inst_T.data_ptr(), inst_T.shape[1], starts.data_ptr(), counts.data_ptr(),
        x0.data_ptr(), y0.data_ptr(), color_full.data_ptr(), dcolor.data_ptr(),
        num_tiles, dinst.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "composite_tile_bwd launch")
    composite_tile_bwd.launches += 1
    return dinst


composite_tile_bwd.launches = 0


def composite_tile_bwd_fused_plain(
    inst_T: torch.Tensor,
    ids: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
    num_tiles: int,
    num_gaussians: int,
) -> torch.Tensor:
    """Plain version of the fused backward: the plain backward, then the
    deterministic live-bound scatter reduction by ``ids``."""
    dinst = composite_tile_bwd_plain(
        inst_T, starts, counts, x0, y0, color_full, dcolor, num_tiles
    )
    return _scatter_reduce(dinst, ids, torch.amax(starts + counts), num_gaussians)


def composite_tile_bwd_fused(
    inst_T: torch.Tensor,
    ids: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
    num_tiles: int,
    num_gaussians: int,
) -> torch.Tensor:
    """Fused-reduce backward → (P, 9) gradient rows per id.

    Same contract as `omnigs_tpu.ops.pallas_raster.composite_pallas_bwd_fused`:
    the rows of `composite_tile_bwd`, summed per ``ids[lane]`` (the depth
    rank under a depth presort) over every lane of every segment. The
    kernel adds each instance's rows with float atomics into a zeroed (P,
    FUSED_TABLE_COLS) table, whose 64-byte rows take float4 atomics, as the
    JAX wrapper's table is (P, 16); the result is the view of its first
    nine columns (the backward's consumers, a gather by ``inv_perm`` and
    column slices, take it as it is). The order of the additions, and the
    last bits of the sums, vary from run to run.
    """
    if inst_T.device.type == "cpu":
        return composite_tile_bwd_fused_plain(
            inst_T, ids, starts, counts, x0, y0, color_full, dcolor, num_tiles,
            num_gaussians,
        )
    _cuda_only(inst_T, "composite_tile_bwd_fused")
    _check_inputs(inst_T, starts, counts, x0, y0, num_tiles)
    _check_pixels(inst_T, num_tiles, color_full=color_full, dcolor=dcolor)
    dev = inst_T.device
    if (
        ids.dtype != torch.int32 or ids.ndim != 1 or ids.device != dev
        or ids.shape[0] > inst_T.shape[1] or not ids.is_contiguous()
    ):
        raise ValueError(f"ids must be contiguous (R,) int32 on {dev}, "
                         f"R ≤ {inst_T.shape[1]}")
    table = torch.zeros(
        num_gaussians, FUSED_TABLE_COLS, dtype=torch.float32, device=dev
    )
    if num_tiles == 0:
        return table[:, :NGRAD]
    lib, fn = cuda_build.launcher(
        "composite_tile_bwd", "composite_tile_bwd_fused", _FUSED_ARGTYPES
    )
    err = fn(
        inst_T.data_ptr(), inst_T.shape[1], ids.data_ptr(), ids.shape[0],
        starts.data_ptr(), counts.data_ptr(), x0.data_ptr(), y0.data_ptr(),
        color_full.data_ptr(), dcolor.data_ptr(), num_tiles, num_gaussians,
        table.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "composite_tile_bwd_fused launch")
    composite_tile_bwd_fused.launches += 1
    return table[:, :NGRAD]


composite_tile_bwd_fused.launches = 0


def _scatter_reduce(
    dinst: torch.Tensor, sorted_g: torch.Tensor, live: torch.Tensor, p: int
) -> torch.Tensor:
    """The live-bound scatter reduction: Σ of the nine gradient rows of the
    lanes below ``live`` (= max(starts + counts)) per ``sorted_g`` →
    (p, NGRAD), deterministic (`composite_seg._reduce_rows`). The lanes at
    or past ``live`` (rank 0 in the packed binning's dead slots, millions
    of them) go to the discarded rows, as the JAX loop never visits them."""
    r = sorted_g.shape[0]
    lane = torch.arange(r, device=sorted_g.device)
    ids = torch.where(lane < live, sorted_g, p)
    return _reduce_rows(dinst[:, :r], ids, p)


def gather_reduce_rows(
    rows: torch.Tensor,
    sorted_e: torch.Tensor,
    seg_lo: torch.Tensor,
    seg_hi: torch.Tensor,
) -> torch.Tensor:
    """Deterministic gather-based instance → Gaussian gradient reduction
    (`pallas_raster.gather_reduce_rows`) → (P, 9).

    ``sorted_e`` maps slab position → survivor rank (E_SENTINEL where
    none); one sort inverts it, the rows are gathered into survivor-rank
    order, where each Gaussian's survivors [seg_lo, seg_hi) are contiguous,
    and summed per segment. Never with one global f32 cumsum, whose
    segment differences of huge prefixes lose ~5e-2 relative on the conic
    rows at full scale: rows are prefix-summed only within 128-row blocks,
    every block inside one segment adds its total to the owner, and the
    partial blocks at a segment's ends add their local prefixes. ``rows``
    may be shorter than ``sorted_e`` (a trimmed slab): the missing lanes
    read zeros.
    """
    r = rows.shape[0]
    r_slab = sorted_e.shape[0]
    dev = rows.device
    # unstable: live ranks are unique, so only sentinel positions may
    # differ from the JAX sort, and those lie past every segment
    se, slabpos = torch.sort(sorted_e)
    rows_pad = torch.cat([rows, rows.new_zeros(r_slab - r + 1, rows.shape[1])])
    grows = rows_pad[torch.clamp_max(slabpos, r_slab)]
    n_full = r_slab // _CH_G
    if n_full * _CH_G != r_slab or n_full <= 1:
        # ragged caps (small slabs): one cumsum, small prefixes
        cs = torch.cat([rows.new_zeros(1, rows.shape[1]), torch.cumsum(grows, dim=0)])
        return cs[seg_hi.to(torch.int64)] - cs[seg_lo.to(torch.int64)]
    # number of live survivor ranks (sentinels sort after all of them); the
    # JAX loop fills whole 2^16-row chunks up to it and leaves zeros after
    live = torch.searchsorted(se, se.new_full((1,), _E_LIVE))
    bound = torch.clamp_max((live + _CH_G - 1) // _CH_G, n_full) * _CH_G
    pos = torch.arange(r_slab, device=dev)
    grows = torch.where((pos < bound)[:, None], grows, 0.0)
    nb = r_slab // _SB
    g3 = grows.reshape(nb, _SB, -1)
    cs3 = torch.cumsum(g3, dim=1)
    L = (cs3 - g3).reshape(r_slab, -1)  # exclusive in-block prefixes
    tot = cs3[:, _SB - 1]  # (nb, 9) block totals
    L_pad = torch.cat([L, L.new_zeros(1, L.shape[1])])

    # blocks fully inside one segment add their totals to the owner
    # (segments tile rank space in Gaussian order: seg_lo is
    # non-decreasing, and the block must also END inside the owner's
    # segment — the last segment has no successor to bound its tail)
    p = seg_lo.shape[0]
    seg_lo = seg_lo.contiguous()
    bstart = torch.arange(nb, dtype=seg_lo.dtype, device=dev) * _SB
    gs = torch.searchsorted(seg_lo, bstart, right=True) - 1
    ge = torch.searchsorted(seg_lo, bstart + (_SB - 1), right=True) - 1
    owner = torch.where(
        (gs == ge) & (gs >= 0) & (bstart + _SB <= seg_hi[torch.clamp(gs, 0, p - 1)]),
        gs,
        p,
    )
    # deterministic; the unowned blocks (owner p) go to discarded rows
    mid = _reduce_rows(tot.T, owner, p)

    # partial-block head and tail pieces (≤ 127-row local prefixes each)
    lo, hi = seg_lo.to(torch.int64), seg_hi.to(torch.int64)
    bl, bh = lo // _SB, hi // _SB
    Llo, Lhi = L_pad[lo], L_pad[hi]
    head = torch.where(
        ((lo % _SB) != 0)[:, None], tot[torch.clamp_max(bl, nb - 1)] - Llo, 0.0
    )
    return torch.where((bl == bh)[:, None], Lhi - Llo, head + mid + Lhi)


class _CompositeInstances(torch.autograd.Function):
    """Slab build + forward kernel + background blend, with the JAX
    ``_ci_bwd`` routing of the backward. The slab build sits inside the
    Function, so autograd never differentiates its gathers."""

    @staticmethod
    def forward(
        ctx, means2d, conic, rgb, opacity, bg, sorted_g, starts, counts, x0, y0,
        sorted_e, seg_lo, seg_hi, perm, inv_perm, num_tiles, want_ncontrib,
        fused_reduce,
    ):
        live = torch.amax(starts + counts)
        inst_T = _build_inst(means2d, conic, rgb, opacity, sorted_g, live, perm)
        color, final_t, ncontrib = composite_tile_fwd(
            inst_T, starts, counts, x0, y0, num_tiles, want_ncontrib
        )
        color_full = color + final_t[:, None, :] * bg[None, :, None]
        ctx.save_for_backward(
            inst_T, color_full, sorted_g, starts, counts, x0, y0, live,
            sorted_e, seg_lo, seg_hi, inv_perm,
        )
        ctx.geometry = (opacity.shape[0], num_tiles, fused_reduce, bg.shape)
        ctx.mark_non_differentiable(final_t, ncontrib)
        return color_full, final_t, ncontrib

    @staticmethod
    def backward(ctx, dcolor, _dfinal_t, _dncontrib):
        (
            inst_T, color_full, sorted_g, starts, counts, x0, y0, live,
            sorted_e, seg_lo, seg_hi, inv_perm,
        ) = ctx.saved_tensors
        p, num_tiles, fused_reduce, bg_shape = ctx.geometry
        dcolor = dcolor.contiguous()
        if fused_reduce and sorted_e is None and p <= FUSED_REDUCE_MAX_P:
            # per-Gaussian rows straight out of the kernel
            acc = composite_tile_bwd_fused(
                inst_T, sorted_g, starts, counts, x0, y0, color_full, dcolor,
                num_tiles, p,
            )
        else:
            dinst = composite_tile_bwd(
                inst_T, starts, counts, x0, y0, color_full, dcolor, num_tiles
            )
            if sorted_e is not None:
                rows = dinst[:NGRAD, : sorted_g.shape[0]].T
                acc = gather_reduce_rows(rows, sorted_e, seg_lo, seg_hi)
            else:
                acc = _scatter_reduce(dinst, sorted_g, live, p)
        if inv_perm is not None:
            acc = acc[inv_perm.to(torch.int64)]
        # bg's gradient is zeros, as in the JAX package (ROADMAP queue 3)
        dbg = color_full.new_zeros(bg_shape)
        return (
            acc[:, 0:2], acc[:, 2:5], acc[:, 6:9], acc[:, 5], dbg,
            *([None] * 13),
        )


def composite_instances(
    means2d: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity: torch.Tensor,
    bg: torch.Tensor,
    sorted_g: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    sorted_e: Optional[torch.Tensor],
    seg_lo: Optional[torch.Tensor],
    seg_hi: Optional[torch.Tensor],
    perm: Optional[torch.Tensor],
    inv_perm: Optional[torch.Tensor],
    num_tiles: int,
    want_ncontrib: bool = True,
    fused_reduce: bool = False,
):
    """Tile-major compositing of the compact slab → (color (T, 3, PX) with
    the background blended in, final_T (T, PX), n_contrib (T, PX) int32 —
    zeros when ``want_ncontrib`` is False).

    Differentiable in ``means2d``, ``conic``, ``rgb`` and ``opacity`` (and
    ``bg``, whose gradient is zeros as in the JAX package). The backward
    routes as the JAX one: the fused kernel when ``fused_reduce``, no
    emission payload and P ≤ FUSED_REDUCE_MAX_P; else the backward kernel
    and the gather reduction over ``sorted_e`` / ``seg_lo`` / ``seg_hi``
    when given, the live-bound scatter reduction otherwise. ``perm`` maps
    depth ranks to Gaussians and ``inv_perm`` back.
    """
    return _CompositeInstances.apply(
        means2d, conic, rgb, opacity, bg, sorted_g, starts, counts, x0, y0,
        sorted_e, seg_lo, seg_hi, perm, inv_perm, num_tiles, want_ncontrib,
        fused_reduce,
    )
