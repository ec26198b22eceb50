"""Segmented compositing: the counterpart of `omnigs_tpu/ops/pallas_seg.py`.

* `_build_inst_seg` builds the (NROWS, R8) instance slab of the 8-granular
  layout (`binning.segment_relay`): rows x, y, A, B, C, opacity, r, g, b,
  the two window ride rows (dense tile index, tile id) the TPU kernel reads,
  and zeros; pad lanes gather an all-zero sentinel row (α = 0, dead).
* `composite_seg_fwd` composites it per tile. On a CUDA tensor it launches
  the hand-written Hopper kernel `csrc/composite_seg_fwd.cu` (which
  replaces the TPU kernel `pallas_seg.py::_fwd_seg_kernel`) and counts the
  launch in ``composite_seg_fwd.launches``; on a CPU tensor it runs the
  plain PyTorch version `composite_seg_fwd_plain`, which computes the same
  function with the same operation order.
* `_walk_fwd_plain` / `_walk_bwd_plain` are the per-tile walk of the
  compositing kernels in plain PyTorch, one instance at a time, with their
  operations in their order (the backward's pixel sums in the kernels'
  tree, `_pixel_sum`), so each kernel equals its plain version bit for
  bit; the segmented and the tile-major (`composite_tile.py`) plain
  versions both run them, at their own pixel coordinates. The segmented
  kernels (`csrc/composite_seg_walk.cuh`) skip the instances that cannot
  be live in a warp's pixel rows; `_strip_masks` is that test in plain
  PyTorch.
* `composite_seg_bwd` is its backward: nine gradient rows per instance
  lane. On a CUDA tensor it launches `csrc/composite_seg_bwd.cu` (which
  replaces `pallas_seg.py::_bwd_seg_kernel`) and counts the launch in
  ``composite_seg_bwd.launches``; on a CPU tensor it runs
  `composite_seg_bwd_plain`.
* `composite_instances_seg` is the JAX custom-VJP function as a
  `torch.autograd.Function` over slab build, compositing and background
  blend. Its backward is the bwd kernel, a deterministic reduction of the
  instance rows into Gaussian rows (`_reduce_rows`) and the ``inv_perm``
  gather. As in the JAX package, ``bg`` gets a zero gradient; ``final_T``
  and ``n_contrib`` are marked non-differentiable.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops.preprocess import TILE

PX = TILE * TILE  # 256 pixels per tile
NROWS = 16  # rows of the instance slab
CHUNK = 128  # lane granularity of the slab length (R8 % CHUNK == 0)
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1.0e-4
_SEG_ROW = 9  # per-lane dense tile index (f32, exact < 2^24)
_TID_ROW = 10  # per-lane tile id (f32)

NGRAD = 9  # gradient rows per instance: x, y, A, B, C, opacity, r, g, b
NWARP, WARP = 8, 32  # a tile's 256 pixels as the kernels' warps of 32 lanes

# the strip test of `csrc/composite_seg_walk.cuh` (`strip_mask`), whose
# slack the comment there derives; pixel rows per warp strip of the forward
# (two pixel rows per thread) and of the backward kernel
CULL_REL = 16.0 * 2.0**-24
CULL_ABS = 1e-4
TAU_FLOOR = -1e-5
CULL_PAD = 1e-6
LOG_ALPHA_MIN = -5.541263580322266  # logf of the float32 ALPHA_MIN
FWD_STRIP, BWD_STRIP = 4, 2

_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# omnigs_composite_seg_fwd(inst, r8, starts8, counts, num_tiles, gx,
#                          tile_lo, color, final_t, device, stream)
_LAUNCH_ARGTYPES = [
    _VP, ctypes.c_longlong, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _I32, _VP
]
# omnigs_composite_seg_bwd(inst, r8, starts8, counts, color_full, dcolor,
#                          num_tiles, gx, tile_lo, dinst, device, stream)
_BWD_ARGTYPES = [
    _VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP, _I32,
    _VP,
]

# discarded accumulator rows that take the pad lanes in `_reduce_rows`
_PAD_ROWS = 1 << 14


def _build_inst_seg(
    means2d: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity: torch.Tensor,
    sorted_g8: torch.Tensor,
    perm: Optional[torch.Tensor],
    ride_d: torch.Tensor,
    ride_t: torch.Tensor,
) -> torch.Tensor:
    """(NROWS, R8) slab: one column gather of the per-Gaussian rows (in
    depth order when ``perm`` is given) with a zero sentinel column P for
    the pad lanes (``sorted_g8 == P``), plus the two ride rows."""
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
    idx = torch.clamp_max(sorted_g8, p).to(torch.int64)
    slab = rows.index_select(1, idx)
    slab[_SEG_ROW] = ride_d.to(slab.dtype)
    slab[_TID_ROW] = ride_t.to(slab.dtype)
    return slab


def _pixel_coords(num_tiles: int, gx: int, tile_lo: int, device):
    """(T, PX) integer pixel coordinates (as f32) of each tile's pixels."""
    gid = torch.arange(num_tiles, device=device) + tile_lo
    p = torch.arange(PX, device=device)
    px = (gid % gx)[:, None] * TILE + (p % TILE)[None, :]
    py = (gid // gx)[:, None] * TILE + (p // TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


# the plain walks check every this many instances whether all pixels have
# stopped (a host read), and end the walk early if so
_PLAIN_CHECK = 32


def _gather_step(inst_T, starts, counts, k):
    """Instance k of every tile's segment: (lane_ok (T,), idx (T,), the
    nine rows (9, T, 1))."""
    lane_ok = k < counts
    idx = torch.where(lane_ok, starts.to(torch.int64) + k, 0)
    return lane_ok, idx, inst_T[:NGRAD, idx][:, :, None]


def _warp_bits(gate: torch.Tensor) -> torch.Tensor:
    """(T, PX) bool → (T,) int32: bit w set where warp w (pixels 32w ..
    32w + 31, i.e. pixel rows 2w and 2w + 1) has a True pixel."""
    hit = gate.reshape(gate.shape[0], NWARP, WARP).any(dim=2).to(torch.int32)
    return (hit << torch.arange(NWARP, device=gate.device, dtype=torch.int32)).sum(
        dim=1, dtype=torch.int32
    )


def _walk_fwd_plain(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    want_ncontrib: bool,
    warp_gate: Optional[torch.Tensor] = None,
):
    """The kernels' forward walk (`csrc/composite.cuh`) in plain PyTorch:
    every tile's segment [starts, starts + counts) of ``inst_T`` one
    instance at a time, all tiles and pixels (at ``px``, ``py`` (T, PX))
    at once, with the kernels' per-pair operations in their order
    (sequential log-transmittance), so the stop decisions equal the
    kernels'. Returns (color (T, 3, PX), final_T (T, PX), n_contrib (T, PX)
    int32 — zeros unless ``want_ncontrib`` —, n_used, n_live): the last two
    (T, PX) int32 counts of the work each pixel needs, the instances it
    visits up to its transmittance stop and of those the live ones it
    composites. ``warp_gate``, an (R,) int32 zero tensor if given, gets at
    each visited lane the `_warp_bits` of the pixels that composite it."""
    dev = inst_T.device
    num_tiles = counts.shape[0]
    s = torch.zeros(num_tiles, PX, device=dev)  # log-T before the next instance
    color = torch.zeros(num_tiles, 3, PX, device=dev)
    ncontrib = torch.zeros(num_tiles, PX, dtype=torch.int32, device=dev)
    done = torch.zeros(num_tiles, PX, dtype=torch.bool, device=dev)
    n_used = counts[:, None].expand(-1, PX).clone()
    n_live = torch.zeros_like(n_used)
    k_max = int(counts.max()) if num_tiles else 0
    for k in range(k_max):
        if k % _PLAIN_CHECK == 0 and k and bool((done | (k >= counts)[:, None]).all()):
            break
        lane_ok, idx, d = _gather_step(inst_T, starts, counts, k)
        dx = d[0] - px
        dy = d[1] - py
        power = -0.5 * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy
        alpha = torch.clamp_max(d[5] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
        live = lane_ok[:, None] & ~done & (power <= 0.0) & (alpha >= ALPHA_MIN)
        l = torch.log1p(-alpha)
        n_excl = torch.exp(s)
        ok = n_excl * (1.0 - alpha) >= T_STOP
        gate = live & ok
        stop = live & ~ok
        if warp_gate is not None:
            warp_gate[idx[lane_ok]] = _warp_bits(gate)[lane_ok]
        n_used = torch.where(stop, k + 1, n_used)
        done = done | stop
        w = alpha * n_excl
        for c in range(3):
            color[:, c] = torch.where(gate, color[:, c] + d[6 + c] * w, color[:, c])
        s = torch.where(gate, s + l, s)
        n_live += gate.to(n_live.dtype)
        if want_ncontrib:
            ncontrib = torch.where(gate, k + 1, ncontrib).to(torch.int32)
    return color, torch.exp(s), ncontrib, n_used, n_live


def composite_seg_fwd_plain(
    inst_T8: torch.Tensor,
    starts8: torch.Tensor,
    counts: torch.Tensor,
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
    warp_gate: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the segmented forward kernel: the kernels'
    walk (`_walk_fwd_plain`, which also fills ``warp_gate``) at the tiles'
    pixels. Returns (color (T, 3, PX), finalT (T, PX), n_used, n_live), the
    last two (T, PX) int32 counts of the work each pixel needs: the
    instances it visits before its transmittance stop (what the kernel's
    early exit leaves) and, of those, the live ones it composites.
    """
    px, py = _pixel_coords(num_tiles, gx, tile_lo, inst_T8.device)
    color, final_t, _, n_used, n_live = _walk_fwd_plain(
        inst_T8, starts8, counts, px, py, False, warp_gate
    )
    return color, final_t, n_used, n_live


def composite_seg_fwd(
    inst_T8: torch.Tensor,
    starts8: torch.Tensor,
    counts: torch.Tensor,
    live8: torch.Tensor,
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
):
    """Segmented forward → (color (T, 3, PX), finalT (T, PX)).

    Same contract as `omnigs_tpu.ops.pallas_seg.composite_seg_fwd`: tile t
    composites slab lanes [starts8[t], starts8[t] + counts[t]) of
    ``inst_T8`` (NROWS, R8) f32 in order; color excludes the background;
    empty tiles give color 0 and finalT 1. ``tile_lo`` offsets the tile ids
    (pixel coordinates) of a tile window. ``live8`` (the slab high-water
    mark) is part of that contract; segments are read by ``counts``.
    """
    del live8
    if inst_T8.device.type == "cpu":
        color, final_t, _, _ = composite_seg_fwd_plain(
            inst_T8, starts8, counts, num_tiles, gx, tile_lo
        )
        return color, final_t
    if inst_T8.device.type != "cuda":
        raise ValueError(f"composite_seg_fwd: unsupported device {inst_T8.device}")
    _check_inputs(inst_T8, starts8, counts, num_tiles)
    color = torch.empty(num_tiles, 3, PX, dtype=torch.float32, device=inst_T8.device)
    final_t = torch.empty(num_tiles, PX, dtype=torch.float32, device=inst_T8.device)
    if num_tiles == 0:
        return color, final_t
    lib, fn = cuda_build.launcher(
        "composite_seg_fwd", "composite_seg_fwd", _LAUNCH_ARGTYPES
    )
    err = fn(
        inst_T8.data_ptr(), inst_T8.shape[1], starts8.data_ptr(),
        counts.data_ptr(), num_tiles, gx, tile_lo, color.data_ptr(),
        final_t.data_ptr(), inst_T8.device.index,
        torch.cuda.current_stream(inst_T8.device).cuda_stream,
    )
    cuda_build.check(lib, err, "composite_seg_fwd launch")
    composite_seg_fwd.launches += 1
    return color, final_t


composite_seg_fwd.launches = 0


def _check_inputs(inst_T8, starts8, counts, num_tiles):
    dev = inst_T8.device
    if inst_T8.dtype != torch.float32 or inst_T8.ndim != 2 or inst_T8.shape[0] != NROWS:
        raise ValueError(f"inst_T8 must be ({NROWS}, R8) float32, got "
                         f"{tuple(inst_T8.shape)} {inst_T8.dtype}")
    if not inst_T8.is_contiguous():
        raise ValueError("inst_T8 must be contiguous")
    for name, t in (("starts8", starts8), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (num_tiles,) or t.device != dev:
            raise ValueError(f"{name} must be ({num_tiles},) int32 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _pixel_sum(t: torch.Tensor) -> torch.Tensor:
    """(..., PX) → (...): the kernels' sum over a tile's pixels. Per warp
    of 32 pixels the butterfly's tree (halves at 16, 8, 4, 2, 1, lane i
    plus lane i + half), then the eight warp sums added left to right."""
    v = t.reshape(*t.shape[:-1], NWARP, WARP)
    half = WARP // 2
    while half:
        v = v[..., :half] + v[..., half : 2 * half]
        half //= 2
    acc = v[..., 0, 0]
    for w in range(1, NWARP):
        acc = acc + v[..., w, 0]
    return acc


def _strip_masks(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    gx: int,
    tile_lo: int,
    strip_rows: int,
) -> torch.Tensor:
    """The segmented kernels' staging test (`csrc/composite_seg_walk.cuh`,
    `strip_mask`: the same float32 operations and slack, where only the
    logarithm may round apart) → (R,) int32: at each segment lane, bit s
    set where pixel rows [s·strip_rows, (s + 1)·strip_rows) of the lane's
    tile may hold a live pair (α ≥ 1/255, power ≤ 0) of its instance; 0
    elsewhere. A kernel warp skips an instance whose bit it lacks."""
    dev = inst_T.device
    counts64 = counts.to(torch.int64)
    tile_of = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts64)
    first = torch.cumsum(counts64, 0) - counts64
    lane = starts.to(torch.int64)[tile_of] + (
        torch.arange(tile_of.shape[0], device=dev) - first[tile_of]
    )
    d = inst_T[:6, lane]
    finite = torch.isfinite(d).all(dim=0)
    x, y, a, b, c, op = d
    gid = tile_of + tile_lo
    tx0 = ((gid % gx) * TILE).to(torch.float32)
    ty0 = ((gid // gx) * TILE).to(torch.float32)
    tau = 2.0 * (torch.log(op) - LOG_ALPHA_MIN)
    det = (a.double() * c.double() - b.double() * b.double()).float()
    eps = CULL_REL * ((a + c) * (a + c) / det)
    t = (torch.clamp_min(tau, 0.0) + CULL_ABS) / (1.0 - eps)
    hx = torch.sqrt(t * c / det) * (1.0 + CULL_PAD) + 1.0
    hy = torch.sqrt(t * a / det) * (1.0 + CULL_PAD) + 1.0
    zero = torch.zeros((), device=dev)
    gap_x = torch.maximum(torch.maximum(tx0 - x, x - (tx0 + (TILE - 1))), zero)
    in_x = ~(gap_x > hx)
    m = torch.zeros_like(tile_of, dtype=torch.int32)
    for s in range(TILE // strip_rows):
        lo = ty0 + s * strip_rows
        gap_y = torch.maximum(torch.maximum(lo - y, y - (lo + (strip_rows - 1))), zero)
        m |= (in_x & (gap_y <= hy)).to(torch.int32) << s
    every = (1 << (TILE // strip_rows)) - 1
    # the kernel's early returns, the first one checked applied last
    m = torch.where(~((a > 0) & (c > 0) & (det > 0)) | ~(eps < 0.5), every, m)
    m = torch.where(tau < TAU_FLOOR, 0, m)
    m = torch.where(~(op > 0), 0, m)
    m = torch.where(finite, m, every).to(torch.int32)
    out = torch.zeros(inst_T.shape[1], dtype=torch.int32, device=dev)
    out[lane] = m
    return out


def _walk_bwd_plain(
    inst_T: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
) -> torch.Tensor:
    """The kernels' backward walk (`csrc/composite.cuh`) in plain PyTorch:
    one instance at a time like `_walk_fwd_plain`, recomputing the
    forward's transmittances and stop decisions with the kernels' per-pair
    operations in their order; each instance's nine partials are summed
    over the tile's pixels in the kernels' order (`_pixel_sum`) and written
    at its lane of a zero array shaped like ``inst_T``."""
    dev = inst_T.device
    num_tiles = counts.shape[0]
    dinst = torch.zeros_like(inst_T)
    dlr, dlg, dlb = dcolor[:, 0], dcolor[:, 1], dcolor[:, 2]
    dl_cf = dlr * color_full[:, 0] + dlg * color_full[:, 1] + dlb * color_full[:, 2]
    s = torch.zeros(num_tiles, PX, device=dev)  # log-T before the next instance
    wu_acc = torch.zeros(num_tiles, PX, device=dev)  # Σ w·u so far
    done = torch.zeros(num_tiles, PX, dtype=torch.bool, device=dev)
    zero = torch.zeros((), device=dev)
    k_max = int(counts.max()) if num_tiles else 0
    for k in range(k_max):
        if k % _PLAIN_CHECK == 0 and k and bool((done | (k >= counts)[:, None]).all()):
            break
        lane_ok, idx, d = _gather_step(inst_T, starts, counts, k)
        dx = d[0] - px
        dy = d[1] - py
        power = -0.5 * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy
        gauss = torch.exp(torch.clamp_max(power, 0.0))
        op_g = d[5] * gauss
        alpha = torch.clamp_max(op_g, ALPHA_MAX)
        live = lane_ok[:, None] & ~done & (power <= 0.0) & (alpha >= ALPHA_MIN)
        l = torch.log1p(-alpha)
        n_excl = torch.exp(s)
        one_m = 1.0 - alpha
        ok = n_excl * one_m >= T_STOP
        gate = live & ok
        done = done | (live & ~ok)
        w = alpha * n_excl
        u = dlr * d[6] + dlg * d[7] + dlb * d[8]
        wu_acc = torch.where(gate, wu_acc + w * u, wu_acc)
        dl_da = n_excl * u - (dl_cf - wu_acc) / one_m
        v = dl_da * op_g  # the 0.99 clamp is ignored, as in the reference
        vdx, vdy = v * dx, v * dy
        partials = torch.stack(
            [vdx, vdy, vdx * dx, vdx * dy, vdy * dy, dl_da * gauss, dlr * w, dlg * w, dlb * w]
        )
        sums = _pixel_sum(torch.where(gate, partials, zero))  # over the pixels → (9, T)
        A, B, C = d[2, :, 0], d[3, :, 0], d[4, :, 0]
        rows = torch.stack(
            [
                -(A * sums[0] + B * sums[1]),
                -(C * sums[1] + B * sums[0]),
                -0.5 * sums[2],
                -sums[3],
                -0.5 * sums[4],
                *sums[5:],
            ]
        )
        dinst[:NGRAD, idx[lane_ok]] = rows[:, lane_ok]
        s = torch.where(gate, s + l, s)
    return dinst


def composite_seg_bwd_plain(
    inst_T8: torch.Tensor,
    starts8: torch.Tensor,
    counts: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the segmented backward kernel: the kernels'
    walk (`_walk_bwd_plain`) at the tiles' pixels, written into a zero
    (NROWS, R8) array (see `composite_seg_bwd`).
    """
    px, py = _pixel_coords(num_tiles, gx, tile_lo, inst_T8.device)
    return _walk_bwd_plain(inst_T8, starts8, counts, px, py, color_full, dcolor)


def composite_seg_bwd(
    inst_T8: torch.Tensor,
    starts8: torch.Tensor,
    counts: torch.Tensor,
    live8: torch.Tensor,
    color_full: torch.Tensor,
    dcolor: torch.Tensor,
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
) -> torch.Tensor:
    """Segmented backward → (NROWS, R8) per-instance gradient rows.

    Same contract as `omnigs_tpu.ops.pallas_seg.composite_seg_bwd`: for
    every instance lane of tile t's segment, rows 0..8 hold dL/d(x, y, A,
    B, C, opacity, r, g, b) of that instance, given ``color_full`` (T, 3,
    PX), the forward color with ``bg·final_T`` blended in, and ``dcolor``
    (T, 3, PX) = dL/dcolor_full; every other lane and row is 0.
    """
    del live8
    if inst_T8.device.type == "cpu":
        return composite_seg_bwd_plain(
            inst_T8, starts8, counts, color_full, dcolor, num_tiles, gx, tile_lo
        )
    if inst_T8.device.type != "cuda":
        raise ValueError(f"composite_seg_bwd: unsupported device {inst_T8.device}")
    _check_inputs(inst_T8, starts8, counts, num_tiles)
    for name, t in (("color_full", color_full), ("dcolor", dcolor)):
        if (
            t.dtype != torch.float32
            or t.shape != (num_tiles, 3, PX)
            or t.device != inst_T8.device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{name} must be contiguous ({num_tiles}, 3, {PX}) float32 on "
                f"{inst_T8.device}, got {tuple(t.shape)} {t.dtype} {t.device}"
            )
    dinst = torch.zeros_like(inst_T8)
    if num_tiles == 0:
        return dinst
    lib, fn = cuda_build.launcher(
        "composite_seg_bwd", "composite_seg_bwd", _BWD_ARGTYPES
    )
    err = fn(
        inst_T8.data_ptr(), inst_T8.shape[1], starts8.data_ptr(),
        counts.data_ptr(), color_full.data_ptr(), dcolor.data_ptr(),
        num_tiles, gx, tile_lo, dinst.data_ptr(), inst_T8.device.index,
        torch.cuda.current_stream(inst_T8.device).cuda_stream,
    )
    cuda_build.check(lib, err, "composite_seg_bwd launch")
    composite_seg_bwd.launches += 1
    return dinst


composite_seg_bwd.launches = 0


@contextlib.contextmanager
def _deterministic_algorithms():
    """Switch PyTorch's deterministic algorithms on, and restore after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _reduce_rows(dinst: torch.Tensor, sorted_g8: torch.Tensor, p: int) -> torch.Tensor:
    """Σ of the nine gradient rows over the lanes of each depth rank →
    (p, NGRAD). Pad lanes (``sorted_g8 == p``) are dropped, like the JAX
    scatter's ``mode="drop"``.

    Deterministic: with deterministic algorithms on, a CUDA ``index_put_``
    that accumulates sorts the indices and sums each index's lanes in a
    fixed order (no atomics), so two runs are bitwise equal. That sum walks
    each index's lanes serially, so the pad lanes (most of the slab past
    its live prefix) are spread over ``_PAD_ROWS`` discarded rows instead
    of forming one run of millions.
    """
    rows = dinst[:NGRAD].T  # (R8, NGRAD)
    lane = torch.arange(rows.shape[0], device=dinst.device)
    idx = torch.where(
        sorted_g8 < p, sorted_g8.to(torch.int64), p + lane % _PAD_ROWS
    )
    acc = torch.zeros(p + _PAD_ROWS, NGRAD, dtype=dinst.dtype, device=dinst.device)
    with _deterministic_algorithms():
        acc.index_put_((idx,), rows, accumulate=True)
    return acc[:p]


class _CompositeInstancesSeg(torch.autograd.Function):
    """Slab build + forward kernel + background blend, with the segmented
    backward (the JAX ``_ci_seg_fwd`` / ``_ci_seg_bwd`` pair). The slab
    build sits inside the Function, so autograd never differentiates its
    gathers."""

    @staticmethod
    def forward(
        ctx, means2d, conic, rgb, opacity, bg, sorted_g8, starts8, counts,
        live8, ride_d, ride_t, perm, inv_perm, num_tiles, gx, tile_lo,
    ):
        inst_T8 = _build_inst_seg(
            means2d, conic, rgb, opacity, sorted_g8, perm, ride_d, ride_t
        )
        color, final_t = composite_seg_fwd(
            inst_T8, starts8, counts, live8, num_tiles, gx, tile_lo
        )
        color_full = color + final_t[:, None, :] * bg[None, :, None]
        ncontrib = torch.zeros(
            num_tiles, PX, dtype=torch.int32, device=color.device
        )
        ctx.save_for_backward(
            inst_T8, color_full, sorted_g8, starts8, counts, live8, inv_perm
        )
        ctx.geometry = (opacity.shape[0], num_tiles, gx, tile_lo, bg.shape)
        ctx.mark_non_differentiable(final_t, ncontrib)
        return color_full, final_t, ncontrib

    @staticmethod
    def backward(ctx, dcolor, _dfinal_t, _dncontrib):
        inst_T8, color_full, sorted_g8, starts8, counts, live8, inv_perm = (
            ctx.saved_tensors
        )
        p, num_tiles, gx, tile_lo, bg_shape = ctx.geometry
        dinst = composite_seg_bwd(
            inst_T8, starts8, counts, live8, color_full, dcolor.contiguous(),
            num_tiles, gx, tile_lo,
        )
        acc = _reduce_rows(dinst, sorted_g8, p)
        if inv_perm is not None:
            acc = acc[inv_perm.to(torch.int64)]
        # bg's gradient is zeros, as in the JAX package (ROADMAP queue 3)
        dbg = color_full.new_zeros(bg_shape)
        return (
            acc[:, 0:2], acc[:, 2:5], acc[:, 6:9], acc[:, 5], dbg,
            None, None, None, None, None, None, None, None, None, None, None,
        )


def composite_instances_seg(
    means2d: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity: torch.Tensor,
    bg: torch.Tensor,
    sorted_g8: torch.Tensor,
    starts8: torch.Tensor,
    counts: torch.Tensor,
    live8: torch.Tensor,
    ride_d: torch.Tensor,
    ride_t: torch.Tensor,
    perm: Optional[torch.Tensor],
    inv_perm: Optional[torch.Tensor],
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
):
    """Segmented compositing of an 8-granular slab → (color (T, 3, PX) with
    the background blended in, finalT (T, PX), n_contrib zeros (T, PX)).

    Differentiable in ``means2d``, ``conic``, ``rgb`` and ``opacity`` (and
    ``bg``, whose gradient is zeros as in the JAX package). ``perm`` maps
    the slab's depth ranks to Gaussians and ``inv_perm`` back.
    """
    return _CompositeInstancesSeg.apply(
        means2d, conic, rgb, opacity, bg, sorted_g8, starts8, counts, live8,
        ride_d, ride_t, perm, inv_perm, num_tiles, gx, tile_lo,
    )
