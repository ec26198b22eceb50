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

# instances per step of the plain version's loop (bounds its temporaries
# at T × PX × _PLAIN_CHUNK floats)
_PLAIN_CHUNK = 32


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


def composite_seg_fwd_plain(
    inst_T8: torch.Tensor,
    starts8: torch.Tensor,
    counts: torch.Tensor,
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
):
    """Plain PyTorch version of the segmented forward kernel.

    Walks every tile's segment in steps of ``_PLAIN_CHUNK`` instances, all
    tiles and pixels at once, with the kernel's per-pair math. Returns
    (color (T, 3, PX), finalT (T, PX), n_used, n_live), the last two
    (T, PX) int32 counts of the work each pixel needs: the instances it
    visits before its transmittance stop (what the kernel's early exit
    leaves) and, of those, the live ones it composites.
    """
    dev = inst_T8.device
    px, py = _pixel_coords(num_tiles, gx, tile_lo, dev)
    s = torch.zeros(num_tiles, PX, device=dev)  # log-T before next instance
    log_t = torch.zeros(num_tiles, PX, device=dev)
    color = torch.zeros(num_tiles, 3, PX, device=dev)
    n_used = counts[:, None].expand(-1, PX).clone()
    n_live = torch.zeros_like(n_used)
    starts = starts8.to(torch.int64)
    k_max = int(counts.max()) if num_tiles else 0
    for k0 in range(0, k_max, _PLAIN_CHUNK):
        k = k0 + torch.arange(_PLAIN_CHUNK, device=dev)
        lane_ok = k[None, :] < counts[:, None]  # (T, K)
        idx = torch.where(lane_ok, starts[:, None] + k[None, :], 0)
        data = inst_T8[:9, idx]  # (9, T, K)
        x, y, A, B, C, op = (data[i][:, None, :] for i in range(6))
        dx = x - px[:, :, None]  # (T, PX, K)
        dy = y - py[:, :, None]
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        alpha = torch.clamp_max(
            op * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX
        )
        live = lane_ok[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        a = torch.where(live, alpha, torch.zeros_like(alpha))
        l = torch.log1p(-a)
        incl = torch.cumsum(l, dim=-1)
        s_excl = s[:, :, None] + torch.cat(
            [torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1
        )
        n_excl = torch.exp(s_excl)
        contrib = n_excl * (1.0 - a) >= T_STOP
        w = torch.where(contrib, a * n_excl, torch.zeros_like(a))
        color += torch.bmm(data[6:9].permute(1, 0, 2), w.transpose(1, 2))
        log_t += torch.sum(torch.where(contrib, l, torch.zeros_like(l)), -1)
        s = s_excl[..., -1] + l[..., -1]
        n_live += torch.sum(live & contrib, -1, dtype=n_live.dtype)
        stop = live & ~contrib
        first = torch.where(stop, k[None, None, :] + 1, k_max + 1).amin(-1)
        n_used = torch.minimum(n_used, first.to(n_used.dtype))
    return color, torch.exp(log_t), n_used, n_live


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
    lib = cuda_build.load("composite_seg_fwd")
    fn = lib.omnigs_composite_seg_fwd
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
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
    """Plain PyTorch version of the segmented backward kernel.

    Walks every tile's segment in steps of ``_PLAIN_CHUNK`` instances like
    `composite_seg_fwd_plain`, recomputing the forward's transmittances and
    stop decisions, with the kernel's per-pair math; each instance's nine
    partials are summed over the tile's pixels and written at its lane of a
    zero (NROWS, R8) array (see `composite_seg_bwd`).
    """
    dev = inst_T8.device
    px, py = _pixel_coords(num_tiles, gx, tile_lo, dev)
    dinst = torch.zeros_like(inst_T8)
    dlr, dlg, dlb = (dcolor[:, c, :, None] for c in range(3))  # (T, PX, 1)
    dl_cf = (
        dcolor[:, 0] * color_full[:, 0]
        + dcolor[:, 1] * color_full[:, 1]
        + dcolor[:, 2] * color_full[:, 2]
    )
    s = torch.zeros(num_tiles, PX, device=dev)  # log-T before next instance
    wu_acc = torch.zeros(num_tiles, PX, device=dev)  # Σ w·u so far
    starts = starts8.to(torch.int64)
    k_max = int(counts.max()) if num_tiles else 0
    for k0 in range(0, k_max, _PLAIN_CHUNK):
        k = k0 + torch.arange(_PLAIN_CHUNK, device=dev)
        lane_ok = k[None, :] < counts[:, None]  # (T, K)
        idx = torch.where(lane_ok, starts[:, None] + k[None, :], 0)
        data = inst_T8[:NGRAD, idx]  # (9, T, K)
        x, y, A, B, C, op, r, g, b = (data[i][:, None, :] for i in range(NGRAD))
        dx = x - px[:, :, None]  # (T, PX, K)
        dy = y - py[:, :, None]
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        gauss = torch.exp(torch.clamp_max(power, 0.0))
        op_g = op * gauss
        alpha = torch.clamp_max(op_g, ALPHA_MAX)
        live = lane_ok[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        a = torch.where(live, alpha, torch.zeros_like(alpha))
        l = torch.log1p(-a)
        incl = torch.cumsum(l, dim=-1)
        s_excl = s[:, :, None] + torch.cat(
            [torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1
        )
        n_excl = torch.exp(s_excl)
        one_m = 1.0 - a
        contrib = n_excl * one_m >= T_STOP
        gate = live & contrib
        w = torch.where(contrib, a * n_excl, torch.zeros_like(a))
        u = dlr * r + dlg * g + dlb * b
        wu_incl = wu_acc[:, :, None] + torch.cumsum(w * u, dim=-1)
        dl_dot_b = dl_cf[:, :, None] - wu_incl
        dl_da = torch.where(
            gate, n_excl * u - dl_dot_b / one_m, torch.zeros_like(a)
        )
        v = dl_da * op_g  # the 0.99 clamp is ignored, as in the reference
        vdx, vdy = v * dx, v * dy
        s0, s1, s2, s3, s4, s5, s6, s7, s8 = (
            torch.sum(t, dim=1)  # over the tile's pixels → (T, K)
            for t in (
                vdx, vdy, vdx * dx, vdx * dy, vdy * dy, dl_da * gauss,
                dlr * w, dlg * w, dlb * w,
            )
        )
        A, B, C = data[2], data[3], data[4]
        rows = torch.stack(
            [
                -(A * s0 + B * s1),
                -(C * s1 + B * s0),
                -0.5 * s2,
                -s3,
                -0.5 * s4,
                s5, s6, s7, s8,
            ]
        )
        dinst[:NGRAD, idx[lane_ok]] = rows[:, lane_ok]
        s = s_excl[..., -1] + l[..., -1]
        wu_acc = wu_incl[..., -1]
    return dinst


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
    lib = cuda_build.load("composite_seg_bwd")
    fn = lib.omnigs_composite_seg_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
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
