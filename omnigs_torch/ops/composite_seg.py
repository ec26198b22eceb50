"""Segmented compositing, forward: the counterpart of the forward half of
`omnigs_tpu/ops/pallas_seg.py`.

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
* `composite_instances_seg` is the forward of the JAX custom-VJP function:
  slab build, compositing, background blend. This slice has no backward:
  it raises when asked to record a gradient (render under
  ``torch.inference_mode()``).
"""

from __future__ import annotations

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

_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# omnigs_composite_seg_fwd(inst, r8, starts8, counts, num_tiles, gx,
#                          tile_lo, color, final_t, device, stream)
_LAUNCH_ARGTYPES = [
    _VP, ctypes.c_longlong, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _I32, _VP
]

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
    num_tiles: int,
    gx: int,
    tile_lo: int = 0,
):
    """Segmented compositing of an 8-granular slab → (color (T, 3, PX) with
    the background blended in, finalT (T, PX), n_contrib zeros (T, PX))."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (means2d, conic, rgb, opacity, bg)
    ):
        raise RuntimeError(
            "omnigs_torch renders forward only (the segmented backward "
            "kernel is the next slice): call under torch.inference_mode() "
            "or torch.no_grad()"
        )
    inst_T8 = _build_inst_seg(
        means2d, conic, rgb, opacity, sorted_g8, perm, ride_d, ride_t
    )
    color, final_t = composite_seg_fwd(
        inst_T8, starts8, counts, live8, num_tiles, gx, tile_lo
    )
    color = color + final_t[:, None, :] * bg[None, :, None]
    ncontrib = torch.zeros(num_tiles, PX, dtype=torch.int32, device=color.device)
    return color, final_t, ncontrib
