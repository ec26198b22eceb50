"""Static-shape tile binning: duplicate-with-keys → sort → per-tile ranges.

Counterpart of `omnigs_tpu/ops/binning.py`, every layout of it:

* `bin_instances_packed` — the depth-presorted single packed key (the
  production layout; ``sorted_g`` holds depth ranks, mapped by ``perm``),
  with the survivor-rank payload of the gather reduction
  (`_emission_segments`);
* `bin_instances` — the compact 2-key (tile, depth) layout, the fallback
  without a depth presort, above 2^19 Gaussians or at 8,191 or more tiles;
* `bin_instances_aligned` — the ghost-aligned layout (every tile's run
  padded to a chunk multiple inside the sort), with `tile_cover_counts` and
  `align_instances`;
* `bin_gaussians` — the dense (num_tiles, tile_cap) layout of the
  XLA-style compositor;
* `segment_relay` — the 8-granular slab re-lay of the segmented compositor,
  from packed keys or from Gaussian ids;

with the superblock pre-cull (`_precull_masks`) shared by all of them: on
the card the CUDA kernel `precull` (`csrc/precull.cu`, launches counted in
`utils.profiling.counters`), on the CPU its plain version `_precull_masks_plain`,
bit for bit the same. The packed layout's expansion (`_packed_keys`: every
emission slot's sort key) is likewise the kernel `expand_keys`
(`csrc/expand_keys.cu`) on the card and `_expand_keys_plain` on the CPU; the
other layouts expand eagerly (`_expand`). Every integer output is bitwise
identical to the JAX functions' (tests/test_torch_binning.py,
tests/test_torch_binning_layouts.py).

Port notes, where PyTorch differs from `jax.lax`:

* The packed sort keys are uint32 in JAX (``tile << 19 | depth_rank``);
  here they are held as the same values in int64, which PyTorch sorts
  natively on every device.
* ``lax.sort((tile, depth, ...), num_keys=2, is_stable=True)`` becomes two
  stable sorts, the least significant key first (`_sort_tile_depth`).
* ``population_count`` has no PyTorch counterpart: `_popcount32` counts
  the 32-bit pattern with bit tricks in int64 (no sign-bit surprises for
  bit 31).
* ``torch.sum``/``torch.cumsum`` widen int32 to int64; every integer
  reduction here passes ``dtype=torch.int32`` (or masks to 32 bits) so the
  values wrap like JAX's.
* ``.at[].add(mode="drop")`` becomes a scatter into one extra slot that
  takes every out-of-range index and is then cut off — no host sync, and
  no out-of-range index ever reaches the device.
* ``searchsorted(side=...)`` maps to ``torch.searchsorted(right=...)``.

The JAX functions bound their expansion and relay gathers to the live
prefix with chunked while-loops and carry per-Gaussian fields through f32
table columns (TPU memory and gather devices). Here the expansion gathers
the fields directly over the full width, and the lanes the chunked loops
never visit get the same sentinels, so the outputs match bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops.preprocess import TILE, Preprocessed
from omnigs_torch.utils import profiling

MASK_TILES = 64  # pre-emission survivor bitmask width (2 32-bit words)
RANK_BITS = 19  # depth-rank bits in the packed sort key (P ≤ 2^19)
SEG_GRAN = 8  # segment granularity of the segmented-chunk slab layout
# lanes per chunk of the JAX functions' live-bound loops (see module doc)
_LIVE_CHUNK = 1 << 16
# sorted_e payload of slab slots that carry no survivor: sorts after every
# real survivor rank (< 2^24) in the gradient reduction's inversion sort
E_SENTINEL = 1 << 30

_I32 = torch.int32
_I64 = torch.int64


class BinnedInstances(NamedTuple):
    """Instance-major binning result."""

    # Gaussian id per instance; the depth RANK under the packed binning
    sorted_g: torch.Tensor  # (R,) int32
    starts: torch.Tensor  # (num_tiles,) int32 first instance of each tile
    counts: torch.Tensor  # (num_tiles,) int32 instances per tile
    num_instances: torch.Tensor  # () int32 total emitted instances
    truncated: torch.Tensor  # () int32 instances dropped by max_instances
    # packed-key binning (`bin_instances_packed`) only
    perm: Optional[torch.Tensor] = None  # (P,) int32 gaussian id = perm[rank]
    inv_perm: Optional[torch.Tensor] = None  # (P,) int32 rank of each id
    sorted_key: Optional[torch.Tensor] = None  # (R,) int64 (tile << RANK_BITS | rank)
    # with_emission only: slab position → survivor rank (E_SENTINEL where
    # none), and each Gaussian's (or rank's) survivor segment [seg_lo, seg_hi)
    sorted_e: Optional[torch.Tensor] = None  # (R,) int32
    seg_lo: Optional[torch.Tensor] = None  # (P,) int32
    seg_hi: Optional[torch.Tensor] = None  # (P,) int32


class BinnedTiles(NamedTuple):
    """Dense per-tile layout of the XLA-style compositor (`bin_gaussians`)."""

    tile_ids: torch.Tensor  # (num_tiles, tile_cap) int32 gaussian ids
    tile_mask: torch.Tensor  # (num_tiles, tile_cap) bool
    tile_counts: torch.Tensor  # (num_tiles,) int32 true per-tile count
    num_instances: torch.Tensor  # () int32 total emitted instances
    overflow: torch.Tensor  # () int32 instances dropped by tile_cap
    truncated: torch.Tensor  # () int32 instances dropped by max_instances


class SegLayout(NamedTuple):
    """8-granular slab re-lay for the segmented compositor.

    Every tile's segment is padded to a multiple of SEG_GRAN lanes; pad
    lanes carry the P sentinel in ``sorted_g8`` (an all-zero instance row,
    α = 0).
    """

    sorted_g8: torch.Tensor  # (R8,) int32 ranks; == p_sentinel on pads
    starts8: torch.Tensor  # (T,) int32 SEG_GRAN-aligned slab8 start per tile
    counts: torch.Tensor  # (T,) int32 surviving count per tile (post-trim)
    truncated: torch.Tensor  # () int32 instances dropped by the r8 cap
    live8: torch.Tensor  # () int32 slab8 high-water mark
    ride_d: torch.Tensor  # (R8,) int32 owning tile's dense (nonempty) index
    ride_t: torch.Tensor  # (R8,) int32 owning tile's id


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32-bit pattern of an integer tensor → int32."""
    v = x.to(_I64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = (v * 0x01010101) & 0xFFFFFFFF
    return (v >> 24).to(_I32)


def _scatter_add_drop(size: int, index: torch.Tensor, src: torch.Tensor):
    """``zeros(size).at[index].add(src, mode="drop")`` for int32 ``src``."""
    ok = (index >= 0) & (index < size)
    idx = torch.where(ok, index, torch.full_like(index, size)).to(_I64)
    out = torch.zeros(size + 1, dtype=src.dtype, device=src.device)
    out.scatter_add_(0, idx, src)
    return out[:size]


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0, dtype=_I32)


def _owner_of_slot(boundaries: torch.Tensor, num_slots: int) -> torch.Tensor:
    """For non-decreasing ``boundaries`` (one per owner): each slot's owner
    (# boundaries ≤ j) − 1, by a scatter of ones and a cumsum."""
    ones = torch.ones_like(boundaries, dtype=_I32)
    return _cumsum32(_scatter_add_drop(num_slots, boundaries, ones)) - 1


def _sorted_histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) int32 counts of int32 ``keys`` ∈ [0, num_bins] (the key
    num_bins is the dead sentinel and not counted). The JAX function sorts
    and binary-searches because a TPU scatter-add is slow; ``bincount``
    gives the same counts."""
    counts = torch.bincount(keys.to(_I64), minlength=num_bins + 1)
    return counts[:num_bins].to(_I32)


def _min_quad_over_box(A, B, C, u0, u1, v0, v1):
    """Exact min of q(u,v) = A·u² + 2B·u·v + C·v² over the box
    [u0,u1]×[v0,v1] (A, C ≥ 0, psd): 0 if the origin is inside, else the
    least of the four clamped edge minima."""
    eps = 1e-12
    inside = (u0 <= 0.0) & (u1 >= 0.0) & (v0 <= 0.0) & (v1 >= 0.0)

    def q(u, v):
        return A * u * u + 2.0 * B * u * v + C * v * v

    vs0 = torch.clamp(-B * u0 / torch.clamp_min(C, eps), v0, v1)
    vs1 = torch.clamp(-B * u1 / torch.clamp_min(C, eps), v0, v1)
    us0 = torch.clamp(-B * v0 / torch.clamp_min(A, eps), u0, u1)
    us1 = torch.clamp(-B * v1 / torch.clamp_min(A, eps), u0, u1)
    qmin = torch.minimum(
        torch.minimum(q(u0, vs0), q(u1, vs1)),
        torch.minimum(q(us0, v0), q(us1, v1)),
    )
    return torch.where(inside, torch.zeros_like(qmin), qmin)


def _alpha_reaches_min(op, qmin):
    """max α over a box = op·exp(−½·qmin) reaches the 1/255 skip floor."""
    return op * torch.exp(-0.5 * qmin) >= 1.0 / 255.0


def _precull_masks(prep: Preprocessed, grid_x: int):
    """Per-Gaussian 64-bit bitmask (two 32-bit words) of rect SUPERBLOCKS
    that survive the ellipse–box cull, plus the block geometry (sx, sy, wb)
    and the emission budget ``tiles_eff``.

    Rects of ≤ MASK_TILES tiles get one bit per tile (sx = sy = 1, exact
    cull). Bigger rects tile into ≤ 8×8 superblocks of sx×sy tiles; a bit
    is set iff the max α over the block's pixel box can reach 1/255 — a
    conservative test the per-tile re-test in the expansion completes.
    Returns (lo, hi, tiles_eff, sx, sy, wb), all (P,) int32: from the
    kernel `precull` on a CUDA device, from `_precull_masks_plain` on the
    CPU.
    """
    if prep.rect.device.type == "cuda":
        return precull(prep)
    return _precull_masks_plain(prep, grid_x)


def _precull_masks_plain(prep: Preprocessed, grid_x: int):
    """`_precull_masks` in PyTorch: every row broadcast over MASK_TILES
    lanes, the JAX function's operations in its order."""
    rect = prep.rect
    x0, y0 = rect[:, 0:1], rect[:, 1:2]
    w = torch.clamp_min(rect[:, 2:3] - x0, 1)
    h = torch.clamp_min(rect[:, 3:4] - y0, 1)
    area = prep.tiles_touched[:, None]
    small = area <= MASK_TILES
    one = torch.ones_like(w)
    sx = torch.where(small, one, (w + 7) // 8)
    sy = torch.where(small, one, (h + 7) // 8)
    wb = (w + sx - 1) // sx
    hb = (h + sy - 1) // sy
    nb = wb * hb
    mx, my = prep.means2d[:, 0:1], prep.means2d[:, 1:2]
    cA, cB, cC = prep.conic[:, 0:1], prep.conic[:, 1:2], prep.conic[:, 2:3]
    op = prep.opacity[:, None]
    b = torch.arange(MASK_TILES, dtype=_I32, device=rect.device)[None, :]
    bx = torch.remainder(b, wb)
    by = b // wb
    px0 = ((x0 + bx * sx) * TILE).to(torch.float32)
    py0 = ((y0 + by * sy) * TILE).to(torch.float32)
    ex = (sx * TILE - 1).to(torch.float32)
    ey = (sy * TILE - 1).to(torch.float32)
    qmin = _min_quad_over_box(
        cA, cB, cC,
        px0 - mx, px0 + ex - mx,
        py0 - my, py0 + ey - my,
    )
    keep = (b < nb) & (area > 0) & _alpha_reaches_min(op, qmin)
    # distinct bits per lane ⇒ the sum is the bitwise or; int64 keeps bit 31
    bits = keep.to(_I64) << (b % 32).to(_I64)
    zero = torch.zeros_like(bits)
    lo = torch.sum(torch.where(b < 32, bits, zero), dim=1).to(_I32)
    hi = torch.sum(torch.where(b >= 32, bits, zero), dim=1).to(_I32)
    count = _popcount32(lo) + _popcount32(hi)
    tiles_eff = (count * (sx * sy)[:, 0]).to(_I32)
    return lo, hi, tiles_eff, sx[:, 0], sy[:, 0], wb[:, 0]


# omnigs_precull(rect, rs0, rs1, tiles, ts, means, ms0, ms1, conic, cs0, cs1,
#                opacity, os, P, out, device, stream)
_LL, _VP = ctypes.c_longlong, ctypes.c_void_p
_PRECULL_ARGTYPES = [
    _VP, _LL, _LL, _VP, _LL, _VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL, _LL, _VP, ctypes.c_int, _VP,
]


def precull(prep: Preprocessed):
    """The pre-cull kernel (`csrc/precull.cu`) on CUDA tensors: `_precull_masks`'
    six (P,) int32 rows, bit for bit `_precull_masks_plain`'s, from one pass
    over the rows (inputs read through their strides). Outputs come from one
    (6, P) buffer; the launch runs on the current stream, without a sync."""
    rect, tiles = prep.rect, prep.tiles_touched
    means, conic, opac = prep.means2d, prep.conic, prep.opacity
    p = rect.shape[0]
    dev = rect.device
    want = ((rect, (p, 4), _I32), (tiles, (p,), _I32), (means, (p, 2), torch.float32),
            (conic, (p, 3), torch.float32), (opac, (p,), torch.float32))
    if dev.type != "cuda" or any(
            t.device != dev or tuple(t.shape) != s or t.dtype != d for t, s, d in want):
        raise ValueError(
            "the pre-cull kernel takes rect (P, 4) and tiles_touched (P,) int32, means2d "
            "(P, 2), conic (P, 3) and opacity (P,) float32 on one CUDA device, got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} {t.device}" for t, _, _ in want)
        )
    out = torch.empty(6, p, dtype=_I32, device=dev)
    if p:
        lib, fn = cuda_build.launcher("precull", "precull", _PRECULL_ARGTYPES)
        err = fn(
            rect.data_ptr(), *rect.stride(), tiles.data_ptr(), tiles.stride(0),
            means.data_ptr(), *means.stride(), conic.data_ptr(), *conic.stride(),
            opac.data_ptr(), opac.stride(0), p, out.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(lib, err, "precull launch")
        profiling.count_launch("precull")
    return tuple(out.unbind(0))



def _kth_set_bit(lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor):
    """Position of the k-th (0-based, ascending) set bit of the 64-bit mask
    (lo, hi): a 5-step binary search on popcounts over the 32-bit words."""
    nlo = _popcount32(lo)
    use_hi = k >= nlo
    word = torch.where(use_hi, hi, lo).to(_I64) & 0xFFFFFFFF
    kk = torch.where(use_hi, k - nlo, k)
    b = torch.where(use_hi, 32, 0).to(_I32)
    for shift in (16, 8, 4, 2, 1):
        cnt = _popcount32(word & ((1 << shift) - 1))
        go = kk >= cnt
        word = torch.where(go, word >> shift, word)
        kk = torch.where(go, kk - cnt, kk)
        b = b + torch.where(go, shift, 0).to(_I32)
    return b


def _hier_decode(x0, y0, x1, y1, sx, sy, wb, lo_m, hi_m, local):
    """Emission slot ``local`` (within its Gaussian) → (tx, ty, in_rect)
    under the superblock mask: block = k-th set bit with k = local //
    (sx·sy); tile inside the block = (within % sx, within // sx)."""
    q = sx * sy
    blk = local // q
    within = local - blk * q
    b = _kth_set_bit(lo_m, hi_m, blk)
    wx = within % sx
    wy = within // sx
    tx = x0 + (b % wb) * sx + wx
    ty = y0 + (b // wb) * sy + wy
    return tx, ty, (tx < x1) & (ty < y1)


def _emission_segments(keep, offsets, tiles, max_instances: int):
    """Survivor-rank bookkeeping of the gather reduction: each emission
    slot's survivor rank ``e`` (cumsum(keep) − 1; E_SENTINEL where the slot
    is dropped) and each Gaussian's survivor segment [ksum[first slot],
    ksum[end slot]) — its survivors are contiguous in rank."""
    ks = _cumsum32(keep.to(_I32))
    e = torch.where(keep, ks - 1, torch.full_like(ks, E_SENTINEL))
    ksum = torch.cat([ks.new_zeros(1), ks])
    lo = torch.clamp_max(offsets, max_instances).to(_I64)
    hi = torch.clamp_max(offsets + tiles, max_instances).to(_I64)
    return e, ksum[lo], ksum[hi]


def _live_chunks(n_slots: int) -> int:
    """Full chunks of the JAX functions' live-bound loops over ``n_slots``;
    0 where they run one full-width pass (a ragged or single chunk)."""
    n_full = n_slots // _LIVE_CHUNK
    return n_full if n_full * _LIVE_CHUNK == n_slots and n_full > 1 else 0


def _live_chunk_bound(n_slots: int, total: torch.Tensor):
    """Slot count the JAX functions' live-bound chunk loops visit, as a
    tensor; None where they run one full-width pass."""
    n_full = _live_chunks(n_slots)
    if not n_full:
        return None
    n_chunks = torch.clamp_max((total + _LIVE_CHUNK - 1) // _LIVE_CHUNK, n_full)
    return n_chunks * _LIVE_CHUNK


def _expand(prep: Preprocessed, cull, gid, local, alive, grid_x, num_tiles, tile_lo=0):
    """Emission slots → (tile id, keep): the slot's tile from its Gaussian
    ``gid`` (R,) int64 and its index ``local`` within that Gaussian's
    emission (rect-row-major, or the superblock decode under ``cull`` = the
    (lo, hi, sx, sy, wb) of `_precull_masks`, with the exact per-tile α
    re-test). Dead slots (not ``alive``, outside the tile window or culled)
    carry the ``num_tiles`` sentinel."""
    x0, y0, x1, y1 = prep.rect[gid].unbind(-1)
    if cull is not None:
        ints = torch.stack(cull, dim=-1)[gid]
        lo_m, hi_m, sx, sy, wb = ints.unbind(-1)
        tx, ty, in_rect = _hier_decode(x0, y0, x1, y1, sx, sy, wb, lo_m, hi_m, local)
    else:
        width = torch.clamp_min(x1 - x0, 1)
        tx = x0 + local % width
        ty = y0 + local // width
    tid = ty * grid_x + tx - tile_lo
    keep = alive & (tid >= 0) & (tid < num_tiles)
    if cull is not None:
        floats = torch.cat([prep.means2d, prep.conic, prep.opacity[:, None]], dim=-1)[gid]
        mx, my, cA, cB, cC, op = floats.unbind(-1)
        px0 = (tx * TILE).to(torch.float32)
        py0 = (ty * TILE).to(torch.float32)
        qmin = _min_quad_over_box(
            cA, cB, cC,
            px0 - mx, px0 + (TILE - 1) - mx,
            py0 - my, py0 + (TILE - 1) - my,
        )
        keep = keep & in_rect & _alpha_reaches_min(op, qmin)
    return torch.where(keep, tid, torch.full_like(tid, num_tiles)), keep


def _emission_budget(prep: Preprocessed, grid_x: int, tile_cull: bool):
    """(tiles (P,) int32 emission slots per Gaussian, cull masks or None)."""
    if not tile_cull:
        return prep.tiles_touched.to(_I32), None
    mlo, mhi, tiles, sx, sy, wb = _precull_masks(prep, grid_x)
    return tiles, (mlo, mhi, sx, sy, wb)


def _sort_tile_depth(tile_id: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Order of the stable lexicographic (tile, depth) sort of
    ``lax.sort(..., num_keys=2, is_stable=True)``: two stable sorts, the
    least significant key first. (Depths here are positive or +inf, so
    torch's float order equals lax.sort's total order.)"""
    order = torch.sort(depth, stable=True).indices
    return order[torch.sort(tile_id[order], stable=True).indices]


def _tile_ranges(sorted_tile: torch.Tensor, num_tiles: int):
    """(starts, counts) int32 of each tile's run in the sorted tile ids."""
    tids = torch.arange(num_tiles, dtype=_I32, device=sorted_tile.device)
    starts = torch.searchsorted(sorted_tile, tids, right=False).to(_I32)
    ends = torch.searchsorted(sorted_tile, tids, right=True).to(_I32)
    return starts, ends - starts


def bin_instances(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_instances: int,
    tile_lo: int = 0,
    n_tiles: Optional[int] = None,
    tile_cull: bool = False,
    with_emission: bool = False,
) -> BinnedInstances:
    """Duplicate-with-keys + stable (tile, depth) sort + tile ranges, the
    compact 2-key layout (tight per-tile segments, no alignment padding).

    Bins into the tile window [tile_lo, tile_lo + n_tiles) (the whole grid
    by default). ``sorted_g`` holds Gaussian ids; there is no depth presort,
    so ``perm``, ``inv_perm`` and ``sorted_key`` are None. Emission beyond
    ``max_instances`` is dropped in Gaussian order and counted in
    ``truncated``. ``tile_cull`` drops every (Gaussian, tile) instance whose
    max α over the tile is provably < 1/255; ``with_emission`` adds the
    survivor-rank payload of the gather reduction.
    """
    num_tiles = n_tiles if n_tiles is not None else grid_x * grid_y
    p = prep.depths.shape[0]
    dev = prep.depths.device
    tiles, cull = _emission_budget(prep, grid_x, tile_cull)
    offsets = _cumsum32(tiles) - tiles
    total = offsets[-1] + tiles[-1]
    gl = torch.clamp(_owner_of_slot(offsets, max_instances), 0, p - 1).to(_I64)
    j = torch.arange(max_instances, dtype=_I32, device=dev)
    tile_id, keep = _expand(
        prep, cull, gl, j - offsets[gl], j < total, grid_x, num_tiles, tile_lo
    )
    depth = torch.where(keep, prep.depths[gl], torch.full_like(prep.depths[gl], torch.inf))
    order = _sort_tile_depth(tile_id, depth)
    sorted_e = seg_lo = seg_hi = None
    if with_emission:
        e, seg_lo, seg_hi = _emission_segments(keep, offsets, tiles, max_instances)
        sorted_e = e[order]
    starts, counts = _tile_ranges(tile_id[order], num_tiles)
    return BinnedInstances(
        sorted_g=gl[order].to(_I32),
        starts=starts,
        counts=counts,
        num_instances=torch.sum(counts, dtype=_I32),
        truncated=torch.clamp_min(total - max_instances, 0),
        sorted_e=sorted_e,
        seg_lo=seg_lo,
        seg_hi=seg_hi,
    )


def _depth_ranks(depths: torch.Tensor, tiles: torch.Tensor):
    """(perm, tiles_d, offsets_d): the stable depth presort's order (int32
    Gaussian ids by depth rank; ties keep the original Gaussian order, which
    with Gaussian-major emission reproduces a stable (tile, depth) sort),
    the emission budget in that order and its exclusive cumsum."""
    perm = torch.sort(depths, stable=True).indices.to(_I32)
    tiles_d = tiles[perm.to(_I64)]
    return perm, tiles_d, _cumsum32(tiles_d) - tiles_d


def _packed_keys(prep, cull, perm, tiles_d, offsets_d, max_instances: int,
                 grid_x: int, num_tiles: int, tile_lo: int = 0) -> torch.Tensor:
    """The packed layout's expansion: each of the ``max_instances`` emission
    slots' int64 sort key ``tile << RANK_BITS | depth_rank`` (the dead
    sentinel tile ``num_tiles`` where the slot emits nothing), from the ranks'
    budget ``tiles_d`` and exclusive cumsum ``offsets_d`` in depth order,
    ``perm`` and the cull masks (or None). From the kernel `expand_keys` on a
    CUDA device, from `_expand_keys_plain` on the CPU."""
    if perm.device.type == "cuda":
        return expand_keys(
            prep, cull, perm, tiles_d, offsets_d, max_instances, grid_x, num_tiles, tile_lo
        )
    return _expand_keys_plain(
        prep, cull, perm, tiles_d, offsets_d, max_instances, grid_x, num_tiles, tile_lo
    )


def _expand_keys_plain(prep, cull, perm, tiles_d, offsets_d, max_instances: int,
                       grid_x: int, num_tiles: int, tile_lo: int = 0) -> torch.Tensor:
    """`_packed_keys` in PyTorch: the owner search, the rows' gathers and
    `_expand` over every slot, the JAX function's operations in its order."""
    P = perm.shape[0]
    total = offsets_d[-1] + tiles_d[-1]
    j = torch.arange(max_instances, dtype=_I32, device=perm.device)
    # slot → owning depth rank: (# emission offsets ≤ j) − 1
    g = torch.searchsorted(offsets_d, j, right=True).to(_I32) - 1
    g = torch.clamp(g, 0, P - 1)
    gl = g.to(_I64)
    tid, _ = _expand(
        prep, cull, perm.to(_I64)[gl], j - offsets_d[gl], j < total, grid_x, num_tiles,
        tile_lo,
    )
    key = (tid.to(_I64) << RANK_BITS) | g.to(_I64)
    bound = _live_chunk_bound(max_instances, total)
    if bound is not None:
        dead_key = num_tiles << RANK_BITS
        key = torch.where(j < bound, key, torch.full_like(key, dead_key))
    return key


# omnigs_expand_keys(ptrs[12], strides[15], P, n_slots, grid_x, num_tiles,
#                    tile_lo, n_full, cull, key, device, stream)
_EXPAND_ARGTYPES = [
    _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, _VP, ctypes.c_int, _VP,
]


def expand_keys(prep: Preprocessed, cull, perm, tiles_d, offsets_d, max_instances: int,
                grid_x: int, num_tiles: int, tile_lo: int = 0) -> torch.Tensor:
    """The expansion kernel (`csrc/expand_keys.cu`) on CUDA tensors:
    `_packed_keys`' (max_instances,) int64 keys, bit for bit
    `_expand_keys_plain`'s, from one pass over the slots (inputs read through
    their strides; total and the live bound read on the device). The launch
    runs on the current stream, without a sync."""
    p = perm.shape[0]
    f32 = torch.float32
    want = [("offsets_d", offsets_d, (p,), _I32), ("tiles_d", tiles_d, (p,), _I32),
            ("perm", perm, (p,), _I32)]
    rows = prep.rect.shape[0]
    want += [("rect", prep.rect, (rows, 4), _I32)]
    if cull is not None:
        want += [(n, c, (rows,), _I32) for n, c in zip(("lo", "hi", "sx", "sy", "wb"), cull)]
        want += [("means2d", prep.means2d, (rows, 2), f32), ("conic", prep.conic, (rows, 3), f32),
                 ("opacity", prep.opacity, (rows,), f32)]
    bad = [f"{n} {tuple(t.shape)} {t.dtype}" for n, t, s, d in want
           if tuple(t.shape) != s or t.dtype != d]
    if bad or p == 0 or not 0 <= max_instances < 1 << 24 or (cull is not None and len(cull) != 5):
        raise ValueError(
            "the expansion kernel takes offsets_d, tiles_d and perm (P,) int32 with P >= 1, "
            "rect (rows, 4) int32, the cull's five (rows,) int32 rows and means2d (rows, 2), "
            "conic (rows, 3), opacity (rows,) float32, and max_instances below 2^24; got "
            + (", ".join(bad) or f"P = {p}, max_instances = {max_instances}")
        )
    dev = perm.device
    if dev.type != "cuda" or any(t.device != dev for _, t, _, _ in want):
        raise ValueError(
            "the expansion kernel runs on one CUDA device, got "
            + ", ".join(f"{n} on {t.device}" for n, t, _, _ in want)
        )
    key = torch.empty(max_instances, dtype=_I64, device=dev)
    if max_instances:
        ts = [t for _, t, _, _ in want]  # the cull's rows and the floats only with it
        ptrs = [t.data_ptr() for t in ts] + [None] * (12 - len(ts))
        strides = [s for t in ts for s in t.stride()] + [0] * (15 - sum(t.dim() for t in ts))
        lib, fn = cuda_build.launcher("expand_keys", "expand_keys", _EXPAND_ARGTYPES)
        err = fn(
            (_VP * 12)(*ptrs), (_LL * 15)(*strides), p, max_instances, grid_x, num_tiles,
            tile_lo, _live_chunks(max_instances), int(cull is not None), key.data_ptr(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(lib, err, "expand_keys launch")
        profiling.count_launch("expand_keys")
    return key


def bin_instances_packed(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_instances: int,
    tile_lo: int = 0,
    n_tiles: Optional[int] = None,
    tile_cull: bool = False,
    with_emission: bool = False,
) -> BinnedInstances:
    """Compact binning with a depth presort and a single packed sort key.

    Stable-sorting the P Gaussians by depth once makes every tile's
    gaussian-major emission depth-ordered, so the per-instance sort needs
    one unique key ``tile << RANK_BITS | depth_rank``. ``sorted_g`` holds
    depth RANKS; map them to Gaussians with ``perm``. Requires P ≤
    2^RANK_BITS and num_tiles < 2^(32−RANK_BITS) − 1. Bins into the tile
    window [tile_lo, tile_lo + n_tiles) (the whole grid by default).

    When emission exceeds ``max_instances`` the tail is dropped in depth
    order and counted in ``truncated``. ``with_emission`` also returns the
    survivor-rank payload ``sorted_e`` and the per-rank ``seg_lo`` /
    ``seg_hi`` of the gather reduction.
    """
    num_tiles = n_tiles if n_tiles is not None else grid_x * grid_y
    P = prep.depths.shape[0]
    dev = prep.depths.device
    if P > (1 << RANK_BITS):
        raise ValueError(f"P={P} exceeds the packed key's 2^{RANK_BITS} ranks")
    if num_tiles >= (1 << (32 - RANK_BITS)) - 1:
        raise ValueError(f"{num_tiles} tiles overflow the packed key")
    if max_instances >= 1 << 24:
        raise ValueError("max_instances must stay below 2^24")

    tiles, cull = _emission_budget(prep, grid_x, tile_cull)
    perm, tiles_d, offsets_d = _depth_ranks(prep.depths, tiles)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm.to(_I64)] = torch.arange(P, dtype=_I32, device=dev)
    total = offsets_d[-1] + tiles_d[-1]
    key = _packed_keys(
        prep, cull, perm, tiles_d, offsets_d, max_instances, grid_x, num_tiles, tile_lo
    )

    skey, order = torch.sort(key)
    sorted_e = seg_lo = seg_hi = None
    if with_emission:
        keep = (key >> RANK_BITS) < num_tiles
        e, seg_lo, seg_hi = _emission_segments(keep, offsets_d, tiles_d, max_instances)
        # live keys are unique and every dead key carries the sentinel
        # payload, so the payload gathered by an unstable sort's indices is
        # the JAX (key, e) sort's, whatever order the dead keys take
        sorted_e = e[order]
    starts, counts = _tile_ranges((skey >> RANK_BITS).to(_I32), num_tiles)
    return BinnedInstances(
        sorted_g=(skey & ((1 << RANK_BITS) - 1)).to(_I32),
        starts=starts,
        counts=counts,
        num_instances=torch.sum(counts, dtype=_I32),
        truncated=torch.clamp_min(total - max_instances, 0),
        perm=perm,
        inv_perm=inv_perm,
        sorted_key=skey,
        sorted_e=sorted_e,
        seg_lo=seg_lo,
        seg_hi=seg_hi,
    )


def segment_relay(
    sorted_g: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    r8: int,
    p_sentinel: int,
    sorted_key: Optional[torch.Tensor] = None,
) -> SegLayout:
    """Re-lay the compact sorted slab to SEG_GRAN-aligned per-tile segments.

    Per-slot fields come from telescoped scatter+cumsum passes. With the
    packed keys (``sorted_key``, the depth-presorted binning) the rank of
    each slot is one gather of ``sorted_key``, and a lane is live iff the
    gathered key's tile field matches the lane's own tile (trimmed tiles
    carry the ``num_tiles`` sentinel so that their lanes fail it). Without
    (`bin_instances`) a lane is live iff it lies before its tile's
    telescoped segment end, and ``sorted_g`` is gathered. Tiles whose padded
    segment would cross ``r8`` are dropped deterministically and counted in
    ``truncated``.
    """
    if r8 % 128 != 0:
        raise ValueError(f"r8={r8} must be a multiple of 128")
    r = sorted_g.shape[0]
    dev = counts.device
    padded = ((counts + SEG_GRAN - 1) // SEG_GRAN) * SEG_GRAN
    starts8 = _cumsum32(padded) - padded
    fits = starts8 + padded <= r8
    zero = torch.zeros_like(counts)
    truncated = torch.sum(torch.where(fits, zero, counts), dtype=_I32)
    counts8 = torch.where(fits, counts, zero)
    padded8 = torch.where(fits, padded, zero)
    live8 = torch.amax(starts8 + padded8)

    # for any per-tile value v, scattering v[t] − v[t−1] at starts8[t] and
    # prefix-summing gives v[tile(j)] at every slot j (empty/dropped tiles
    # share their successor's start — the adds accumulate)
    def _at_slots(v):
        dv = torch.cat([v[:1], v[1:] - v[:-1]])
        return _cumsum32(_scatter_add_drop(r8, starts8, dv))

    shift_at = _at_slots(starts8 - starts)  # src = j − shift
    t = counts.shape[0]
    if t >= 1 << 13:
        raise ValueError(f"{t} tiles overflow the packed ride fields")
    pos = _cumsum32((counts8 > 0).to(_I32)) - 1
    tid_vals = torch.arange(t, dtype=_I32, device=dev)
    if sorted_key is not None:
        tid_vals = torch.where(fits, tid_vals, torch.full_like(counts, t))
    packed_dt = _at_slots((torch.clamp(pos, 0, t) << 13) | tid_vals)
    ride_d = packed_dt >> 13
    ride_t = packed_dt & ((1 << 13) - 1)
    j = torch.arange(r8, dtype=_I32, device=dev)
    src_raw = j - shift_at
    src = torch.clamp(src_raw, 0, r - 1).to(_I64)
    sentinel = torch.full_like(j, p_sentinel)
    if sorted_key is not None:
        kv = sorted_key[src]
        ok = ((kv >> RANK_BITS) == ride_t.to(_I64)) & (src_raw < r)
        sorted_g8 = torch.where(ok, (kv & ((1 << RANK_BITS) - 1)).to(_I32), sentinel)
    else:
        valid = j < _at_slots(starts8 + counts8)
        sorted_g8 = torch.where(valid, sorted_g[src], sentinel)
    bound = _live_chunk_bound(r8, live8)
    if bound is not None:
        sorted_g8 = torch.where(j < bound, sorted_g8, sentinel)
    return SegLayout(
        sorted_g8=sorted_g8,
        starts8=starts8,
        counts=counts8,
        truncated=truncated,
        live8=live8,
        ride_d=ride_d,
        ride_t=ride_t,
    )


def tile_cover_counts(
    rect: torch.Tensor,
    emit_mask: torch.Tensor,
    grid_x: int,
    grid_y: int,
    tile_lo: int = 0,
    n_tiles: Optional[int] = None,
) -> torch.Tensor:
    """Exact per-tile instance counts without touching instances: the four
    signed rect corners of each emitted Gaussian scattered onto a (gy+1,
    gx+1) grid and 2D-prefix-summed — counts[t] = # rects covering t."""
    num_tiles = n_tiles if n_tiles is not None else grid_x * grid_y
    x0, y0, x1, y1 = rect.to(_I64).unbind(-1)
    one = emit_mask.to(_I32)
    w = grid_x + 1
    grid = torch.zeros((grid_y + 1) * w, dtype=_I32, device=rect.device)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        grid.scatter_add_(0, ys * w + xs, one * sign)
    grid = grid.reshape(grid_y + 1, w)
    counts2d = torch.cumsum(torch.cumsum(grid, dim=0, dtype=_I32), dim=1, dtype=_I32)
    return counts2d[:grid_y, :grid_x].reshape(-1)[tile_lo : tile_lo + num_tiles]


def bin_instances_aligned(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_instances: int,
    chunk: int,
    tile_lo: int = 0,
    n_tiles: Optional[int] = None,
    with_emission: bool = False,
    tile_cull: bool = False,
) -> BinnedInstances:
    """One-pass aligned binning: ghost instances pad every tile's run to a
    multiple of ``chunk``, so the sorted array itself is the chunk-aligned
    slab layout.

    Ghosts carry depth +inf and Gaussian id 0, so they sort after their
    tile's real instances (the kernels read a tile's first ``counts[t]``
    lanes only). Per-tile counts come from a histogram of the emitted tile
    ids before the sort; under capacity truncation emission stops at the
    first Gaussian whose instance range would cross ``max_instances`` (the
    whole suffix is dropped, counted in ``truncated``), so the counts match
    the emitted set. ``starts`` are cumsum(padded) − padded; the arrays are
    max_instances + num_tiles·chunk long, the live segments a compact
    prefix. ``tile_cull`` and ``with_emission`` as in `bin_instances`.
    """
    num_tiles = n_tiles if n_tiles is not None else grid_x * grid_y
    p = prep.depths.shape[0]
    dev = prep.depths.device
    tiles, cull = _emission_budget(prep, grid_x, tile_cull)
    offsets = _cumsum32(tiles) - tiles
    total = offsets[-1] + tiles[-1]
    # contiguous-prefix truncation
    kept = _cumsum32((offsets + tiles > max_instances).to(_I32)) == 0
    tiles_eff = torch.where(kept, tiles, torch.zeros_like(tiles))
    total_eff = torch.sum(tiles_eff, dtype=_I32)

    gl = torch.clamp(_owner_of_slot(offsets, max_instances), 0, p - 1).to(_I64)
    j = torch.arange(max_instances, dtype=_I32, device=dev)
    tile_id, keep = _expand(
        prep, cull, gl, j - offsets[gl], j < total_eff, grid_x, num_tiles, tile_lo
    )
    depth = torch.where(keep, prep.depths[gl], torch.full_like(prep.depths[gl], torch.inf))

    counts = _sorted_histogram(tile_id, num_tiles)
    padded = ((counts + chunk - 1) // chunk) * chunk
    astarts = _cumsum32(padded) - padded
    # ghost padding instances, tile by tile
    n_ghost = num_tiles * chunk
    ghost_counts = padded - counts
    ghost_offsets = _cumsum32(ghost_counts) - ghost_counts
    gj = torch.arange(n_ghost, dtype=_I32, device=dev)
    gtile = torch.clamp(_owner_of_slot(ghost_offsets, n_ghost), 0, num_tiles - 1)
    gtile = torch.where(
        gj < torch.sum(ghost_counts, dtype=_I32), gtile, torch.full_like(gtile, num_tiles)
    )
    order = _sort_tile_depth(
        torch.cat([tile_id, gtile]),
        torch.cat([depth, depth.new_full((n_ghost,), torch.inf)]),
    )
    all_g = torch.cat([gl.to(_I32), gtile.new_zeros(n_ghost)])
    sorted_e = seg_lo = seg_hi = None
    if with_emission:
        e, seg_lo, seg_hi = _emission_segments(keep, offsets, tiles_eff, max_instances)
        sorted_e = torch.cat([e, e.new_full((n_ghost,), E_SENTINEL)])[order]
    return BinnedInstances(
        sorted_g=all_g[order],
        starts=astarts,
        counts=counts,
        num_instances=total_eff,
        truncated=total - total_eff,
        sorted_e=sorted_e,
        seg_lo=seg_lo,
        seg_hi=seg_hi,
    )


def align_instances(inst: BinnedInstances, chunk: int, max_aligned: int) -> BinnedInstances:
    """Re-lay a compact binning so each tile's segment starts at a
    chunk-aligned offset: pad slots alias a clipped source instance (the
    kernels read a tile's first ``counts[t]`` lanes only); tiles past
    ``max_aligned`` are clamped and the overflow counted in ``truncated``."""
    counts = inst.counts
    padded = ((counts + chunk - 1) // chunk) * chunk
    astarts = _cumsum32(padded) - padded
    total_aligned = astarts[-1] + padded[-1]
    tile = torch.clamp(_owner_of_slot(astarts, max_aligned), 0, counts.shape[0] - 1)
    info = torch.stack([inst.starts, counts, astarts], dim=-1)[tile.to(_I64)]
    t_start, t_count, t_astart = info.unbind(-1)
    k = torch.arange(max_aligned, dtype=_I32, device=counts.device) - t_astart
    src = torch.clamp(
        t_start + torch.minimum(k, torch.clamp_min(t_count - 1, 0)),
        0,
        inst.sorted_g.shape[0] - 1,
    )
    return BinnedInstances(
        sorted_g=inst.sorted_g[src.to(_I64)],
        starts=torch.clamp_max(astarts, max_aligned),
        counts=torch.minimum(
            torch.clamp_min(counts, 0), torch.clamp_min(max_aligned - astarts, 0)
        ),
        num_instances=inst.num_instances,
        truncated=inst.truncated + torch.clamp_min(total_aligned - max_aligned, 0),
    )


def bin_gaussians(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_instances: int,
    tile_cap: int,
    tile_lo: int = 0,
    n_tiles: Optional[int] = None,
) -> BinnedTiles:
    """Dense (num_tiles, tile_cap) layout on top of `bin_instances` — the
    XLA-style compositor's input. Instances beyond ``tile_cap`` in a tile
    are dropped and counted in ``overflow``."""
    inst = bin_instances(prep, grid_x, grid_y, max_instances, tile_lo, n_tiles)
    k = torch.arange(tile_cap, dtype=_I32, device=inst.counts.device)
    idx = torch.clamp(inst.starts[:, None] + k[None, :], 0, max_instances - 1)
    return BinnedTiles(
        tile_ids=inst.sorted_g[idx.to(_I64)],
        tile_mask=k[None, :] < torch.clamp_max(inst.counts, tile_cap)[:, None],
        tile_counts=inst.counts,
        num_instances=inst.num_instances,
        overflow=torch.sum(torch.clamp_min(inst.counts - tile_cap, 0), dtype=_I32),
        truncated=inst.truncated,
    )
