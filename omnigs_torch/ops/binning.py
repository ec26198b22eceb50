"""Static-shape tile binning for the segmented render path.

Counterpart of the main-path subset of `omnigs_tpu/ops/binning.py`:
superblock pre-culling (`_precull_masks`), the depth-presorted packed-key
binning (`bin_instances_packed`) and the 8-granular slab re-lay
(`segment_relay`). Every integer output is bitwise identical to the JAX
functions' (tests/test_torch_binning.py).

Port notes, where PyTorch differs from `jax.lax`:

* The packed sort keys are uint32 in JAX (``tile << 19 | depth_rank``);
  here they are held as the same values in int64, which PyTorch sorts
  natively on every device.
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
prefix with chunked while-loops (a TPU memory device). Here the gathers run
over the full width, and the lanes the chunked loops never visit are reset
to the same sentinels, so the outputs match bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from omnigs_torch.ops.preprocess import TILE, Preprocessed

MASK_TILES = 64  # pre-emission survivor bitmask width (2 32-bit words)
RANK_BITS = 19  # depth-rank bits in the packed sort key (P ≤ 2^19)
SEG_GRAN = 8  # segment granularity of the segmented-chunk slab layout
# lanes per chunk of the JAX functions' live-bound loops (see module doc)
_LIVE_CHUNK = 1 << 16

_I32 = torch.int32
_I64 = torch.int64


class BinnedInstances(NamedTuple):
    """Instance-major binning result (packed-key path)."""

    sorted_g: torch.Tensor  # (R,) int32 depth rank per instance
    starts: torch.Tensor  # (num_tiles,) int32 first instance of each tile
    counts: torch.Tensor  # (num_tiles,) int32 instances per tile
    num_instances: torch.Tensor  # () int32 total emitted instances
    truncated: torch.Tensor  # () int32 instances dropped by max_instances
    perm: torch.Tensor  # (P,) int32 depth order: gaussian id = perm[rank]
    inv_perm: torch.Tensor  # (P,) int32 rank of each id
    sorted_key: torch.Tensor  # (R,) int64 sorted (tile << RANK_BITS | rank)


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
    Returns (lo, hi, tiles_eff, sx, sy, wb), all (P,) int32.
    """
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


def _live_chunk_bound(n_slots: int, total: torch.Tensor):
    """Slot count the JAX functions' live-bound chunk loops visit, as a
    tensor; None where they run one full-width pass (a ragged or single
    chunk)."""
    n_full = n_slots // _LIVE_CHUNK
    if n_full * _LIVE_CHUNK != n_slots or n_full <= 1:
        return None
    n_chunks = torch.clamp_max((total + _LIVE_CHUNK - 1) // _LIVE_CHUNK, n_full)
    return n_chunks * _LIVE_CHUNK


def bin_instances_packed(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_instances: int,
    tile_cull: bool = False,
) -> BinnedInstances:
    """Compact binning with a depth presort and a single packed sort key.

    Stable-sorting the P Gaussians by depth once makes every tile's
    gaussian-major emission depth-ordered, so the per-instance sort needs
    one unique key ``tile << RANK_BITS | depth_rank``. ``sorted_g`` holds
    depth RANKS; map them to Gaussians with ``perm``. Requires P ≤
    2^RANK_BITS and num_tiles < 2^(32−RANK_BITS) − 1.

    When emission exceeds ``max_instances`` the tail is dropped in depth
    order and counted in ``truncated``.
    """
    num_tiles = grid_x * grid_y
    P = prep.depths.shape[0]
    dev = prep.depths.device
    if P > (1 << RANK_BITS):
        raise ValueError(f"P={P} exceeds the packed key's 2^{RANK_BITS} ranks")
    if num_tiles >= (1 << (32 - RANK_BITS)) - 1:
        raise ValueError(f"{num_tiles} tiles overflow the packed key")
    if max_instances >= 1 << 24:
        raise ValueError("max_instances must stay below 2^24")

    if tile_cull:
        mlo, mhi, tiles, c_sx, c_sy, c_wb = _precull_masks(prep, grid_x)
    else:
        tiles = prep.tiles_touched.to(_I32)

    # stable depth presort: ties keep the original gaussian order, which
    # with gaussian-major emission reproduces a stable (tile, depth) sort
    perm = torch.sort(prep.depths, stable=True).indices.to(_I32)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm.to(_I64)] = torch.arange(P, dtype=_I32, device=dev)
    perm_l = perm.to(_I64)
    tiles_d = tiles[perm_l]

    offsets_d = _cumsum32(tiles_d) - tiles_d
    total = offsets_d[-1] + tiles_d[-1]
    j = torch.arange(max_instances, dtype=_I32, device=dev)
    # slot → owning depth rank: (# emission offsets ≤ j) − 1
    g = torch.searchsorted(offsets_d, j, right=True).to(_I32) - 1
    g = torch.clamp(g, 0, P - 1)
    gl = g.to(_I64)

    rect_d = prep.rect[perm_l][gl]  # (R, 4) int32
    x0, y0, x1, y1 = rect_d.unbind(-1)
    local = j - offsets_d[gl]
    if tile_cull:
        ints = torch.stack([mlo, mhi, c_sx, c_sy, c_wb], dim=-1)[perm_l][gl]
        lo_m, hi_m, sx, sy, wb = ints.unbind(-1)
        tx, ty, in_rect = _hier_decode(
            x0, y0, x1, y1, sx, sy, wb, lo_m, hi_m, local
        )
    else:
        width = torch.clamp_min(x1 - x0, 1)
        tx = x0 + local % width
        ty = y0 + local // width
    tid = ty * grid_x + tx
    keep = (j < total) & (tid >= 0) & (tid < num_tiles)
    if tile_cull:
        floats = torch.cat(
            [prep.means2d, prep.conic, prep.opacity[:, None]], dim=-1
        )[perm_l][gl]
        mx, my, cA, cB, cC, op = floats.unbind(-1)
        px0 = (tx * TILE).to(torch.float32)
        py0 = (ty * TILE).to(torch.float32)
        qmin = _min_quad_over_box(
            cA, cB, cC,
            px0 - mx, px0 + (TILE - 1) - mx,
            py0 - my, py0 + (TILE - 1) - my,
        )
        keep = keep & in_rect & _alpha_reaches_min(op, qmin)
    tid = torch.where(keep, tid, torch.full_like(tid, num_tiles))
    key = (tid.to(_I64) << RANK_BITS) | g.to(_I64)
    bound = _live_chunk_bound(max_instances, total)
    if bound is not None:
        dead_key = num_tiles << RANK_BITS
        key = torch.where(j < bound, key, torch.full_like(key, dead_key))

    skey = torch.sort(key).values
    sorted_g = (skey & ((1 << RANK_BITS) - 1)).to(_I32)
    sorted_tile = (skey >> RANK_BITS).to(_I32)

    tids = torch.arange(num_tiles, dtype=_I32, device=dev)
    starts = torch.searchsorted(sorted_tile, tids, right=False).to(_I32)
    ends = torch.searchsorted(sorted_tile, tids, right=True).to(_I32)
    counts = ends - starts

    return BinnedInstances(
        sorted_g=sorted_g,
        starts=starts,
        counts=counts,
        num_instances=torch.sum(counts, dtype=_I32),
        truncated=torch.clamp_min(total - max_instances, 0),
        perm=perm,
        inv_perm=inv_perm,
        sorted_key=skey,
    )


def segment_relay(
    sorted_g: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    r8: int,
    p_sentinel: int,
    sorted_key: torch.Tensor,
) -> SegLayout:
    """Re-lay the compact sorted slab to SEG_GRAN-aligned per-tile segments
    (the packed-key payload path of the JAX function).

    Per-slot fields come from telescoped scatter+cumsum passes; the rank of
    each slot is one gather of ``sorted_key``, and a lane is live iff the
    gathered key's tile field matches the lane's own tile. Tiles whose
    padded segment would cross ``r8`` are dropped deterministically and
    counted in ``truncated``.
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
    # trimmed tiles carry the num_tiles sentinel so their lanes fail the
    # source-tile validity test below
    tid_vals = torch.where(
        fits, torch.arange(t, dtype=_I32, device=dev), torch.full_like(counts, t)
    )
    packed_dt = _at_slots((torch.clamp(pos, 0, t) << 13) | tid_vals)
    ride_d = packed_dt >> 13
    ride_t = packed_dt & ((1 << 13) - 1)
    j = torch.arange(r8, dtype=_I32, device=dev)
    src_raw = j - shift_at
    src = torch.clamp(src_raw, 0, r - 1)
    kv = sorted_key[src.to(_I64)]
    ok = ((kv >> RANK_BITS) == ride_t.to(_I64)) & (src_raw < r)
    sorted_g8 = torch.where(
        ok,
        (kv & ((1 << RANK_BITS) - 1)).to(_I32),
        torch.full_like(j, p_sentinel),
    )
    bound = _live_chunk_bound(r8, live8)
    if bound is not None:
        sorted_g8 = torch.where(
            j < bound, sorted_g8, torch.full_like(sorted_g8, p_sentinel)
        )
    return SegLayout(
        sorted_g8=sorted_g8,
        starts8=starts8,
        counts=counts8,
        truncated=truncated,
        live8=live8,
        ride_d=ride_d,
        ride_t=ride_t,
    )
