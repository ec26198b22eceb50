"""Kernel #8's walk (omnigs_torch/csrc/kernel_ablate.cu) on the CPU, where
the kernel cannot run.

The kernel skips work that the function (`kernel_ablate_plain`, which walks
all 128 lanes of every visited chunk) does: it stages and visits only the
lanes below the count and below rpad, a warp visits only the lanes whose
strip bit it has (`strip_mask` at the tiles' origins with the warp's
FWD_STRIP rows, in plain PyTorch `composite_seg._strip_masks`), runs the
log1p tail of nocumsum, lowprec and full only where a pixel of the warp is
live, and in ``full`` a warp
whose pixels all have N < 1e-4 skips the chunk; ``dma`` sums each row once
per tile and chunk. A plain mirror of those rules, with the kernel's
operations in its order, must give `kernel_ablate_plain`'s output bit for
bit in all six modes: the skips are exact. The strip mask keeps every live
pair of the slabs. The plain version's counters (live pairs, lanes walked)
are the mirror's. Every ablation of `kernel_variants.ABLATE_ABLATIONS` edits
the kernel's source once.

The kernel itself is held to `kernel_ablate_plain` bit for bit on the card
(tests/test_torch_kernels_gpu.py); the plain version to the TPU kernel in
interpret mode (tests/test_torch_script_kernels.py)."""

import numpy as np
import pytest
import torch

from omnigs_torch.ops import composite_seg as tcs
from omnigs_torch.ops import composite_tile as tct
from omnigs_torch.scripts import kernel_ablate as tka
from omnigs_torch.utils import kernel_variants

from torch_helpers import ablate_slab_np

CHUNK, PX, TILE = tka.CHUNK, tcs.PX, tcs.TILE
STRIP = tcs.FWD_STRIP  # pixel rows of a kernel warp


def _ghost_zero_slab():
    """Pad lanes holding Gaussian 0's row (the ghost layout), a fifth of the
    lanes at opacity 0 and some all-zero rows inside the segments."""
    slab, starts, counts, x0, y0 = ablate_slab_np(65)
    rng = np.random.default_rng(65)
    lane = np.arange(slab.shape[1])
    owner = np.clip(np.searchsorted(starts, lane, side="right") - 1, 0, None)
    ghost = lane >= starts[owner] + counts[owner]
    slab[:, ghost] = slab[:, :1]
    slab[5, rng.uniform(size=lane.shape) < 0.2] = 0.0
    slab[:9, rng.uniform(size=lane.shape) < 0.05] = 0.0
    return slab, starts, counts, x0, y0


def _past_rpad_slab():
    """The last tile's segment (129 lanes) runs past the slab's end."""
    slab, starts, counts, x0, y0 = ablate_slab_np(66)
    rpad = int(starts[-1]) + 70
    assert counts[-1] > rpad - starts[-1]
    return np.ascontiguousarray(slab[:, :rpad]), starts, counts, x0, y0


def _unaligned_slab():
    """Segments at unaligned starts, a chunk reaching into the next
    tile's lanes; counts of 1, 0, 33, 31 and 255 lanes."""
    gaps = np.random.default_rng(67).integers(1, 60, size=8)
    return ablate_slab_np(67, counts=(1, 0, 33, 129, 31, 255, 97, 300), gaps=gaps)


SLABS = {
    "seed62": lambda: ablate_slab_np(62),
    "seed63": lambda: ablate_slab_np(63),
    "seed64": lambda: ablate_slab_np(64, counts=(300, 256, 40, 512, 1, 0, 130, 384)),
    "ghost_zero": _ghost_zero_slab,
    "past_rpad": _past_rpad_slab,
    "unaligned": _unaligned_slab,
}


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _staged_counts(slab, starts, counts):
    """(T,) int32: the lanes of each segment that lie below rpad."""
    room = torch.clamp(slab.shape[1] - starts.to(torch.int64), min=0)
    return torch.minimum(counts.to(torch.int64), room).to(torch.int32)


def _dma_mirror(slab, starts, counts):
    """dma as the kernel takes it: per tile and chunk the three row sums of
    its 128 staged lanes (0 at or past rpad), each in lane order, added to
    the tile's totals, which every pixel gets."""
    rpad = slab.shape[1]
    out = torch.zeros(counts.shape[0], 3, PX)
    for t in range(counts.shape[0]):
        total = [torch.zeros(()) for _ in range(3)]
        for c in range(-(-int(counts[t]) // CHUNK)):
            base = int(starts[t]) + c * CHUNK
            for q in range(3):
                s = torch.zeros(())
                for k in range(CHUNK):
                    s = s + (slab[q, base + k] if base + k < rpad else torch.zeros(()))
                total[q] = total[q] + s
        out[t] = torch.stack(total)[:, None]
    return out


def _mirror(mode, slab, starts, counts, x0, y0):
    """The kernel's walk in plain PyTorch → (color (T, 3, PX), live (T,)
    live pairs of the walked chunks, walked (T, PX) lanes each pixel's warp
    walks before its strip test, visits: warp-lane visits after it, tails:
    warp-lane visits that run the mode's tail). Every carried value is
    updated only where the kernel updates it: at the lanes below the count
    and rpad, for a warp whose strip bit the lane has, whose warp has a
    live pixel there (the log1p tail) and, in ``full``, that had a pixel at
    N ≥ 1e-4 at the chunk's start."""
    if mode == "dma":
        return _dma_mirror(slab, starts, counts), None, None, 0, 0
    num_tiles = counts.shape[0]
    rpad = slab.shape[1]
    nw, strip = TILE // STRIP, TILE * STRIP
    px, py = tct._tile_pixels(x0, y0)
    n = torch.ones(num_tiles, PX)
    color = torch.zeros(num_tiles, 3, PX)
    masks = tcs._strip_masks(slab, starts, _staged_counts(slab, starts, counts), x0, y0,
                             STRIP)
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    lane = torch.arange(CHUNK)
    warp = torch.arange(nw)
    live_pairs = torch.zeros(num_tiles, dtype=torch.int64)
    walked = torch.zeros(num_tiles, PX, dtype=torch.int64)
    visits = tails = 0

    def to_pixels(per_warp):
        return per_warp.repeat_interleave(strip, dim=1)

    for c in range(int(n_chunks.max())):
        go = (c < n_chunks) & (n >= tcs.T_STOP).any(dim=1)
        if not bool(go.any()):
            break
        base = starts.to(torch.int64) + c * CHUNK
        m = torch.minimum(torch.clamp(counts.to(torch.int64) - c * CHUNK, 0, CHUNK),
                          rpad - base)
        at = base[:, None] + lane
        staged = lane < m[:, None]
        at = torch.where(staged, at, 0)
        d = slab[:9, at]
        bits = torch.where(staged, masks[at], 0)
        warp_on = go[:, None].expand(-1, nw)
        if mode == "full":
            warp_on = warp_on & (n >= tcs.T_STOP).reshape(num_tiles, nw, strip).any(dim=2)
        walked += to_pixels(torch.where(warp_on, torch.clamp(m, min=0)[:, None], 0))
        total, cs, wr, wg, wb = (torch.zeros(num_tiles, PX) for _ in range(5))
        for k in range(CHUNK):
            x, y, A, B, C, op, r, g, b = (d[q, :, k, None] for q in range(9))
            dx = x - px
            dy = y - py
            power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
            alpha = torch.clamp_max(op * torch.exp(torch.clamp_max(power, 0.0)),
                                    tcs.ALPHA_MAX)
            live = staged[:, k, None] & (power <= 0.0) & (alpha >= tcs.ALPHA_MIN)
            live_pairs += torch.where(go, live.sum(dim=1), 0)
            a = torch.where(live, alpha, 0.0)
            visit = warp_on & staged[:, k, None] & (((bits[:, k, None] >> warp) & 1) == 1)
            visits += int(visit.sum())
            if mode == "alpha":
                total = torch.where(to_pixels(visit), total + a, total)
                continue
            if mode != "notrans":
                visit = visit & live.reshape(num_tiles, nw, strip).any(dim=2)
            tails += int(visit.sum())
            on = to_pixels(visit)
            if mode == "notrans":
                cs_new = cs + (-a)
                w = a * (n * (1.0 + cs_new))
                total_new = total + a
            else:
                l = torch.log1p(-a)
                total_new = total + l
                cs_new = cs
                if mode == "nocumsum":
                    w = a * (n * torch.exp(l))
                elif mode == "lowprec":
                    cs_new = cs + tka._bf16(l)
                    w = tka._bf16(a * (n * torch.exp(cs_new)))
                    r, g, b = tka._bf16(r), tka._bf16(g), tka._bf16(b)
                else:  # full
                    cs_new = cs + l
                    n_incl = n * torch.exp(cs_new)
                    w = a * (n_incl / (1.0 - a)) * (n_incl >= tcs.T_STOP).to(a.dtype)
            total = torch.where(on, total_new, total)
            cs = torch.where(on, cs_new, cs)
            wr = torch.where(on, wr + r * w, wr)
            wg = torch.where(on, wg + g * w, wg)
            wb = torch.where(on, wb + b * w, wb)
        if mode == "alpha":
            dc, n_new = total[:, None, :].expand(-1, 3, -1), n * 0.9999
        else:
            dc = torch.stack([wr, wg, wb], dim=1)
            n_new = n * (1.0 - total * 1e-6) if mode == "notrans" else n * torch.exp(total)
        color = torch.where(go[:, None, None], color + dc, color)
        n = torch.where(go[:, None], n_new, n)
    return color, live_pairs, walked, visits, tails


@pytest.mark.parametrize("mode", tka.MODES)
@pytest.mark.parametrize("kind", sorted(SLABS))
def test_kernel_walk_mirror_matches_plain_bitwise(kind, mode):
    slab, starts, counts, x0, y0 = _torch(SLABS[kind]())
    ref, visited, live, walked = tka.kernel_ablate_plain(mode, slab, starts, counts, x0, y0)
    got, m_live, m_walked, visits, tails = _mirror(mode, slab, starts, counts, x0, y0)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (kind, mode)
    assert float(ref.abs().max()) > 0
    if mode == "dma":
        return
    # the plain version's counters are the kernel's walk: the live pairs of
    # the visited chunks; the lanes below the count each warp walks (where
    # the slab ends early, the kernel stages fewer)
    assert torch.equal(m_live, live)
    short = (starts.to(torch.int64) + counts > slab.shape[1]).any()
    assert torch.equal(m_walked, walked) if not short else bool((m_walked <= walked).all())
    # the skips skip: the strip test drops warp-lane visits, the live
    # ballot the log1p tails of some of the visited ones
    lanes = int(walked[:, ::TILE * STRIP].sum())
    assert visits < lanes, (visits, lanes)
    assert tails < visits if mode in ("nocumsum", "lowprec", "full") else tails in (0, visits)


@pytest.mark.parametrize("kind", sorted(SLABS))
def test_strip_mask_keeps_every_live_pair_of_ablate_slabs(kind):
    """At every staged lane of a segment (below the count and rpad) and
    every pixel of its tile where the pair is live under the kernel's float32
    operations, the mask has the bit of the pixel's FWD_STRIP-row strip."""
    slab, starts, counts, x0, y0 = _torch(SLABS[kind]())
    staged = _staged_counts(slab, starts, counts)
    mask = tcs._strip_masks(slab, starts, staged, x0, y0, STRIP)
    px, py = tct._tile_pixels(x0, y0)
    nw, strip = TILE // STRIP, TILE * STRIP
    kept = total = 0
    for t in range(counts.shape[0]):
        lanes = torch.arange(int(starts[t]), int(starts[t]) + int(staged[t]))
        d = slab[:6, lanes][:, :, None]
        dx = d[0] - px[t]
        dy = d[1] - py[t]
        power = -0.5 * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy
        alpha = torch.clamp_max(d[5] * torch.exp(torch.clamp_max(power, 0.0)), tcs.ALPHA_MAX)
        live = ((power <= 0.0) & (alpha >= tcs.ALPHA_MIN)).reshape(-1, nw, strip).any(dim=2)
        has = ((mask[lanes, None] >> torch.arange(nw)) & 1) == 1
        assert not bool((live & ~has).any()), (kind, t)
        kept += int(has.sum())
        total += has.numel()
    # and the test culls: some strips are dropped (the slabs' splats are
    # wide against the tile: 1.5-6 px around it)
    assert 0 < kept < total, (kept, total)


def test_ablate_ablations_edit_the_kernel_once(tmp_path, monkeypatch):
    """Each ablation of #8 edits csrc/kernel_ablate.cu once and turns one
    design element off; #8 includes the shared walk header, so the walk's
    `no_cull` and `fwd_rows_1` act on it too."""
    monkeypatch.setattr(kernel_variants, "VARIANT_DIR", tmp_path)
    assert set(kernel_variants.ABLATE_ABLATIONS) == {
        "no_count_trim", "no_live_skip", "no_warp_stop", "dma_per_thread"}
    for name, edits in kernel_variants.ABLATE_ABLATIONS.items():
        tree = kernel_variants._variant_tree(name, edits)
        assert {f for f, _, _ in edits} == {"kernel_ablate.cu"}
        text = (tree / "kernel_ablate.cu").read_text()
        for _, old, new in edits:
            assert new in text and old not in text, name
            assert "= false;" in new, name
    src = (kernel_variants.cuda_build.CSRC / "kernel_ablate.cu").read_text()
    assert '#include "composite_seg_walk.cuh"' in src
    assert "omnigs_seg::stage_batch<CHUNK, FWD_THREADS, FWD_STRIP>" in src
    assert {"no_cull", "fwd_rows_1"} <= set(kernel_variants.ABLATE_WALK_ABLATIONS)
