"""PyTorch port vs JAX reference: the binning layouts beside the packed key
(omnigs_torch/ops/binning.py) — the compact 2-key `bin_instances`, the
ghost-aligned `bin_instances_aligned`, `tile_cover_counts`,
`align_instances`, the dense `bin_gaussians` and `segment_relay` from
Gaussian ids. Both packages bin the SAME preprocessed arrays; every output
is bitwise equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import binning as tbin
from omnigs_torch.ops import preprocess as tpre
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops import binning as jbin
from omnigs_tpu.ops import preprocess as jpre

from torch_helpers import random_cloud_np

W, H = 128, 64
GX, GY = W // 16, H // 16


def _prep_pair(seed, n, scale_mu=-1.5, tie_depths=False):
    """(JAX Preprocessed, torch Preprocessed) holding identical arrays;
    ``tie_depths`` rounds the depths to 0.5 so many instances of a tile
    share one (the stable sort must keep their Gaussian order)."""
    c = random_cloud_np(seed, n, scale_mu=scale_mu)
    pj = jpre.preprocess(
        *[jnp.asarray(c[k]) for k in ("means3d", "scales", "quats", "opacities", "shs")],
        Camera(CameraType.LONLAT, W, H), jnp.eye(4), jnp.zeros(3), 0,
        tight_culling=True,
    )
    arrays = [np.asarray(x).copy() for x in pj]
    if tie_depths:
        i = jpre.Preprocessed._fields.index("depths")
        arrays[i] = (np.round(arrays[i] * 2.0) / 2.0).astype(np.float32)
        assert len(np.unique(arrays[i])) < n // 4
    pt = tpre.Preprocessed(*[torch.from_numpy(a.copy()) for a in arrays])
    pj = jpre.Preprocessed(*[jnp.asarray(a) for a in arrays])
    return pj, pt


def _eq(t, j, name):
    assert t is not None and j is not None, name
    np.testing.assert_array_equal(
        t.numpy().astype(np.int64), np.asarray(j).astype(np.int64), err_msg=name
    )


INST_FIELDS = ("sorted_g", "starts", "counts", "num_instances", "truncated")
EMIT_FIELDS = ("sorted_e", "seg_lo", "seg_hi")


def _check_inst(it, ij, with_emission):
    for f in INST_FIELDS + (EMIT_FIELDS if with_emission else ()):
        _eq(getattr(it, f), getattr(ij, f), f)
    for f in ("perm", "inv_perm", "sorted_key") + (() if with_emission else EMIT_FIELDS):
        assert getattr(it, f) is None and getattr(ij, f) is None, f
    assert it.sorted_g.dtype == torch.int32 and it.counts.dtype == torch.int32


BIN_CASES = {
    # (seed, n, max_instances, tile_cull, with_emission, tie_depths)
    "plain": (31, 160, 1 << 12, False, False, False),
    "cull": (31, 160, 1 << 12, True, False, False),
    "emission": (32, 160, 1 << 12, False, True, False),
    "cull_emission": (32, 160, 1 << 12, True, True, False),
    "ragged_cap": (33, 96, 3001, True, False, False),
    "truncated": (34, 160, 300, True, True, False),
    "equal_depths": (35, 160, 1 << 12, True, True, True),
    "live_bound_cap": (36, 96, 3 << 16, True, False, False),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_instances_matches(case):
    seed, n, cap, cull, emission, ties = BIN_CASES[case]
    pj, pt = _prep_pair(seed, n, tie_depths=ties)
    ij = jbin.bin_instances(pj, GX, GY, cap, tile_cull=cull, with_emission=emission)
    it = tbin.bin_instances(pt, GX, GY, cap, tile_cull=cull, with_emission=emission)
    _check_inst(it, ij, emission)
    assert int(it.num_instances) > 0
    assert (int(it.truncated) > 0) == (case == "truncated")


def test_bin_instances_tile_window():
    """A window [tile_lo, tile_lo + n_tiles) of the grid, as a tile shard
    bins it."""
    pj, pt = _prep_pair(37, 160)
    ij = jbin.bin_instances(pj, GX, GY, 1 << 12, tile_lo=5, n_tiles=17, tile_cull=True)
    it = tbin.bin_instances(pt, GX, GY, 1 << 12, tile_lo=5, n_tiles=17, tile_cull=True)
    _check_inst(it, ij, False)
    assert it.counts.shape == (17,)


ALIGNED_CASES = {
    # (seed, n, max_instances, chunk, tile_cull, with_emission)
    "chunk8": (41, 160, 1 << 12, 8, False, False),
    "chunk128_cull": (41, 160, 1 << 12, 128, True, False),
    "chunk128_cull_emission": (42, 160, 1 << 12, 128, True, True),
    "truncated_prefix": (43, 160, 400, 8, False, True),
    "truncated_prefix_cull": (43, 160, 250, 128, True, False),
}


@pytest.mark.parametrize("case", list(ALIGNED_CASES))
def test_bin_instances_aligned_matches(case):
    seed, n, cap, chunk, cull, emission = ALIGNED_CASES[case]
    pj, pt = _prep_pair(seed, n)
    ij = jbin.bin_instances_aligned(pj, GX, GY, cap, chunk, with_emission=emission,
                                    tile_cull=cull)
    it = tbin.bin_instances_aligned(pt, GX, GY, cap, chunk, with_emission=emission,
                                    tile_cull=cull)
    _check_inst(it, ij, emission)
    starts, counts = it.starts.numpy(), it.counts.numpy()
    padded = -(-counts // chunk) * chunk
    assert (starts % chunk == 0).all()
    np.testing.assert_array_equal(starts, np.cumsum(padded) - padded)
    assert counts.sum() == int(it.num_instances) <= cap
    truncated = int(it.truncated)
    assert (truncated > 0) == case.startswith("truncated")
    if truncated:
        # the dropped instances are a contiguous suffix of the emission
        tiles = pt.tiles_touched.numpy() if not cull else tbin._precull_masks(pt, GX)[2].numpy()
        kept = np.cumsum(tiles) <= cap
        assert counts.sum() == tiles[kept].sum()
    # ghost lanes (past each tile's count in its padded run) carry id 0
    g = it.sorted_g.numpy()
    for t in np.flatnonzero(padded > counts):
        assert (g[starts[t] + counts[t] : starts[t] + padded[t]] == 0).all()


def test_tile_cover_counts_and_align_instances():
    pj, pt = _prep_pair(44, 160)
    emit_j, emit_t = pj.tiles_touched > 0, pt.tiles_touched > 0
    _eq(tbin.tile_cover_counts(pt.rect, emit_t, GX, GY),
        jbin.tile_cover_counts(pj.rect, emit_j, GX, GY), "cover")
    _eq(tbin.tile_cover_counts(pt.rect, emit_t, GX, GY, tile_lo=3, n_tiles=20),
        jbin.tile_cover_counts(pj.rect, emit_j, GX, GY, tile_lo=3, n_tiles=20), "window")
    ij = jbin.bin_instances(pj, GX, GY, 1 << 12)
    it = tbin.bin_instances(pt, GX, GY, 1 << 12)
    # the rect-cover counts are the uncull'd binning's per-tile counts
    _eq(it.counts, jbin.tile_cover_counts(pj.rect, emit_j, GX, GY), "cover = counts")
    for chunk, max_aligned in ((8, 1 << 13), (128, 1 << 13), (128, 1024)):
        aj = jbin.align_instances(ij, chunk, max_aligned)
        at = tbin.align_instances(it, chunk, max_aligned)
        for f in INST_FIELDS:
            _eq(getattr(at, f), getattr(aj, f), f"{f} chunk {chunk} cap {max_aligned}")
        if max_aligned == 1024:
            assert int(at.truncated) > 0


@pytest.mark.parametrize("tile_cap", [64, 8], ids=["fits", "overflow"])
def test_bin_gaussians_matches(tile_cap):
    pj, pt = _prep_pair(45, 160)
    bj = jbin.bin_gaussians(pj, GX, GY, 1 << 12, tile_cap)
    bt = tbin.bin_gaussians(pt, GX, GY, 1 << 12, tile_cap)
    for f in tbin.BinnedTiles._fields:
        _eq(getattr(bt, f), getattr(bj, f), f)
    assert bt.tile_mask.dtype == torch.bool
    assert (int(bt.overflow) > 0) == (tile_cap == 8)


@pytest.mark.parametrize("r8", [1 << 12, 256, 3 << 16], ids=["fits", "trimmed", "live_bound"])
def test_segment_relay_without_key_matches(r8):
    """The relay of `bin_instances` (Gaussian ids, no packed key): validity
    from the telescoped segment ends, one gather of ``sorted_g``."""
    pj, pt = _prep_pair(46, 160)
    ij = jbin.bin_instances(pj, GX, GY, 1 << 12, tile_cull=True)
    it = tbin.bin_instances(pt, GX, GY, 1 << 12, tile_cull=True)
    sj = jbin.segment_relay(ij.sorted_g, None, ij.starts, ij.counts, r8, 160)
    st = tbin.segment_relay(it.sorted_g, it.starts, it.counts, r8, 160)
    assert sj.e8 is None
    for f in ("sorted_g8", "starts8", "counts", "truncated", "live8", "ride_d", "ride_t"):
        _eq(getattr(st, f), getattr(sj, f), f)
    assert (int(st.truncated) > 0) == (r8 == 256)
