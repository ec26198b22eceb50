"""PyTorch port vs JAX reference: packed-key binning and the segmented
re-lay (omnigs_torch/ops/binning.py). Both packages bin the SAME
preprocessed arrays; every integer output must be bitwise equal — sorted
ranks and keys, tile ranges, depth permutations, truncation counters and
every SegLayout field."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.ops import binning as tbin
from omnigs_torch.ops import preprocess as tpre
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops import binning as jbin
from omnigs_tpu.ops import preprocess as jpre

from torch_helpers import launches, random_cloud_np

W, H = 128, 64
GX, GY = W // 16, H // 16


def _prep_pair(seed, n, scale_mu=-1.5, spread=4.0, w=W, h=H):
    """(JAX Preprocessed, torch Preprocessed) holding identical arrays."""
    c = random_cloud_np(seed, n, scale_mu=scale_mu, spread=spread)
    pj = jpre.preprocess(
        *[jnp.asarray(c[k]) for k in ("means3d", "scales", "quats", "opacities", "shs")],
        Camera(CameraType.LONLAT, w, h), jnp.eye(4), jnp.zeros(3), 0,
        tight_culling=True,
    )
    arrays = [np.asarray(x) for x in pj]
    pt = tpre.Preprocessed(*[torch.from_numpy(a.copy()) for a in arrays])
    pj = jpre.Preprocessed(*[jnp.asarray(a) for a in arrays])
    return pj, pt


def _eq(t, j, name):
    np.testing.assert_array_equal(
        t.numpy().astype(np.int64), np.asarray(j).astype(np.int64), err_msg=name
    )


def _check_packed(pj, pt, max_instances, tile_cull, gx=GX, gy=GY):
    ij = jbin.bin_instances_packed(pj, gx, gy, max_instances, tile_cull=tile_cull)
    it = tbin.bin_instances_packed(pt, gx, gy, max_instances, tile_cull=tile_cull)
    for f in ("sorted_g", "starts", "counts", "perm", "inv_perm", "sorted_key",
              "truncated", "num_instances"):
        _eq(getattr(it, f), getattr(ij, f), f)
    assert it.sorted_g.dtype == torch.int32 and it.counts.dtype == torch.int32
    return ij, it


def _check_relay(ij, it, r8, p):
    sj = jbin.segment_relay(
        ij.sorted_g, None, ij.starts, ij.counts, r8, p, sorted_key=ij.sorted_key
    )
    st = tbin.segment_relay(it.sorted_g, it.starts, it.counts, r8, p, it.sorted_key)
    for f in ("sorted_g8", "starts8", "counts", "truncated", "live8",
              "ride_d", "ride_t"):
        _eq(getattr(st, f), getattr(sj, f), f)
    return st


@pytest.mark.parametrize("tile_cull", [False, True])
def test_bin_packed_and_relay_match(tile_cull):
    pj, pt = _prep_pair(21, 160)
    ij, it = _check_packed(pj, pt, 1 << 12, tile_cull)
    assert int(it.truncated) == 0 and int(it.num_instances) > 0
    st = _check_relay(ij, it, 1 << 12, 160)
    assert int(st.truncated) == 0


def test_forced_truncation():
    """Emission beyond max_instances is dropped in depth order and counted;
    a tight r8 cap drops whole tiles, also counted."""
    pj, pt = _prep_pair(22, 160)
    ij, it = _check_packed(pj, pt, 300, True)
    assert int(it.truncated) > 0
    st = _check_relay(ij, it, 256, 160)
    assert int(st.truncated) > 0


def test_superblock_masks_and_bit31():
    """Big Gaussians (rect > 64 tiles) take the superblock path; with > 31
    blocks the low mask word's bit 31 (the int32 sign bit) is set."""
    pj, pt = _prep_pair(23, 48, scale_mu=-0.7, spread=1.0, w=256, h=128)
    assert int(pt.tiles_touched.max()) > jbin.MASK_TILES
    mj = jbin._precull_masks(pj, 16)
    mt = tbin._precull_masks(pt, 16)
    for name, a, b in zip(("lo", "hi", "tiles_eff", "sx", "sy", "wb"), mt, mj):
        _eq(a, b, name)
    assert bool((mt[0] < 0).any()), "no mask with bit 31 set"
    assert bool((mt[3] > 1).any()), "no superblock rect"
    ij, it = _check_packed(pj, pt, 1 << 13, True, 16, 8)
    _check_relay(ij, it, 1 << 13, 48)


def test_precull_on_the_cpu_takes_the_plain_version():
    """CPU tensors take `_precull_masks_plain` (the JAX parity tests hold
    it) and launch nothing, through the binning too; the kernel's wrapper
    refuses them."""
    _, pt = _prep_pair(23, 48, scale_mu=-0.7, spread=1.0, w=256, h=128)
    before = launches("precull")
    got = tbin._precull_masks(pt, 16)
    tbin.bin_instances_packed(pt, 16, 8, 1 << 13, tile_cull=True)
    assert launches("precull") == before
    for a, b in zip(got, tbin._precull_masks_plain(pt, 16)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    with pytest.raises(ValueError, match="pre-cull kernel takes"):
        tbin.precull(pt)


@pytest.mark.parametrize("name,value", [("MASK_TILES", tbin.MASK_TILES), ("TILE", tpre.TILE)])
def test_precull_source_constants_match_the_package(name, value):
    """`csrc/precull.cu` states the mask width and the tile edge the plain
    version takes from `binning` and `preprocess`."""
    src = (Path(tbin.__file__).resolve().parent.parent / "csrc" / "precull.cu").read_text()
    assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value


def _expand_args(pt, tile_cull, gx=16, gy=8, slots=1 << 13):
    """The expansion's inputs as `bin_instances_packed` builds them."""
    tiles, cull = tbin._emission_budget(pt, gx, tile_cull)
    return pt, cull, *tbin._depth_ranks(pt.depths, tiles), slots, gx, gx * gy


@pytest.mark.parametrize("tile_cull", [False, True])
def test_expand_keys_on_the_cpu_takes_the_plain_version(tile_cull):
    """CPU tensors take `_expand_keys_plain` (the JAX parity tests hold it)
    and launch nothing, through the binning too; the kernel's wrapper
    refuses them."""
    _, pt = _prep_pair(23, 48, scale_mu=-0.7, spread=1.0, w=256, h=128)
    args = _expand_args(pt, tile_cull)
    before = launches("expand_keys")
    got = tbin._packed_keys(*args)
    tbin.bin_instances_packed(pt, 16, 8, 1 << 13, tile_cull=tile_cull, with_emission=True)
    assert launches("expand_keys") == before
    assert got.dtype == torch.int64 and torch.equal(got, tbin._expand_keys_plain(*args))
    assert int(((got >> tbin.RANK_BITS) < 128).sum()) > 0
    with pytest.raises(ValueError, match="runs on one CUDA device"):
        tbin.expand_keys(*args)


@pytest.mark.parametrize("fault", ["perm_int64", "offsets_short", "rect_wide", "cull_four",
                                   "conic_f64", "no_rows", "slots_2_24"])
def test_expand_keys_refuses_what_it_does_not_take(fault):
    """The wrapper checks dtypes, shapes and the slot count before it looks
    for a card."""
    _, pt = _prep_pair(23, 48, scale_mu=-0.7, spread=1.0, w=256, h=128)
    a = list(_expand_args(pt, True))
    if fault == "perm_int64":
        a[2] = a[2].long()
    elif fault == "offsets_short":
        a[4] = a[4][:-1]
    elif fault == "rect_wide":
        a[0] = pt._replace(rect=torch.cat([pt.rect, pt.rect[:, :1]], 1))
    elif fault == "cull_four":
        a[1] = a[1][:4]
    elif fault == "conic_f64":
        a[0] = pt._replace(conic=pt.conic.double())
    elif fault == "no_rows":
        a[2:5] = [t[:0] for t in a[2:5]]
    else:
        a[5] = 1 << 24
    with pytest.raises(ValueError, match="the expansion kernel takes"):
        tbin.expand_keys(*a)


@pytest.mark.parametrize("name,value", [("MASK_TILES", tbin.MASK_TILES), ("TILE", tpre.TILE),
                                        ("RANK_BITS", tbin.RANK_BITS),
                                        ("LIVE_CHUNK", tbin._LIVE_CHUNK)])
def test_expand_keys_source_constants_match_the_package(name, value):
    """`csrc/expand_keys.cu` states the mask width, the tile edge, the key's
    rank bits and the live-bound chunk the plain version takes from the
    package."""
    src = (Path(tbin.__file__).resolve().parent.parent / "csrc" / "expand_keys.cu").read_text()
    assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value


def test_one_alpha_test_header_for_both_binning_kernels():
    """The pre-cull and the expansion take the ellipse-box alpha test from
    `csrc/alpha_box.cuh`; neither source writes its own."""
    csrc = Path(tbin.__file__).resolve().parent.parent / "csrc"
    header = (csrc / "alpha_box.cuh").read_text()
    for fn in ("min_quad_over_box", "alpha_reaches_min"):
        assert re.search(rf"__device__ __forceinline__ \w+ {fn}\(", header), fn
    for name in ("precull.cu", "expand_keys.cu"):
        src = (csrc / name).read_text()
        assert '#include "alpha_box.cuh"' in src, name
        assert "alpha_box::min_quad_over_box(" in src and "alpha_box::alpha_reaches_min(" in src
        assert "expf(" not in src and "clamp_t(" not in src, name


def test_popcount_and_kth_set_bit():
    rng = np.random.default_rng(24)
    words = rng.integers(-(1 << 31), 1 << 31, size=(2, 400), dtype=np.int64)
    words[:, :4] = [[-1, 1 << 30, -(1 << 31), 0], [-(1 << 31), -1, 5, 0]]
    lo, hi = words.astype(np.int32)
    total = np.array([bin(int(a) & 0xFFFFFFFF).count("1") + bin(int(b) & 0xFFFFFFFF).count("1")
                      for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(
        tbin._popcount32(torch.from_numpy(lo)).numpy()
        + tbin._popcount32(torch.from_numpy(hi)).numpy(),
        total,
    )
    k = (rng.uniform(size=400) * np.maximum(total, 1)).astype(np.int32)
    _eq(
        tbin._kth_set_bit(torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(k)),
        jbin._kth_set_bit(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(k)),
        "kth_set_bit",
    )


def test_live_bound_chunked_caps():
    """Caps that are multiples of 2^16 take the JAX functions' live-bound
    chunk loops; the port's full-width version must leave the same
    sentinels in the lanes those loops never visit."""
    pj, pt = _prep_pair(25, 96)
    cap = 3 << 16
    ij, it = _check_packed(pj, pt, cap, True)
    _check_relay(ij, it, cap, 96)


def test_rejects_packed_key_overflow():
    _, pt = _prep_pair(26, 8)
    with pytest.raises(ValueError, match="overflow"):
        tbin.bin_instances_packed(pt, 8191, 1, 1 << 10)
    assert tpre.tile_grid(TCamera(TCameraType.LONLAT, W, H)) == (GX, GY)
