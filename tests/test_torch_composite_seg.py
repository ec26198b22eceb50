"""PyTorch port vs JAX reference: the segmented compositing forward
(omnigs_torch/ops/composite_seg.py) on the SAME slab.

The plain PyTorch `composite_seg_fwd` (what the wrapper runs for CPU
tensors) is held against `pallas_seg.composite_seg_fwd` in Pallas
interpret mode at atol 1e-5 (2e-5 with multi-chunk tiles, as
tests/test_pallas_seg.py holds the segmented kernels to the tile-major
ones): the log-domain transmittance differs only in summation order. The
backward is held against JAX in tests/test_torch_composite_seg_bwd.py; the
CUDA kernels against the plain versions on the card in
tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import composite_seg as tcs
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops import binning as jbin
from omnigs_tpu.ops import pallas_seg as jseg
from omnigs_tpu.ops import preprocess as jpre

from torch_helpers import random_cloud_np


def _slab_case(seed, n, w=128, h=64, squeeze=None, max_instances=1 << 12):
    """JAX pipeline → (layout arrays, per-Gaussian arrays) as numpy."""
    c = random_cloud_np(seed, n)
    if squeeze is not None:
        c["means3d"] = c["means3d"] * np.asarray(squeeze, np.float32)
    gx, gy = w // 16, h // 16
    prep = jpre.preprocess(
        *[jnp.asarray(c[k]) for k in ("means3d", "scales", "quats", "opacities", "shs")],
        Camera(CameraType.LONLAT, w, h), jnp.eye(4), jnp.zeros(3), 2,
        tight_culling=True,
    )
    inst = jbin.bin_instances_packed(prep, gx, gy, max_instances, tile_cull=True)
    seg = jbin.segment_relay(
        inst.sorted_g, None, inst.starts, inst.counts, max_instances, n,
        sorted_key=inst.sorted_key,
    )
    lay = {k: np.array(getattr(seg, k)) for k in
           ("sorted_g8", "starts8", "counts", "live8", "ride_d", "ride_t")}
    lay["perm"] = np.array(inst.perm)
    lay.update(gx=gx, num_tiles=gx * gy)
    gauss = {k: np.array(getattr(prep, k)) for k in ("means2d", "conic", "rgb", "opacity")}
    return lay, gauss


def _build_both(lay, g):
    sj = jseg._build_inst_seg(
        *[jnp.asarray(g[k]) for k in ("means2d", "conic", "rgb", "opacity")],
        jnp.asarray(lay["sorted_g8"]), jnp.asarray(lay["live8"]),
        jnp.asarray(lay["perm"]), jnp.asarray(lay["ride_d"]), jnp.asarray(lay["ride_t"]),
    )
    st = tcs._build_inst_seg(
        *[torch.from_numpy(g[k]) for k in ("means2d", "conic", "rgb", "opacity")],
        *[torch.from_numpy(lay[k]) for k in ("sorted_g8", "perm", "ride_d", "ride_t")],
    )
    return np.asarray(sj), st


def _fwd_both(slab, lay, tile_lo=0):
    args = [lay[k] for k in ("starts8", "counts", "live8")]
    cj, tj = jseg.composite_seg_fwd(
        jnp.asarray(slab), *[jnp.asarray(a) for a in args], lay["num_tiles"],
        lay["gx"], interpret=True, tile_lo=tile_lo,
    )
    ct, tt = tcs.composite_seg_fwd(
        torch.from_numpy(np.array(slab)), *[torch.from_numpy(np.array(a)) for a in args],
        lay["num_tiles"], lay["gx"], tile_lo,
    )
    return (np.asarray(cj), np.asarray(tj)), (ct.numpy(), tt.numpy())


CASES = {
    # few Gaussians: many empty tiles
    "sparse": dict(seed=31, n=24, atol=1e-5),
    "dense": dict(seed=32, n=96, atol=1e-5),
    # squeezed toward the equator/front: tiles with hundreds of instances,
    # segments spanning several 128-lane chunks
    "multichunk": dict(seed=33, n=512, squeeze=(0.2, 0.2, 1.0),
                       max_instances=1 << 13, atol=2e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(case):
    kw = dict(CASES[case])
    atol = kw.pop("atol")
    lay, g = _slab_case(**kw)
    slab_j, slab_t = _build_both(lay, g)
    np.testing.assert_array_equal(slab_t.numpy(), slab_j)
    (cj, tj), (ct, tt) = _fwd_both(slab_j, lay)
    np.testing.assert_allclose(ct, cj, atol=atol)
    np.testing.assert_allclose(tt, tj, atol=atol)
    counts = lay["counts"]
    if case == "sparse":
        assert (counts == 0).any()
    if case == "multichunk":
        assert counts.max() > tcs.CHUNK
    empty = counts == 0
    assert (ct[empty] == 0).all() and (tt[empty] == 1).all()


def test_tile_window_offsets_pixels():
    """``tile_lo`` shifts a tile window's pixel coordinates: compositing
    tiles [8, T) as a window equals those tiles of the full grid."""
    lay, g = _slab_case(32, 96)
    _, slab = _build_both(lay, g)
    st8, cnt = (torch.from_numpy(lay[k]) for k in ("starts8", "counts"))
    live8 = torch.from_numpy(lay["live8"])
    full_c, full_t = tcs.composite_seg_fwd(slab, st8, cnt, live8, lay["num_tiles"], lay["gx"])
    win_c, win_t = tcs.composite_seg_fwd(
        slab, st8[8:].contiguous(), cnt[8:].contiguous(), live8,
        lay["num_tiles"] - 8, lay["gx"], 8,
    )
    np.testing.assert_array_equal(win_c.numpy(), full_c[8:].numpy())
    np.testing.assert_array_equal(win_t.numpy(), full_t[8:].numpy())


def test_cpu_backprop_and_launch_count():
    """With inputs that require grad, the call records a gradient and
    back-propagates on the CPU through the plain versions (no kernel
    launch); the forward equals the plain compositor's."""
    lay, g = _slab_case(31, 24)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    args = [torch.from_numpy(np.asarray(lay[k])) for k in
            ("sorted_g8", "starts8", "counts", "live8", "ride_d", "ride_t", "perm")]
    sorted_g8, starts8, counts, live8, ride_d, ride_t, perm = args
    inv_perm = torch.argsort(perm).to(torch.int32)
    bg = torch.full((3,), 0.2)

    def run(means2d):
        return tcs.composite_instances_seg(
            means2d, tg["conic"], tg["rgb"], tg["opacity"], bg, sorted_g8,
            starts8, counts, live8, ride_d, ride_t, perm, inv_perm,
            lay["num_tiles"], lay["gx"],
        )

    fwd, bwd = tcs.composite_seg_fwd.launches, tcs.composite_seg_bwd.launches
    means2d = tg["means2d"].clone().requires_grad_(True)
    color, final_t, ncontrib = run(means2d)
    assert color.requires_grad
    (color * torch.linspace(0.5, 1.5, color.numel()).reshape(color.shape)).sum().backward()
    assert means2d.grad is not None and bool(torch.isfinite(means2d.grad).all())
    assert float(means2d.grad.abs().max()) > 0
    # plain versions, no kernel
    assert tcs.composite_seg_fwd.launches == fwd
    assert tcs.composite_seg_bwd.launches == bwd
    plain_c, plain_t, _, _ = tcs.composite_seg_fwd_plain(
        tcs._build_inst_seg(tg["means2d"], tg["conic"], tg["rgb"], tg["opacity"],
                            sorted_g8, perm, ride_d, ride_t),
        starts8, counts, lay["num_tiles"], lay["gx"],
    )
    np.testing.assert_allclose(
        color.detach().numpy(), (plain_c + plain_t[:, None, :] * 0.2).numpy(),
        atol=1e-7,
    )
    assert (ncontrib == 0).all()
