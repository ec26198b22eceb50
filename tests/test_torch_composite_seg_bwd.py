"""PyTorch port vs JAX reference: the segmented compositing backward
(omnigs_torch/ops/composite_seg.py) on the SAME slab.

`composite_seg_bwd_plain` (what the wrapper runs for CPU tensors) is held
against `pallas_seg.composite_seg_bwd` in Pallas interpret mode, rows 0..8,
at the JAX suite's gradient bars (rtol 2e-3, atol 1e-4·max|ref|,
tests/test_pallas_seg.py): the port sums each instance's partials per pair
where the TPU kernel forms pixel moments, so only rounding differs. Every
lane outside a segment, and rows 9..15, stay exactly 0. The autograd
Function's input gradients are held against `jax.vjp` of the JAX
`composite_instances_seg`. The CUDA kernel is held against the plain
version on the card in tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import composite_seg as tcs
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops import binning as jbin
from omnigs_tpu.ops import pallas_seg as jseg
from omnigs_tpu.ops import preprocess as jpre

from torch_helpers import launches, random_cloud_np

W, H = 128, 64
GX, GY = W // 16, H // 16


def _layout(seed, n, squeeze=None, max_instances=1 << 12, tile_lo=0):
    """JAX pipeline over the tile window [tile_lo, GX·GY) → slab, layout and
    per-Gaussian arrays (numpy), plus the forward's color_full and a seeded
    dL/dcolor."""
    c = random_cloud_np(seed, n)
    if squeeze is not None:
        c["means3d"] = c["means3d"] * np.asarray(squeeze, np.float32)
    prep = jpre.preprocess(
        *[jnp.asarray(c[k]) for k in ("means3d", "scales", "quats", "opacities", "shs")],
        Camera(CameraType.LONLAT, W, H), jnp.eye(4), jnp.zeros(3), 2,
        tight_culling=True,
    )
    num_tiles = GX * GY - tile_lo
    inst = jbin.bin_instances_packed(
        prep, GX, GY, max_instances, tile_lo=tile_lo, n_tiles=num_tiles,
        tile_cull=True,
    )
    seg = jbin.segment_relay(
        inst.sorted_g, None, inst.starts, inst.counts, max_instances, n,
        sorted_key=inst.sorted_key,
    )
    g = {k: getattr(prep, k) for k in ("means2d", "conic", "rgb", "opacity")}
    slab = jseg._build_inst_seg(
        g["means2d"], g["conic"], g["rgb"], g["opacity"], seg.sorted_g8,
        seg.live8, inst.perm, seg.ride_d, seg.ride_t,
    )
    # the forward's color_full, an input of both backwards (the forwards
    # agree to 1e-5, tests/test_torch_composite_seg.py)
    color, final_t = tcs.composite_seg_fwd(
        torch.from_numpy(np.array(slab)),
        *[torch.from_numpy(np.array(getattr(seg, k))) for k in ("starts8", "counts", "live8")],
        num_tiles, GX, tile_lo,
    )
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    color_full = (color + final_t[:, None, :] * torch.from_numpy(bg)[None, :, None]).numpy()
    rng = np.random.default_rng(seed + 1000)
    lay = {k: np.array(getattr(seg, k)) for k in
           ("sorted_g8", "starts8", "counts", "live8", "ride_d", "ride_t")}
    lay.update(perm=np.array(inst.perm), inv_perm=np.array(inst.inv_perm),
               num_tiles=num_tiles, tile_lo=tile_lo)
    return dict(
        lay=lay,
        gauss={k: np.array(v) for k, v in g.items()},
        slab=np.array(slab),
        color_full=color_full,
        bg=bg,
        dcolor=rng.normal(size=(num_tiles, 3, 256)).astype(np.float32),
    )


CASES = {
    # few Gaussians: many empty tiles
    "sparse": dict(seed=31, n=24),
    # squeezed toward the front: tiles with hundreds of instances,
    # segments spanning several 128-lane chunks
    "multichunk": dict(seed=33, n=512, squeeze=(0.2, 0.2, 1.0),
                       max_instances=1 << 13),
    # a tile window: pixel coordinates offset by tile_lo
    "window": dict(seed=32, n=96, tile_lo=8),
}


def _assert_grad_close(got, ref, name):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4 * scale + 1e-8,
                               err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax(case):
    d = _layout(**CASES[case])
    lay = d["lay"]
    ref = np.asarray(jseg.composite_seg_bwd(
        jnp.asarray(d["slab"]), jnp.asarray(lay["starts8"]),
        jnp.asarray(lay["counts"]), jnp.asarray(lay["live8"]),
        jnp.asarray(d["color_full"]), jnp.asarray(d["dcolor"]),
        lay["num_tiles"], GX, interpret=True, tile_lo=lay["tile_lo"],
    ))
    before = launches("composite_seg_bwd")
    got = tcs.composite_seg_bwd(
        torch.from_numpy(d["slab"]),
        *[torch.from_numpy(lay[k]) for k in ("starts8", "counts", "live8")],
        torch.from_numpy(d["color_full"]), torch.from_numpy(d["dcolor"]),
        lay["num_tiles"], GX, lay["tile_lo"],
    ).numpy()
    assert launches("composite_seg_bwd") == before  # plain version on the CPU
    assert got.shape == ref.shape == d["slab"].shape
    for r, name in enumerate(("x", "y", "A", "B", "C", "op", "r", "g", "b")):
        _assert_grad_close(got[r], ref[r], name)
    assert np.abs(ref[:9]).max() > 0
    # lanes outside every segment, and the rows past the nine, stay 0
    in_seg = np.zeros(got.shape[1], bool)
    for s, n in zip(lay["starts8"], lay["counts"]):
        in_seg[s:s + n] = True
    assert (got[:, ~in_seg] == 0).all() and (got[9:] == 0).all()
    counts = lay["counts"]
    if case == "sparse":
        assert (counts == 0).any()
    if case == "multichunk":
        assert counts.max() > tcs.CHUNK


def _jax_vjp(d, ct):
    lay = d["lay"]
    ints = [jnp.asarray(lay[k]) for k in
            ("sorted_g8", "starts8", "counts", "live8", "ride_d", "ride_t")]

    def f(m, c, r, o, b):
        return jseg.composite_instances_seg(
            m, c, r, o, b, *ints, None, None, None, jnp.asarray(lay["perm"]),
            jnp.asarray(lay["inv_perm"]), jnp.int32(lay["tile_lo"]),
            lay["num_tiles"], GX, True,
        )[0]

    args = [jnp.asarray(d["gauss"][k]) for k in ("means2d", "conic", "rgb", "opacity")]
    out, vjp = jax.vjp(f, *args, jnp.asarray(d["bg"]))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _torch_function(d):
    lay = d["lay"]
    g = {k: torch.from_numpy(v).requires_grad_(True) for k, v in d["gauss"].items()}
    bg = torch.from_numpy(d["bg"]).requires_grad_(True)
    ints = [torch.from_numpy(lay[k]) for k in
            ("sorted_g8", "starts8", "counts", "live8", "ride_d", "ride_t",
             "perm", "inv_perm")]
    outs = tcs.composite_instances_seg(
        g["means2d"], g["conic"], g["rgb"], g["opacity"], bg, *ints,
        lay["num_tiles"], GX, lay["tile_lo"],
    )
    return outs, [g["means2d"], g["conic"], g["rgb"], g["opacity"], bg]


@pytest.mark.parametrize("case", ["sparse", "multichunk"])
def test_function_grads_match_jax_vjp(case):
    d = _layout(**CASES[case])
    color_j, grads_j = _jax_vjp(d, d["dcolor"])
    (color, final_t, ncontrib), inputs = _torch_function(d)
    np.testing.assert_allclose(color.detach().numpy(), color_j, atol=2e-5)
    grads_t = torch.autograd.grad(color, inputs, torch.from_numpy(d["dcolor"]))
    for got, ref, name in zip(grads_t, grads_j, ("means2d", "conic", "rgb", "opacity")):
        assert got.shape == ref.shape, name
        _assert_grad_close(got.numpy(), ref, name)
    # bg: zeros in both packages (a reference quirk, ROADMAP queue 3)
    assert (grads_j[4] == 0).all() and (grads_t[4] == 0).all()
    assert not final_t.requires_grad and not ncontrib.requires_grad


def test_final_t_is_not_differentiable():
    """A gradient into final_T fails loudly instead of being dropped."""
    (color, final_t, _), _ = _torch_function(_layout(**CASES["sparse"]))
    assert color.requires_grad and not final_t.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        final_t.sum().backward()


def test_reduction_is_deterministic_and_drops_pads():
    """`_reduce_rows` sums each rank's lanes, drops the pad sentinel, and
    restores PyTorch's deterministic-algorithms setting."""
    rng = np.random.default_rng(7)
    p, r8 = 10, 256
    ids = rng.integers(0, p + 1, size=r8).astype(np.int32)  # p = pad
    dinst = rng.normal(size=(tcs.NROWS, r8)).astype(np.float32)
    ref = np.zeros((p, tcs.NGRAD), np.float32)
    for lane, gid in enumerate(ids):
        if gid < p:
            ref[gid] += dinst[:tcs.NGRAD, lane]
    was = torch.are_deterministic_algorithms_enabled()
    out = tcs._reduce_rows(torch.from_numpy(dinst), torch.from_numpy(ids), p)
    assert torch.are_deterministic_algorithms_enabled() == was
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    again = tcs._reduce_rows(torch.from_numpy(dinst), torch.from_numpy(ids), p)
    assert torch.equal(out, again)
