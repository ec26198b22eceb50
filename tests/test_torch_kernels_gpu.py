"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Marked `gpu`; each test skips without a CUDA device. This module
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Inputs come from the port's own CPU pipeline on numpy-seeded clouds.
Bars: the compositing kernels #1-#4 bit for bit (`torch.equal`: they run
one walk, and the plain versions repeat its operations in their order, the
pixel sums in the kernels' warp tree) — the segmented #1/#2 on sparse,
dense, many-small and larger-than-a-tile clouds, the tile-major #3 (with
n_contrib) and #4 on compact slabs with unaligned segment starts; the
fused backward #5, whose atomics change its summation order, against the
plain backward + reduction at max |Δ| ≤ 1e-4 of each row's max |plain| (the
relative bar of the backwards) on the packed, 2-key and ghost-aligned
slabs and on a slab where one Gaussian sits in many tiles; the training
step on the card against the same step on the CPU at the gradient bars of
tests/test_torch_trainer.py, and the fused step's launches; the script
kernels #6 (against a float64 sum at the reduction bar, rtol 2e-3, atol
1e-4 of the max: its atomics' order varies; uniform and Zipf-like ids, a
P that is not a multiple of its transpose tile), #7 (bitwise) and #8
(each mode bitwise, also at unaligned starts, on a single-lane, an empty
and a past-the-slab tile); renders through the ghost-aligned,
no-presort and XLA layouts on the card against the CPU at 1e-5."""

import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.model.optimizer import LRConfig, init_adam
from omnigs_torch.ops import composite_seg as tcs
from omnigs_torch.ops import composite_tile as tct
from omnigs_torch.ops.binning import (
    bin_instances,
    bin_instances_aligned,
    bin_instances_packed,
    segment_relay,
)
from omnigs_torch.ops.preprocess import preprocess
from omnigs_torch.ops.rasterize import RasterConfig, _tiles_to_image
from omnigs_torch.train.renderer import render_model
from omnigs_torch.scripts import bucket_emit_bench as tbe
from omnigs_torch.scripts import kernel_ablate as tka
from omnigs_torch.scripts import reduce_bench as trb
from omnigs_torch.train.trainer import train_step

from torch_helpers import PROD_KW, ablate_slab_np, random_cloud_np, random_model_np, to_torch


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    return torch.device("cuda")


def _slab(seed, n, w, h, squeeze, max_instances, scale_mu=-1.5):
    c = to_torch(random_cloud_np(seed, n, scale_mu=scale_mu))
    c["means3d"] = c["means3d"] * torch.tensor(squeeze)
    gx, gy = w // 16, h // 16
    prep = preprocess(
        c["means3d"], c["scales"], c["quats"], c["opacities"], c["shs"],
        Camera(CameraType.LONLAT, w, h), torch.eye(4), torch.zeros(3), 2,
        tight_culling=True,
    )
    inst = bin_instances_packed(prep, gx, gy, max_instances, tile_cull=True)
    seg = segment_relay(
        inst.sorted_g, inst.starts, inst.counts, max_instances, n, inst.sorted_key
    )
    slab = tcs._build_inst_seg(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, seg.sorted_g8,
        inst.perm, seg.ride_d, seg.ride_t,
    )
    return slab, seg, gx, gx * gy


# (seed, n, squeeze, log-scale mean): a few Gaussians; many in a squeezed
# band (segments past one batch); many small ones (most warp-instance pairs
# dead, culled by the strip masks); a few larger than a tile (no culling)
SEG_CASES = [(41, 24, (1.0, 1.0, 1.0), -1.5), (42, 512, (0.2, 0.2, 1.0), -1.5),
             (49, 2048, (1.0, 1.0, 1.0), -4.0), (50, 40, (1.0, 1.0, 1.0), 0.5)]
SEG_IDS = ["sparse", "multichunk", "small", "large"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,squeeze,scale_mu", SEG_CASES, ids=SEG_IDS)
def test_composite_seg_fwd_kernel_matches_plain(seed, n, squeeze, scale_mu):
    dev = _cuda()
    slab, seg, gx, num_tiles = _slab(seed, n, 256, 128, squeeze, 1 << 14, scale_mu)
    args = [t.to(dev) for t in (slab, seg.starts8, seg.counts, seg.live8)]
    before = tcs.composite_seg_fwd.launches
    kc, kt = tcs.composite_seg_fwd(*args, num_tiles, gx)
    torch.cuda.synchronize()
    assert tcs.composite_seg_fwd.launches == before + 1
    pc, pt, _, _ = tcs.composite_seg_fwd_plain(
        args[0], args[1], args[2], num_tiles, gx
    )
    assert torch.equal(kc, pc) and torch.equal(kt, pt)
    assert int(seg.counts.sum()) > 0
    empty = (seg.counts == 0).to(dev)
    assert bool((kt[empty] == 1).all()) and bool((kc[empty] == 0).all())


def _prep_cpu(seed, n, w, h):
    c = to_torch(random_cloud_np(seed, n))
    return preprocess(
        c["means3d"], c["scales"], c["quats"], c["opacities"], c["shs"],
        Camera(CameraType.LONLAT, w, h), torch.eye(4), torch.zeros(3), 3,
        tight_culling=True,
    )


@pytest.mark.gpu
def test_binning_on_card_matches_cpu():
    """The integer layout from the same preprocessed arrays is bitwise the
    same on the card (sort, searchsorted, scatter, cumsum in int32/int64)."""
    dev = _cuda()
    prep = _prep_cpu(44, 400, 256, 128)
    out = {}
    for d in ("cpu", dev):
        pd = type(prep)(*(t.to(d) for t in prep))
        inst = bin_instances_packed(pd, 16, 8, 1 << 14, tile_cull=True)
        seg = segment_relay(
            inst.sorted_g, inst.starts, inst.counts, 1 << 14, 400, inst.sorted_key
        )
        out[str(d)] = [t.cpu() for t in (*inst, *seg) if t is not None]
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_render_on_card_matches_plain():
    """`render_model` on the card equals the plain compositor run on the
    CPU over the card's own layout (same slab, so summation order is the
    only difference)."""
    dev = _cuda()
    fields = random_model_np(43, 512, 400)
    cam = Camera(CameraType.LONLAT, 256, 128)
    cfg = RasterConfig(max_instances=1 << 14, **PROD_KW)
    bg = torch.full((3,), 0.1)
    m = GaussianModel.from_numpy(fields, device=dev)
    with torch.inference_mode():
        res = render_model(
            m, cam, torch.eye(4, device=dev), torch.zeros(3, device=dev),
            bg.to(dev), 3, cfg,
        )
        prep = preprocess(
            m.xyz, m.get_scaling(), m.get_rotation(), m.get_opacity(),
            m.get_features(), cam, torch.eye(4, device=dev),
            torch.zeros(3, device=dev), 3, active_mask=m.active,
            tight_culling=True,
        )
        inst = bin_instances_packed(prep, 16, 8, 1 << 14, tile_cull=True)
        seg = segment_relay(
            inst.sorted_g, inst.starts, inst.counts, 1 << 14, 512, inst.sorted_key
        )
        slab = tcs._build_inst_seg(
            prep.means2d, prep.conic, prep.rgb, prep.opacity, seg.sorted_g8,
            inst.perm, seg.ride_d, seg.ride_t,
        )
    pc, pt, _, _ = tcs.composite_seg_fwd_plain(
        slab.cpu(), seg.starts8.cpu(), seg.counts.cpu(), 128, 16
    )
    image = _tiles_to_image(pc + pt[:, None, :] * bg[None, :, None], 16, 8, 256, 128)
    np.testing.assert_allclose(res.image.cpu().numpy(), image.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        res.final_T.cpu().numpy(), _tiles_to_image(pt, 16, 8, 256, 128).numpy(),
        atol=1e-5,
    )
    assert int(res.truncated) == 0


def _bwd_inputs(dev, seed, n, squeeze, scale_mu=-1.5):
    slab, seg, gx, num_tiles = _slab(seed, n, 256, 128, squeeze, 1 << 14, scale_mu)
    args = [t.to(dev) for t in (slab, seg.starts8, seg.counts, seg.live8)]
    color, final_t = tcs.composite_seg_fwd(*args, num_tiles, gx)
    color_full = (color + final_t[:, None, :] * 0.2).contiguous()
    rng = np.random.default_rng(seed)
    dcolor = torch.from_numpy(
        rng.normal(size=(num_tiles, 3, 256)).astype(np.float32)
    ).to(dev)
    return args, color_full, dcolor, seg, gx, num_tiles


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,squeeze,scale_mu", SEG_CASES, ids=SEG_IDS)
def test_composite_seg_bwd_kernel_matches_plain(seed, n, squeeze, scale_mu):
    dev = _cuda()
    args, color_full, dcolor, seg, gx, num_tiles = _bwd_inputs(
        dev, seed, n, squeeze, scale_mu
    )
    before = tcs.composite_seg_bwd.launches
    got = tcs.composite_seg_bwd(*args, color_full, dcolor, num_tiles, gx)
    torch.cuda.synchronize()
    assert tcs.composite_seg_bwd.launches == before + 1
    ref = tcs.composite_seg_bwd_plain(
        args[0], args[1], args[2], color_full, dcolor, num_tiles, gx
    )
    for r in range(tcs.NGRAD):
        assert float(ref[r].abs().max()) > 0, r
    assert torch.equal(got, ref)
    assert bool((got[tcs.NGRAD:] == 0).all())
    if n == 512:
        assert int(seg.counts.max()) > tcs.CHUNK


@pytest.mark.gpu
def test_bwd_kernel_and_reduction_are_bitwise_repeatable():
    dev = _cuda()
    args, color_full, dcolor, seg, gx, num_tiles = _bwd_inputs(
        dev, 42, 512, (0.2, 0.2, 1.0)
    )
    outs = []
    for _ in range(2):
        dinst = tcs.composite_seg_bwd(*args, color_full, dcolor, num_tiles, gx)
        outs.append(tcs._reduce_rows(dinst, seg.sorted_g8.to(dev), 512))
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0].abs().max()) > 0


def _step(device, fields, gt, cfg):
    m = GaussianModel.from_numpy(fields, device=device)
    st = init_adam(m.params())
    aux = train_step(
        m, st, torch.eye(4, device=device), torch.zeros(3, device=device),
        gt.to(device), 5, camera=Camera(CameraType.LONLAT, 256, 128),
        sh_degree=3, raster_cfg=cfg, lr_cfg=LRConfig(), spatial_lr_scale=2.0,
        bg=torch.zeros(3, device=device), skip_bottom_px=8,
    )
    return m, st, aux


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One `train_step` through both kernels on the card against the same
    step of the port on the CPU (plain versions)."""
    dev = _cuda()
    fields = random_model_np(45, 512, 400, scale_mu=-2.5)
    cfg = RasterConfig(max_instances=1 << 14, **PROD_KW)
    gt = torch.from_numpy(
        np.random.default_rng(45).uniform(size=(3, 128, 256)).astype(np.float32)
    )
    fwd, bwd = tcs.composite_seg_fwd.launches, tcs.composite_seg_bwd.launches
    mc, stc, auxc = _step(dev, fields, gt, cfg)
    torch.cuda.synchronize()
    assert tcs.composite_seg_fwd.launches == fwd + 1
    assert tcs.composite_seg_bwd.launches == bwd + 1
    mp, stp, auxp = _step("cpu", fields, gt, cfg)
    np.testing.assert_allclose(float(auxc["loss"]), float(auxp["loss"]), rtol=1e-5)
    assert int(auxc["truncated"]) == 0
    lrs = {"xyz": 1.6e-4 * 2.0, "features_dc": 2.5e-3, "features_rest": 2.5e-3 / 20,
           "opacity": 5e-2, "scaling": 5e-3, "rotation": 1e-3}
    for name in lrs:
        mu_c, mu_p = stc.mu[name].cpu().numpy(), stp.mu[name].numpy()
        scale = float(np.abs(mu_p).max())
        np.testing.assert_allclose(mu_c, mu_p, rtol=2e-3, atol=1e-4 * scale + 1e-12,
                                   err_msg=name)
        # Adam's first step is lr·sign(g): near-zero gradients may step apart
        small = np.abs(mu_p) <= 2e-3 * np.abs(mu_p) + 1e-4 * scale
        diff = np.abs(getattr(mc, name).detach().cpu().numpy()
                      - getattr(mp, name).detach().numpy())
        assert (diff <= np.where(small, 2.0 * lrs[name] + 1e-6, 1e-6)).all(), name


def _tile_inputs(dev, seed, n, squeeze):
    """The compact (tile-major) slab of a seeded cloud at 256×128 through
    the port's CPU pipeline, moved to ``dev``, with a seeded dL/dcolor."""
    c = to_torch(random_cloud_np(seed, n))
    c["means3d"] = c["means3d"] * torch.tensor(squeeze)
    prep = preprocess(
        c["means3d"], c["scales"], c["quats"], c["opacities"], c["shs"],
        Camera(CameraType.LONLAT, 256, 128), torch.eye(4), torch.zeros(3), 2,
        tight_culling=True,
    )
    inst = bin_instances_packed(prep, 16, 8, 1 << 14, tile_cull=True)
    slab = tct._build_inst(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, inst.sorted_g,
        torch.amax(inst.starts + inst.counts), inst.perm,
    )
    x0, y0 = tct.tile_origins(16, 8)
    args = [t.to(dev) for t in (slab, inst.starts, inst.counts, x0, y0)]
    dcolor = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(128, 3, 256)).astype(np.float32)
    ).to(dev)
    return args, inst.sorted_g.to(dev), dcolor


TILE_CASES = [(41, 24, (1.0, 1.0, 1.0)), (42, 512, (0.2, 0.2, 1.0))]


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,squeeze", TILE_CASES, ids=["sparse", "multichunk"])
def test_composite_tile_fwd_kernel_matches_plain(seed, n, squeeze):
    dev = _cuda()
    args, _, _ = _tile_inputs(dev, seed, n, squeeze)
    before = tct.composite_tile_fwd.launches
    kc, kt, kn = tct.composite_tile_fwd(*args, 128)
    k0 = tct.composite_tile_fwd(*args, 128, want_ncontrib=False)
    torch.cuda.synchronize()
    assert tct.composite_tile_fwd.launches == before + 2
    pc, pt, pn, _, _ = tct.composite_tile_fwd_plain(*args, 128)
    assert torch.equal(kc, pc) and torch.equal(kt, pt)
    assert torch.equal(kn, pn) and int(kn.max()) > 0
    assert torch.equal(k0[0], kc) and torch.equal(k0[1], kt)
    assert not bool(k0[2].any())
    if n == 512:
        assert int(args[2].max()) > tct.CHUNK


def _tile_bwd(dev, seed, n, squeeze):
    args, ids, dcolor = _tile_inputs(dev, seed, n, squeeze)
    color, final_t, _ = tct.composite_tile_fwd(*args, 128)
    color_full = (color + final_t[:, None, :] * 0.2).contiguous()
    return args, ids, color_full, dcolor


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,squeeze", TILE_CASES, ids=["sparse", "multichunk"])
def test_composite_tile_bwd_kernels_match_plain(seed, n, squeeze):
    """#4 against its plain version bit for bit, #5 against its plain
    version at max |Δ| ≤ 1e-4·max|plain| per row (its atomics)."""
    dev = _cuda()
    args, ids, color_full, dcolor = _tile_bwd(dev, seed, n, squeeze)
    before = (tct.composite_tile_bwd.launches, tct.composite_tile_bwd_fused.launches)
    got = tct.composite_tile_bwd(*args, color_full, dcolor, 128)
    fused = tct.composite_tile_bwd_fused(args[0], ids, *args[1:], color_full, dcolor, 128, n)
    torch.cuda.synchronize()
    assert (tct.composite_tile_bwd.launches, tct.composite_tile_bwd_fused.launches) == (
        before[0] + 1, before[1] + 1)
    ref = tct.composite_tile_bwd_plain(*args, color_full, dcolor, 128)
    assert torch.equal(got, ref)
    for r in range(tct.NGRAD):
        assert float(ref[r].abs().max()) > 0
    _fused_close(fused, args, ids, color_full, dcolor, n)
    assert bool((got[tct.NGRAD:] == 0).all())


def _fused_close(fused, args, ids, color_full, dcolor, p):
    """#5's (P, 9) rows against its plain version: max |Δ| ≤ 1e-4 of each
    row's max |plain| (its atomics add in no fixed order)."""
    ref = tct.composite_tile_bwd_fused_plain(
        args[0], ids, *args[1:], color_full, dcolor, args[1].shape[0], p
    )
    assert fused.shape == ref.shape == (p, tct.NGRAD)
    for r in range(tct.NGRAD):
        scale = float(ref[:, r].abs().max())
        assert scale > 0, r
        assert float((fused[:, r] - ref[:, r]).abs().max()) <= 1e-4 * scale, r


def _layout_slab(dev, cloud, layout):
    """(args, ids) of ``cloud``'s slab at 256×128 through the packed
    ("packed"), 2-key ("two_key") or ghost-aligned ("ghost") binning."""
    prep = preprocess(
        cloud["means3d"], cloud["scales"], cloud["quats"], cloud["opacities"],
        cloud["shs"], Camera(CameraType.LONLAT, 256, 128), torch.eye(4), torch.zeros(3),
        2, tight_culling=True,
    )
    if layout == "packed":
        inst = bin_instances_packed(prep, 16, 8, 1 << 14, tile_cull=True)
    elif layout == "two_key":
        inst = bin_instances(prep, 16, 8, 1 << 14, tile_cull=True)
    else:
        inst = bin_instances_aligned(prep, 16, 8, 1 << 14, chunk=tct.CHUNK, tile_cull=True)
    slab = tct._build_inst(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, inst.sorted_g,
        torch.amax(inst.starts + inst.counts), inst.perm,
    )
    args = [t.to(dev) for t in (slab, inst.starts, inst.counts, *tct.tile_origins(16, 8))]
    return args, inst.sorted_g.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["two_key", "ghost", "contention"])
def test_fused_bwd_kernel_matches_plain_on_layouts(layout):
    """#5 on the other layouts the fused route takes (the 2-key and the
    ghost-aligned binnings, whose ghost lanes hold id 0 and zero rows), and
    on a packed slab where one Gaussian sits in many tiles (its rows meet
    in one table row from many blocks), against its plain version."""
    dev = _cuda()
    c = to_torch(random_cloud_np(52, 256))
    c["means3d"] = c["means3d"] * torch.tensor((0.3, 0.3, 1.0))
    if layout == "contention":
        c["scales"][0] = 1.5
        c["opacities"][0] = 0.3
    args, ids = _layout_slab(dev, c, "packed" if layout == "contention" else layout)
    if layout == "contention":
        live = int(torch.amax(args[1] + args[2]))
        assert int(torch.bincount(ids[:live].long()).max()) >= 64
    kc, kt, _ = tct.composite_tile_fwd(*args, 128)
    color_full = (kc + kt[:, None, :] * 0.2).contiguous()
    dcolor = torch.from_numpy(
        np.random.default_rng(52).normal(size=(128, 3, 256)).astype(np.float32)
    ).to(dev)
    before = tct.composite_tile_bwd_fused.launches
    fused = tct.composite_tile_bwd_fused(args[0], ids, *args[1:], color_full, dcolor, 128, 256)
    torch.cuda.synchronize()
    assert tct.composite_tile_bwd_fused.launches == before + 1
    _fused_close(fused, args, ids, color_full, dcolor, 256)


@pytest.mark.gpu
def test_fused_step_launches_the_fused_kernel_only():
    """A `train_step` with fused_reduce=True on the tile-major path
    launches #5 once, #4 never, and #3 once."""
    dev = _cuda()
    fields = random_model_np(53, 512, 400, scale_mu=-2.5)
    cfg = RasterConfig(max_instances=1 << 14, **dict(
        PROD_KW, segmented=False, want_ncontrib=True, fused_reduce=True,
        gather_reduce=False))
    gt = torch.from_numpy(
        np.random.default_rng(53).uniform(size=(3, 128, 256)).astype(np.float32)
    )
    kernels = (tct.composite_tile_bwd_fused, tct.composite_tile_bwd, tct.composite_tile_fwd)
    before = [k.launches for k in kernels]
    _, st, aux = _step(dev, fields, gt, cfg)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 1]
    assert np.isfinite(float(aux["loss"]))
    assert all(bool(torch.isfinite(v).all()) for v in st.mu.values())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["two_key", "ghost"])
def test_tile_kernels_bitwise_on_other_layouts(layout):
    """#3 and #4 on the 2-key and the ghost-aligned binnings' slabs (the
    layouts the rasterizer feeds them besides the packed key) against their
    plain versions, bit for bit."""
    dev = _cuda()
    c = to_torch(random_cloud_np(51, 512))
    c["means3d"] = c["means3d"] * torch.tensor((0.3, 0.3, 1.0))
    prep = preprocess(
        c["means3d"], c["scales"], c["quats"], c["opacities"], c["shs"],
        Camera(CameraType.LONLAT, 256, 128), torch.eye(4), torch.zeros(3), 2,
        tight_culling=True,
    )
    if layout == "two_key":
        inst = bin_instances(prep, 16, 8, 1 << 14, tile_cull=True)
    else:
        inst = bin_instances_aligned(prep, 16, 8, 1 << 14, chunk=tct.CHUNK, tile_cull=True)
    slab = tct._build_inst(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, inst.sorted_g,
        torch.amax(inst.starts + inst.counts), inst.perm,
    )
    args = [t.to(dev) for t in (slab, inst.starts, inst.counts, *tct.tile_origins(16, 8))]
    kc, kt, kn = tct.composite_tile_fwd(*args, 128)
    pc, pt, pn, _, _ = tct.composite_tile_fwd_plain(*args, 128)
    assert torch.equal(kc, pc) and torch.equal(kt, pt) and torch.equal(kn, pn)
    color_full = (kc + kt[:, None, :] * 0.2).contiguous()
    dcolor = torch.from_numpy(
        np.random.default_rng(51).normal(size=(128, 3, 256)).astype(np.float32)
    ).to(dev)
    got = tct.composite_tile_bwd(*args, color_full, dcolor, 128)
    assert torch.equal(got, tct.composite_tile_bwd_plain(*args, color_full, dcolor, 128))
    assert float(got.abs().max()) > 0


@pytest.mark.gpu
def test_tile_bwd_kernel_and_reduction_are_bitwise_repeatable():
    dev = _cuda()
    args, ids, color_full, dcolor = _tile_bwd(dev, 42, 512, (0.2, 0.2, 1.0))
    live = torch.amax(args[1] + args[2])
    outs = [
        tct._scatter_reduce(tct.composite_tile_bwd(*args, color_full, dcolor, 128), ids, live, 512)
        for _ in range(2)
    ]
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0].abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("ids_kind,p", [("uniform", 4096), ("zipf", 4096),
                                        ("uniform", 4093)])
def test_reduce_accum_kernel_matches_float64(ids_kind, p):
    """#6 against the float64 sum of the same rows at the reduction bar
    (rtol 2e-3, atol 1e-4 of each row's max): its atomics sum in no fixed
    order. Its plain version is that sum in float32. Uniform ids; Zipf-like
    ids (a few ids take most rows, so a warp's ids repeat); and P = 4093,
    not a multiple of the transpose's 128 Gaussians (the ragged edge), with
    ids up to P − 1."""
    dev = _cuda()
    ids, rows, live = trb.make_inputs(1 << 16, p, dev, seed=46)
    if ids_kind == "zipf":
        w = np.arange(1, p + 1, dtype=np.float64) ** -1.0
        rng = np.random.default_rng(46)
        ranks = rng.choice(p, size=ids.shape[0], p=w / w.sum())
        ids = torch.from_numpy(rng.permutation(p)[ranks].astype(np.int32)).to(dev)
        assert int(torch.bincount(ids[:live].long()).max()) > 32 * 64
    else:
        assert int(ids[:live].max()) == p - 1
    before = trb.reduce_accum.launches
    got = trb.reduce_accum(ids[:live].contiguous(), rows, p)
    torch.cuda.synchronize()
    assert trb.reduce_accum.launches == before + 1
    assert got.shape == (16, p)
    exact = torch.zeros(16, p, dtype=torch.float64, device=dev)
    exact.index_add_(1, ids[:live].to(torch.int64), rows[:, :live].to(torch.float64))
    for acc in (got, trb.reduce_accum_plain(ids[:live], rows, p)):
        ref = exact.cpu().numpy()
        np.testing.assert_allclose(acc.cpu().numpy(), ref, rtol=2e-3,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.gpu
def test_bucket_emit_kernel_is_bitwise_plain():
    dev = _cuda()
    slots, data, _ = (torch.from_numpy(a).to(dev) for a in tbe.make_inputs(4 * tbe.K, seed=47))
    before = tbe.bucket_emit.launches
    got = tbe.bucket_emit(slots, data)
    torch.cuda.synchronize()
    assert tbe.bucket_emit.launches == before + 1
    assert torch.equal(got, tbe.bucket_emit_plain(slots, data))


# kernel #8's slabs: the aligned one (an empty tile, counts of 5 and 77);
# unaligned starts with a single-lane tile, an empty one and counts that
# are not multiples of 32; and a last tile that runs past the slab's end
def _past_rpad(arrays):
    slab, starts, counts, x0, y0 = arrays
    return np.ascontiguousarray(slab[:, : int(starts[-1]) + 70]), starts, counts, x0, y0


ABLATE_SLABS = {
    "aligned": lambda: ablate_slab_np(63),
    "unaligned": lambda: ablate_slab_np(68, counts=(1, 0, 33, 129, 31, 255, 97, 300),
                                        gaps=(17, 3, 40, 1, 59, 8, 23, 2)),
    "past_rpad": lambda: _past_rpad(ablate_slab_np(69)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("slab", sorted(ABLATE_SLABS))
@pytest.mark.parametrize("mode", tka.MODES)
def test_kernel_ablate_kernel_matches_plain(mode, slab):
    """#8 in each mode against its plain version bit for bit (the same
    operations in the same order, --fmad=false; the kernel skips only dead
    pairs, whose updates change no value)."""
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in ABLATE_SLABS[slab]()]
    before = tka.kernel_ablate.launches
    got = tka.kernel_ablate(mode, *args)
    torch.cuda.synchronize()
    assert tka.kernel_ablate.launches == before + 1
    ref = tka.kernel_ablate_plain(mode, *args)[0]
    assert torch.equal(got, ref), (mode, slab, float((got - ref).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["ghost", "nopresort_seg", "nopresort_tile", "xla"])
def test_layout_render_on_card_matches_cpu(layout):
    """`render_model` through the layouts beside the packed key on the card
    against the same render on the CPU (plain versions)."""
    dev = _cuda()
    kw = {
        "ghost": dict(PROD_KW, ghost_align=True, depth_presort=False, segmented=False,
                      gather_reduce=False),
        "nopresort_seg": dict(PROD_KW, depth_presort=False),
        "nopresort_tile": dict(PROD_KW, depth_presort=False, segmented=False,
                               want_ncontrib=True),
        "xla": dict(backend="xla", tight_culling=True, tile_cap=256, chunk=32),
    }[layout]
    cfg = RasterConfig(max_instances=1 << 14, **kw)
    fields = random_model_np(48, 512, 400)
    cam = Camera(CameraType.LONLAT, 256, 128)
    out = {}
    for d in (dev, "cpu"):
        m = GaussianModel.from_numpy(fields, device=d)
        with torch.inference_mode():
            out[str(d)] = render_model(
                m, cam, torch.eye(4, device=d), torch.zeros(3, device=d),
                torch.full((3,), 0.1, device=d), 3, cfg,
            )
    got, ref = out[str(dev)], out["cpu"]
    np.testing.assert_allclose(got.image.cpu().numpy(), ref.image.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.final_T.cpu().numpy(), ref.final_T.numpy(), atol=1e-5)
    assert int(got.truncated) == int(ref.truncated) == 0


@pytest.mark.gpu
def test_pinhole_render_kernel_matches_plain():
    """A 1920×1080 pinhole render (67.5 tile rows: the last half outside
    the image) through kernel #1 against the plain version on the card's
    own slab, bit for bit, image and final_T."""
    from omnigs_torch.scene.keyframe import Keyframe

    dev = _cuda()
    cam = Camera(CameraType.PINHOLE, 1920, 1080, fx=1200.0, fy=1200.0, cx=960.0, cy=540.0)
    kf = Keyframe(0, cam, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    # 4,096 Gaussians in front of the camera: ~185 k instances
    fields = random_model_np(52, 4096, 4096, scale_mu=-3.0)
    fields["xyz"][:, 2] = np.abs(fields["xyz"][:, 2]) + 1.0
    m = GaussianModel.from_numpy(fields, device=dev)
    cfg = RasterConfig(max_instances=1 << 19, **PROD_KW)
    bg = torch.full((3,), 0.1, device=dev)
    args = (m, cam, torch.eye(4, device=dev), torch.zeros(3, device=dev), bg, 3, cfg)
    fp = torch.from_numpy(kf.full_proj).to(dev)
    before = tcs.composite_seg_fwd.launches
    with torch.inference_mode():
        res = render_model(*args, full_proj=fp)
    assert tcs.composite_seg_fwd.launches == before + 1
    kernel = tcs.composite_seg_fwd

    def plain(inst, starts8, counts, live8, num_tiles, gx, tile_lo=0):
        return tcs.composite_seg_fwd_plain(inst, starts8, counts, num_tiles, gx, tile_lo)[:2]

    tcs.composite_seg_fwd = plain
    try:
        with torch.inference_mode():
            ref = render_model(*args, full_proj=fp)
    finally:
        tcs.composite_seg_fwd = kernel
    assert tuple(res.image.shape) == (3, 1080, 1920)
    assert int(res.truncated) == 0 and float(res.final_T.min()) < 0.5
    assert torch.equal(res.image, ref.image) and torch.equal(res.final_T, ref.final_T)


def _window_prep(seed=42, n=512, squeeze=(0.2, 0.2, 1.0)):
    """A seeded cloud's preprocess at 256×128 (16×8 tiles) and rank 1's
    window of a two-rank gauss split: tiles [64, 128)."""
    c = to_torch(random_cloud_np(seed, n))
    c["means3d"] = c["means3d"] * torch.tensor(squeeze)
    prep = preprocess(
        c["means3d"], c["scales"], c["quats"], c["opacities"], c["shs"],
        Camera(CameraType.LONLAT, 256, 128), torch.eye(4), torch.zeros(3), 2,
        tight_culling=True,
    )
    return prep, 64, 64


@pytest.mark.gpu
def test_seg_kernels_on_a_tile_window_match_plain():
    """#1 and #2 with ``tile_lo`` > 0 (a sharded render's window) against
    their plain versions bit for bit."""
    dev = _cuda()
    prep, tile_lo, n_tiles = _window_prep()
    inst = bin_instances_packed(prep, 16, 8, 1 << 14, tile_lo=tile_lo, n_tiles=n_tiles,
                                tile_cull=True)
    seg = segment_relay(inst.sorted_g, inst.starts, inst.counts, 1 << 14, 512, inst.sorted_key)
    slab = tcs._build_inst_seg(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                               seg.sorted_g8, inst.perm, seg.ride_d, seg.ride_t)
    args = [t.to(dev) for t in (slab, seg.starts8, seg.counts, seg.live8)]
    assert int(seg.counts.sum()) > 0
    kc, kt = tcs.composite_seg_fwd(*args, n_tiles, 16, tile_lo)
    pc, pt, _, _ = tcs.composite_seg_fwd_plain(args[0], args[1], args[2], n_tiles, 16, tile_lo)
    assert torch.equal(kc, pc) and torch.equal(kt, pt)
    # the window's pixels are the grid's lower half: not the upper half's
    c0, _ = tcs.composite_seg_fwd(*args, n_tiles, 16, 0)
    assert not torch.equal(c0, kc)
    color_full = (kc + kt[:, None, :] * 0.2).contiguous()
    dcolor = torch.from_numpy(
        np.random.default_rng(7).normal(size=(n_tiles, 3, 256)).astype(np.float32)
    ).to(dev)
    got = tcs.composite_seg_bwd(*args, color_full, dcolor, n_tiles, 16, tile_lo)
    ref = tcs.composite_seg_bwd_plain(args[0], args[1], args[2], color_full, dcolor,
                                      n_tiles, 16, tile_lo)
    assert float(ref[: tcs.NGRAD].abs().max()) > 0
    assert torch.equal(got, ref)


@pytest.mark.gpu
def test_tile_kernels_on_a_tile_window_match_plain():
    """#3 (with n_contrib) and #4 on a window's tiles, placed by the
    window's x0 / y0, against their plain versions bit for bit."""
    dev = _cuda()
    prep, tile_lo, n_tiles = _window_prep()
    inst = bin_instances_packed(prep, 16, 8, 1 << 14, tile_lo=tile_lo, n_tiles=n_tiles,
                                tile_cull=True)
    slab = tct._build_inst(prep.means2d, prep.conic, prep.rgb, prep.opacity, inst.sorted_g,
                           torch.amax(inst.starts + inst.counts), inst.perm)
    x0, y0 = tct.tile_origins(16, 8, tile_lo=tile_lo, n_tiles=n_tiles)
    assert int(y0.min()) == 64
    args = [t.to(dev) for t in (slab, inst.starts, inst.counts, x0, y0)]
    kc, kt, kn = tct.composite_tile_fwd(*args, n_tiles)
    pc, pt, pn, _, _ = tct.composite_tile_fwd_plain(*args, n_tiles)
    assert torch.equal(kc, pc) and torch.equal(kt, pt) and torch.equal(kn, pn)
    assert int(kn.max()) > 0
    color_full = (kc + kt[:, None, :] * 0.2).contiguous()
    dcolor = torch.from_numpy(
        np.random.default_rng(8).normal(size=(n_tiles, 3, 256)).astype(np.float32)
    ).to(dev)
    assert torch.equal(tct.composite_tile_bwd(*args, color_full, dcolor, n_tiles),
                       tct.composite_tile_bwd_plain(*args, color_full, dcolor, n_tiles))
