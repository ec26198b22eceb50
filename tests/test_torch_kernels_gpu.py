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
no-presort and XLA layouts on the card against the CPU at 1e-5; the
training window's CUDA graph (segmented, tile-major, and with the
ground-truth bank on the host) bitwise equal to eager iterations; on a
one-rank NCCL group, the sharded window of a (1, 1) `ParallelTrainer`
(captured sharded step, ground-truth bank on the card and on the host)
bitwise equal to its eager iterations, and each collective the mesh runs
captured into a graph, its replays equal to the eager call; the stage
marks inside the window's graph (each replay's marks in order in a
CUDA-only trace, the mark table's ``%globaltimer`` totals against the
trace's intervals) and a window bitwise the same with the marks off, each
capture counted with its reason; the SSIM kernels (`csrc/ssim.cu`) bit for
bit their plain versions (`ssim_plain`: the map, the mean through the same
fixed tree, and the prediction's gradient from the mean's scalar and from
a map's gradient, contiguous or broadcast) on a cropped strided view, an
odd size and a one-tile-row image, and bitwise repeatable, their row
blocks (`ssim_rows`) too; the window's graph counts their launches a
replay; the binning's pre-cull kernel (`csrc/precull.cu`) bit for bit its
plain version (`_precull_masks_plain`) on the slabs named at
PRECULL_CASES, the whole packed binning and relay unchanged by it, and one
launch of it a render request and a replayed or eager step; the packed
binning's expansion kernel (`csrc/expand_keys.cu`) bit for bit its plain
version (`_expand_keys_plain`) on the inputs named at EXPAND_CASES, its
select against `_kth_set_bit` on random masks, every output of
`bin_instances_packed` unchanged by it, and one launch of it a render
request and a replayed or eager step."""

import numpy as np
import pytest
import torch

from omnigs_torch import cameras as tcam
from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.model.optimizer import LRConfig, init_adam
from omnigs_torch.ops import composite_seg as tcs
from omnigs_torch.ops import composite_tile as tct
from omnigs_torch.ops import binning as tbin
from omnigs_torch.ops import loss as tl
from omnigs_torch.ops import preprocess as tpre
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
from omnigs_torch.utils import profiling

from torch_helpers import (
    PROD_KW,
    ablate_slab_np,
    launches,
    random_cloud_np,
    random_model_np,
    to_torch,
)


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
    before = launches("composite_seg_fwd")
    kc, kt = tcs.composite_seg_fwd(*args, num_tiles, gx)
    torch.cuda.synchronize()
    assert launches("composite_seg_fwd") == before + 1
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
    before = launches("composite_seg_bwd")
    got = tcs.composite_seg_bwd(*args, color_full, dcolor, num_tiles, gx)
    torch.cuda.synchronize()
    assert launches("composite_seg_bwd") == before + 1
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
        m, st, torch.eye(4, device=device)[None], torch.zeros(1, 3, device=device),
        gt.to(device)[None], 5, camera=Camera(CameraType.LONLAT, 256, 128),
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
    fwd, bwd = launches("composite_seg_fwd"), launches("composite_seg_bwd")
    mc, stc, auxc = _step(dev, fields, gt, cfg)
    torch.cuda.synchronize()
    assert launches("composite_seg_fwd") == fwd + 1
    assert launches("composite_seg_bwd") == bwd + 1
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
    before = launches("composite_tile_fwd")
    kc, kt, kn = tct.composite_tile_fwd(*args, 128)
    k0 = tct.composite_tile_fwd(*args, 128, want_ncontrib=False)
    torch.cuda.synchronize()
    assert launches("composite_tile_fwd") == before + 2
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
    before = (launches("composite_tile_bwd"), launches("composite_tile_bwd_fused"))
    got = tct.composite_tile_bwd(*args, color_full, dcolor, 128)
    fused = tct.composite_tile_bwd_fused(args[0], ids, *args[1:], color_full, dcolor, 128, n)
    torch.cuda.synchronize()
    assert (launches("composite_tile_bwd"), launches("composite_tile_bwd_fused")) == (
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
    before = launches("composite_tile_bwd_fused")
    fused = tct.composite_tile_bwd_fused(args[0], ids, *args[1:], color_full, dcolor, 128, 256)
    torch.cuda.synchronize()
    assert launches("composite_tile_bwd_fused") == before + 1
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
    kernels = ("composite_tile_bwd_fused", "composite_tile_bwd", "composite_tile_fwd")
    before = launches(*kernels)
    _, st, aux = _step(dev, fields, gt, cfg)
    torch.cuda.synchronize()
    assert [n - b for n, b in zip(launches(*kernels), before)] == [1, 0, 1]
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
    before = launches("reduce_accum")
    got = trb.reduce_accum(ids[:live].contiguous(), rows, p)
    torch.cuda.synchronize()
    assert launches("reduce_accum") == before + 1
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
    before = launches("bucket_emit")
    got = tbe.bucket_emit(slots, data)
    torch.cuda.synchronize()
    assert launches("bucket_emit") == before + 1
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
    before = launches("kernel_ablate")
    got = tka.kernel_ablate(mode, *args)
    torch.cuda.synchronize()
    assert launches("kernel_ablate") == before + 1
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
    before = launches("composite_seg_fwd")
    with torch.inference_mode():
        res = render_model(*args, full_proj=fp)
    assert launches("composite_seg_fwd") == before + 1
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


def _window_trainer(layout, cls=None):
    """A Trainer (or ``cls``, a `ParallelTrainer` on the process group's
    mesh) on the card over a three-view 128×64 scene (ground truths the
    port's renders of a seeded cloud on the CPU), segmented or tile-major,
    its ground-truth bank on the card or (``host_bank``) on the host."""
    import dataclasses

    import omnigs_torch.config as tconfig
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.scene.scene import Scene
    from omnigs_torch.train.trainer import Trainer

    rng = np.random.default_rng(60)
    f = random_model_np(160, 96, 96)
    gt_model = GaussianModel.from_numpy(f, device="cpu")
    cam = Camera(CameraType.LONLAT, 128, 64)
    scene = Scene()
    for i in range(3):
        angle = rng.normal() * 0.2
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = (rng.normal(size=3) * 0.1).astype(np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = R, t
        with torch.inference_mode():
            res = render_model(gt_model, cam, torch.from_numpy(vm), torch.from_numpy(-R.T @ t),
                               torch.zeros(3), 3, RasterConfig(max_instances=1 << 13, **PROD_KW))
        scene.add_keyframe(Keyframe(i, cam, R, t, image=res.image.permute(1, 2, 0).numpy().copy()))
    scene.points = (f["xyz"] + rng.normal(size=f["xyz"].shape) * 0.05).astype(np.float32)
    scene.colors = np.clip(f["features_dc"][:, 0] * 0.28209479177387814 + 0.5, 0, 1)
    cfg = tconfig.Config()
    cfg.tpu = dataclasses.replace(
        cfg.tpu, capacity=128, max_instances=1 << 13,
        want_ncontrib=int(layout == "tile_major"),
        gt_bank_mb=0 if layout == "host_bank" else cfg.tpu.gt_bank_mb,
    )
    tr = (cls or Trainer)(scene, cfg, seed=7, device="cuda")
    tr.init_from_sfm()
    return tr


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["segmented", "tile_major", "host_bank"])
def test_graph_window_equals_eager_iterations(layout):
    """Two 5-step `train_window`s (one capture, ten replays of the step's
    CUDA graph) against ten `train_iteration`s from the same state: every
    model field, Adam moment and count and every loss `torch.equal`; the
    forward kernel counted once a replay and once a warm-up step."""
    from omnigs_torch.model.gaussians import FIELD_NAMES
    from omnigs_torch.train.trainer import WARMUP_STEPS

    _cuda()
    a, b = _window_trainer(layout), _window_trainer(layout)
    fwd = "composite_tile_fwd" if layout == "tile_major" else "composite_seg_fwd"
    n0 = launches(fwd)
    s0 = (launches("ssim_fwd"), launches("ssim_bwd"))
    c0, e0 = launches("precull"), launches("expand_keys")
    r0 = profiling.counters()["replays"]
    for _ in range(2):
        assert a.train_window(5) == 5
        for _ in range(5):
            b.train_iteration()
    torch.cuda.synchronize()
    assert a.iteration == b.iteration == 10
    assert a.step_graph.captures == 1 and profiling.counters()["replays"] - r0 == 10
    assert launches(fwd) - n0 == 10 + WARMUP_STEPS + 10
    # the loss's two kernels, once each in every replay and eager step
    assert launches("ssim_fwd") - s0[0] == launches("ssim_bwd") - s0[1] == 10 + WARMUP_STEPS + 10
    # the binning's pre-cull and expansion too: the graph holds one launch of each a step
    assert launches("precull") - c0 == 10 + WARMUP_STEPS + 10
    assert launches("expand_keys") - e0 == 10 + WARMUP_STEPS + 10
    for k in FIELD_NAMES:
        assert torch.equal(getattr(a.model, k), getattr(b.model, k)), k
    for m in ("mu", "nu"):
        for k, v in getattr(a.opt_state, m).items():
            assert torch.equal(v, getattr(b.opt_state, m)[k]), f"{m}/{k}"
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    la = torch.cat([x.reshape(-1) for x, _, _ in a._pending_losses])
    lb = torch.stack([x for x, _, _ in b._pending_losses])
    assert torch.equal(la, lb) and bool(torch.isfinite(la).all())
    assert a.drain_losses() == b.drain_losses() and a.ema_loss == b.ema_loss
    assert a.total_truncated == b.total_truncated == 0


# one captured step's marks, in order (the render's end closes composite_fwd)
STEP_MARKS = ["window", "preprocess", "bin", "relay", "composite_fwd", "end", "loss",
              "composite_bwd", "preprocess_bwd", "adam", "window", "end"]


@pytest.mark.gpu
def test_graph_window_stage_marks_in_trace_and_table(tmp_path):
    """A 5-step window (its graph captured by an earlier window) under a
    CUDA-only profiler: each replay carries the step's marks in order,
    once a stage (``window`` and ``end`` twice); the mark table's ``%globaltimer``
    totals of the window agree with the trace's mark-to-mark intervals of
    each stage within 2% (and 2 us an entry, a step of the card's clock),
    and in all within 2%."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from omnigs_torch.utils import profiling

    _cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    tr = _window_trainer("segmented")
    assert tr.train_window(5) == 5
    torch.cuda.synchronize()
    before = profiling.stage_totals(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert tr.train_window(5) == 5
        torch.cuda.synchronize()
    after = profiling.stage_totals(dev)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    marks = sorted((float(e["ts"]), e["name"]) for e in events
                   if e.get("cat") == "kernel" and e["name"].startswith("stage_mark_"))
    assert [n for _, n in marks] == [f"stage_mark_{s}" for s in STEP_MARKS] * 5
    spans = {}  # stage → us from each of its marks to the next mark
    for (a, n), (b, _) in zip(marks, marks[1:]):
        if n != "stage_mark_end":
            s = n[len("stage_mark_"):]
            spans[s] = spans.get(s, 0.0) + b - a
    assert set(spans) == set(STEP_MARKS) - {"end"}
    for s, span_us in spans.items():
        ms, n = (after[s][i] - before[s][i] for i in (0, 1))
        assert n == 5 * STEP_MARKS.count(s), s
        assert ms * 1e3 == pytest.approx(span_us, rel=0.02, abs=2.0 * n), s
    total = sum(after[s][0] - before[s][0] for s in spans) * 1e3
    assert total == pytest.approx(sum(spans.values()), rel=0.02)


@pytest.mark.gpu
def test_graph_window_marks_off_bitwise_and_capture_reasons():
    """Two trainers from one state, one window each with the marks on and
    off: every loss and model field `torch.equal`. The window's captures
    count with their reasons: the first, a changed λ (a static of the
    step) and the marks' switch, once each."""
    from omnigs_torch.model.gaussians import FIELD_NAMES
    from omnigs_torch.utils import profiling

    _cuda()
    a, b = _window_trainer("segmented"), _window_trainer("segmented")
    profiling.reset_counters()
    assert a.train_window(5) == 5
    profiling.set_marks(False)
    try:
        assert b.train_window(5) == 5
        torch.cuda.synchronize()
    finally:
        profiling.set_marks(True)
    for k in FIELD_NAMES:
        assert torch.equal(getattr(a.model, k), getattr(b.model, k)), k
    la = torch.cat([x.reshape(-1) for x, _, _ in a._pending_losses])
    lb = torch.cat([x.reshape(-1) for x, _, _ in b._pending_losses])
    assert torch.equal(la, lb) and bool(torch.isfinite(la).all())
    assert profiling.counters()["capture_reasons"] == {"first": 2}
    a.set_variable_parameters({"lambda_dssim": 0.3})
    assert a.train_window(2) == 2
    profiling.set_marks(False)
    try:
        assert a.train_window(2) == 2
    finally:
        profiling.set_marks(True)
    got = profiling.counters()
    assert got["captures"] == 4 and a.step_graph.captures == 3
    assert got["capture_reasons"] == {"first": 2, "static": 1, "marks": 1}
    assert got["replays"] == 14 and got["warmup_steps"] == 8


@pytest.fixture(scope="module")
def nccl_rank():
    """A one-rank NCCL process group on the card for the module's tests."""
    import socket

    import torch.distributed as dist

    from omnigs_torch.parallel.distributed import initialize

    _cuda()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["segmented", "host_bank"])
def test_sharded_graph_window_equals_eager_iterations(nccl_rank, layout):
    """A (1, 1) `ParallelTrainer` under NCCL: two 5-step `train_window`s in
    graph mode (one capture, ten replays of the sharded step) against ten
    `train_iteration`s from the same state, every model field, Adam moment
    and count and every loss `torch.equal`; #1 counted once a replay and
    once a warm-up step."""
    from omnigs_torch.model.gaussians import FIELD_NAMES
    from omnigs_torch.train.trainer import WARMUP_STEPS
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    a = _window_trainer(layout, ParallelTrainer)
    b = _window_trainer(layout, ParallelTrainer)
    assert a.window_mode == "graph"
    n0 = launches("composite_seg_fwd")
    r0 = profiling.counters()["replays"]
    for _ in range(2):
        assert a.train_window(5) == 5
        for _ in range(5):
            b.train_iteration()
    torch.cuda.synchronize()
    assert a.iteration == b.iteration == 10
    assert a.step_graph.captures == 1 and profiling.counters()["replays"] - r0 == 10
    assert launches("composite_seg_fwd") - n0 == 10 + WARMUP_STEPS + 10
    assert (a._gt_bank[1].device.type == "cpu") is (layout == "host_bank")
    for k in FIELD_NAMES:
        assert torch.equal(getattr(a.model, k), getattr(b.model, k)), k
    for m in ("mu", "nu"):
        for k, v in getattr(a.opt_state, m).items():
            assert torch.equal(v, getattr(b.opt_state, m)[k]), f"{m}/{k}"
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    la = torch.cat([x.reshape(-1) for x, _, _ in a._pending_losses])
    lb = torch.stack([x for x, _, _ in b._pending_losses])
    assert torch.equal(la, lb) and bool(torch.isfinite(la).all())


@pytest.mark.gpu
def test_nccl_collectives_capture(nccl_rank):
    """Each collective the mesh runs, called directly on the one-rank NCCL
    group and captured into a CUDA graph: three replays on fresh inputs
    `torch.equal` to the eager call on the same inputs."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << 16

    def gather(x):
        out = torch.empty_like(x)  # one rank: the gathered rows are its own
        dist.all_gather_into_tensor(out, x)
        return out

    def scatter(x):
        out = torch.empty_like(x)
        dist.reduce_scatter_tensor(out, x)
        return out

    def reduce(op):
        def fn(x):
            y = x.clone()
            dist.all_reduce(y, op=op)
            return y
        return fn

    ops = {"all_gather_into_tensor": gather, "reduce_scatter_tensor": scatter,
           "all_reduce_sum": reduce(dist.ReduceOp.SUM),
           "all_reduce_max": reduce(dist.ReduceOp.MAX)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, fn in ops.items():
        x = torch.randn(n, device=dev, generator=gen)
        fn(x)  # the communicator and the stream exist before the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn(x)
        for _ in range(3):
            x.copy_(torch.randn(n, device=dev, generator=gen))
            graph.replay()
            assert torch.equal(out, fn(x.clone())), name


# (shape, rows cropped off a taller image): the training loss's cropped
# 1920x960 view (strided), an odd size, a single row of tiles
SSIM_CASES = {"crop": ((3, 900, 1920), 60), "odd": ((3, 37, 53), 0),
              "one_tile_row": ((3, 20, 300), 0)}


def _ssim_inputs(dev, case):
    (c, h, w), crop = SSIM_CASES[case]
    rng = np.random.default_rng(70 + len(case))
    gt = rng.uniform(size=(c, h + crop, w)).astype(np.float32)
    pred = np.clip(gt + rng.normal(size=gt.shape).astype(np.float32) * 0.1, 0, 1)
    cot = rng.normal(size=(c, h, w)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (pred, gt, cot)]


def _ssim_run(f, pred_full, gt_full, cot, h):
    """Mean, map and the gradients of the full prediction through ``f`` on
    the top ``h`` rows (a strided view when rows are cropped): the mean's
    (upstream −0.2), the map's with ``cot`` and with a broadcast one."""
    full = pred_full.clone().requires_grad_(True)
    pred, gt = full[:, :h], gt_full[:, :h]
    mean = f(pred, gt)
    (g_mean,) = torch.autograd.grad(-0.2 * mean, [full])
    smap = f(pred, gt, size_average=False)
    (g_cot,) = torch.autograd.grad((smap * cot).sum(), [full])
    (g_ones,) = torch.autograd.grad(f(pred, gt, size_average=False).sum(), [full])
    return [mean.detach(), smap.detach(), g_mean, g_cot, g_ones]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSIM_CASES))
def test_ssim_kernels_match_plain(case):
    """The SSIM kernels against `ssim_plain` on the card, bit for bit: the
    mean (the plain version sums in the kernels' fixed tree), the map and
    the three gradients; three forward and three backward launches."""
    dev = _cuda()
    pred, gt, cot = _ssim_inputs(dev, case)
    h = SSIM_CASES[case][0][1]
    f0, b0 = launches("ssim_fwd"), launches("ssim_bwd")
    got = _ssim_run(tl.ssim, pred, gt, cot, h)
    torch.cuda.synchronize()
    assert (launches("ssim_fwd") - f0, launches("ssim_bwd") - b0) == (3, 3)
    want = _ssim_run(tl.ssim_plain, pred, gt, cot, h)
    names = ["mean", "map", "grad_mean", "grad_map", "grad_broadcast"]
    for name, a, b in zip(names, got, want):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    assert bool(torch.isfinite(got[2]).all()) and float(got[2][:, :h].abs().max()) > 0
    assert int(torch.count_nonzero(got[2][:, h:])) == 0  # the cropped rows
    np.testing.assert_allclose(float(got[0]), float(got[1].double().mean()), rtol=2e-7)


# (case, row0, nrows): the two row blocks of the cropped view on a (1, 2)
# mesh, and the last block of a four-way ceil split of the odd size, whose
# rows run past the image
SSIM_BLOCKS = [("crop", 0, 450), ("crop", 450, 450), ("odd", 30, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,row0,nrows", SSIM_BLOCKS)
def test_ssim_row_blocks_kernels_match_plain(case, row0, nrows):
    """`ssim_rows` blocks through the kernels: the block's map rows equal
    the plain versions' and the whole map's, and the prediction's gradient
    the plain versions', bit for bit; one launch of each kernel."""
    dev = _cuda()
    pred_full, gt_full, cot = _ssim_inputs(dev, case)
    h = SSIM_CASES[case][0][1]
    valid = min(nrows, h - row0)
    cot = cot[:, :nrows]
    out = []
    def rows_plain(img1, img2, r0, n, total):  # `ssim_rows` on the plain versions
        return tl._apply(img1, img2, 11, False, True, r0, n)

    for rows in (tl.ssim_rows, rows_plain):
        full = pred_full.clone().requires_grad_(True)
        pred, gt = full[:, :h], gt_full[:, :h]
        f0, b0 = launches("ssim_fwd"), launches("ssim_bwd")
        blk = rows(pred, gt, row0, nrows, h)
        (g,) = torch.autograd.grad((blk[:, :valid] * cot[:, :valid]).sum(), [full])
        out.append((blk.detach(), g, launches("ssim_fwd") - f0, launches("ssim_bwd") - b0))
    (kb, kg, kf, kbw), (pb, pg, pf, pbw) = out
    assert (kf, kbw, pf, pbw) == (1, 1, 0, 0)
    assert torch.equal(kb, pb) and torch.equal(kg, pg), float((kg - pg).abs().max())
    whole = tl.ssim(pred_full[:, :h], gt_full[:, :h], size_average=False)
    assert torch.equal(kb[:, :valid], whole[:, row0 : row0 + valid])
    assert float(kg.abs().max()) > 0


@pytest.mark.gpu
def test_ssim_kernels_are_bitwise_repeatable():
    """Two runs of the kernels on the training loss's cropped view give the
    same bits (the mean's slots are summed in a fixed order, no atomics)."""
    dev = _cuda()
    pred, gt, cot = _ssim_inputs(dev, "crop")
    a = _ssim_run(tl.ssim, pred, gt, cot, 900)
    b = _ssim_run(tl.ssim, pred, gt, cot, 900)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# the binning's superblock pre-cull (`csrc/precull.cu`) against its plain
# version, on slabs built on the card: the benchmark's cloud at the training
# step's P = 524,288 (three quarters of the rows dead); rects of exactly 1,
# 64 and 65 tiles (the first superblock) and others around the two mask
# words; the full 120x60 grid (sx = 15, sy = 8); conics with |B| near
# sqrt(AC); opacities that put op exp(-q/2) within a few ulp of 1/255; zero
# and non-finite conics, means and opacities; inputs read through strides;
# a P that is not a multiple of the kernel's block
PRECULL_CASES = ["bench", "edge_rects", "full_grid", "rotated", "alpha_edge", "degenerate",
                 "strided", "ragged"]
PRECULL_OUT = ("lo", "hi", "tiles_eff", "sx", "sy", "wb")
GRID = (120, 60)  # tiles of a 1920x960 frame


def _bench_prep(dev, capacity=1 << 19, live=1 << 17, seed=80):
    """The benchmark's cloud (radius 1-5, log-scales N(-3.5, 0.3), opacity
    logits N(0, 1)) of ``live`` rows in a ``capacity``-row model whose other
    rows are empty slots, preprocessed at 1920x960 lonlat on the card."""
    m = GaussianModel.from_numpy(random_model_np(seed, capacity, live, scale_mu=-3.5), device=dev)
    return preprocess(
        m.xyz, m.get_scaling(), m.get_rotation(), m.get_opacity(), m.get_features(),
        Camera(CameraType.LONLAT, 16 * GRID[0], 16 * GRID[1]), torch.eye(4, device=dev),
        torch.zeros(3, device=dev), 3, active_mask=m.active, tight_culling=True,
    )


def _rows_prep(dev, rect, means, conic, opac, tiles=None):
    """A Preprocessed of hand-made rows (the fields the pre-cull reads; the
    others zeros); tiles_touched the rects' areas unless given."""
    rect = torch.as_tensor(np.asarray(rect), dtype=torch.int32, device=dev)
    if tiles is None:
        tiles = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    tiles = torch.as_tensor(tiles, dtype=torch.int32, device=dev)
    p = rect.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    return tpre.Preprocessed(
        means2d=torch.as_tensor(np.asarray(means), **f32),
        depths=torch.ones(p, **f32), conic=torch.as_tensor(np.asarray(conic), **f32),
        radii=torch.ones(p, **f32), rgb=torch.zeros(p, 3, **f32),
        opacity=torch.as_tensor(np.asarray(opac), **f32), rect=rect, tiles_touched=tiles,
        valid=tiles > 0,
    )


def _random_rows(rng, sizes, sigma=(2.0, 80.0), rho_max=0.9):
    """Rects of the given (w, h) tiles at random places in the grid, means
    near them (inside or up to a rect's size outside), conics of Gaussians
    of random size and angle, opacities in (0.01, 1)."""
    sizes = np.asarray(sizes)
    n = len(sizes)
    x0 = rng.integers(0, GRID[0] - sizes[:, 0] + 1)
    y0 = rng.integers(0, GRID[1] - sizes[:, 1] + 1)
    rect = np.stack([x0, y0, x0 + sizes[:, 0], y0 + sizes[:, 1]], -1)
    centre = 16.0 * (rect[:, :2] + rect[:, 2:]) / 2
    means = centre + rng.uniform(-1.0, 1.0, (n, 2)) * 16.0 * sizes
    sx, sy = np.exp(rng.uniform(np.log(sigma[0]), np.log(sigma[1]), (2, n)))
    rho = rng.uniform(-rho_max, rho_max, n)
    a, b, c = sx * sx, rho * sx * sy, sy * sy
    det = a * c - b * b
    conic = np.stack([c / det, -b / det, a / det], -1)
    return rect, means, conic, rng.uniform(0.01, 1.0, n)


def _precull_prep(case, dev):
    rng = np.random.default_rng(90 + PRECULL_CASES.index(case))
    if case == "bench":
        return _bench_prep(dev)
    if case == "edge_rects":
        shapes = [(1, 1), (8, 8), (64, 1), (1, 60), (65, 1), (13, 5), (5, 13), (9, 8), (33, 2),
                  (11, 6), (16, 4), (120, 1)]
        return _rows_prep(dev, *_random_rows(rng, np.repeat(shapes, 48, axis=0)))
    if case == "full_grid":
        n = 256
        rect = np.tile([0, 0, *GRID], (n, 1))
        means = rng.uniform([-400, -400], [16 * GRID[0] + 400, 16 * GRID[1] + 400], (n, 2))
        _, _, conic, opac = _random_rows(rng, np.ones((n, 2), int), sigma=(5.0, 900.0))
        return _rows_prep(dev, rect, means, conic, opac)
    if case == "rotated":
        sizes = rng.integers(1, 13, (1024, 2))
        rect, means, _, opac = _random_rows(rng, sizes)
        a, c = np.exp(rng.normal(-6.0, 1.5, (2, 1024)))
        rho = rng.choice([-1, 1], 1024) * (1 - 10.0 ** -rng.uniform(1, 7, 1024))
        return _rows_prep(dev, rect, means, np.stack([a, rho * np.sqrt(a * c), c], -1), opac)
    if case == "alpha_edge":
        # block 0 (the rect's first tile) reaches 1/255 within k ulp, k in -4..4
        base = 128
        rect, means, conic, _ = _random_rows(rng, rng.integers(1, 4, (base, 2)), sigma=(4.0, 40.0))
        prep = _rows_prep(dev, rect, means, conic, np.ones(base))
        r, m, q = prep.rect, prep.means2d, prep.conic
        px0, py0 = (r[:, 0] * 16).to(torch.float32), (r[:, 1] * 16).to(torch.float32)
        qmin = tbin._min_quad_over_box(
            q[:, 0], q[:, 1], q[:, 2], px0 - m[:, 0], px0 + 15.0 - m[:, 0],
            py0 - m[:, 1], py0 + 15.0 - m[:, 1])
        op0 = torch.full_like(qmin, 1.0 / 255.0) / torch.exp(-0.5 * qmin)
        ops = []
        for k in range(-4, 5):
            op, toward = op0.clone(), torch.full_like(op0, np.inf if k > 0 else 0.0)
            for _ in range(abs(k)):
                op = torch.nextafter(op, toward)
            ops.append(op)
        rep = lambda t: t.repeat(9, *([1] * (t.ndim - 1)))  # noqa: E731
        return _rows_prep(dev, rep(r).cpu(), rep(m).cpu(), rep(q).cpu(), torch.cat(ops).cpu())
    if case == "degenerate":
        n = 2048
        rect, means, conic, opac = _random_rows(rng, rng.integers(1, 11, (n, 2)))
        odd = [(0, 0, 0), (np.nan, 0, 1), (1, np.nan, 1), (1, 0, np.nan), (np.inf, 0, 1),
               (1, 0, np.inf), (1, np.inf, 1), (-np.inf, 0, 1), (-1, 0, -1), (1e-30, 0, 1e-30),
               (1e38, 0, 1e38), (1, 2, 1), (0, 1, 0)]
        pick = rng.integers(0, len(odd) + 1, n)  # len(odd): the row's own conic
        conic = np.where((pick < len(odd))[:, None], np.asarray(odd + [(0, 0, 0)])[pick], conic)
        means[rng.uniform(size=n) < 0.1] = np.nan
        means[rng.uniform(size=(n, 2)) < 0.05] = np.inf
        opac = np.where(rng.uniform(size=n) < 0.1, rng.choice([np.nan, 0.0, 1.0, np.inf], n), opac)
        tiles = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        tiles[rng.uniform(size=n) < 0.2] = 0  # dead rows with whatever floats
        return _rows_prep(dev, rect, means, conic, opac, tiles)
    if case == "strided":
        prep = _rows_prep(dev, *_random_rows(rng, rng.integers(1, 14, (3000, 2))))
        p = prep.rect.shape[0]

        def spread(t, width, at):  # t as columns `at` of a wider buffer
            buf = torch.zeros(p, width, dtype=t.dtype, device=dev)
            buf[:, at] = t.reshape(buf[:, at].shape)
            return buf[:, at]

        return prep._replace(
            rect=spread(prep.rect, 8, slice(0, 8, 2)), tiles_touched=spread(prep.tiles_touched, 2, 1),
            means2d=spread(prep.means2d, 6, slice(2, 4)), conic=spread(prep.conic, 6, slice(1, 6, 2)),
            opacity=spread(prep.opacity, 3, 2))
    assert case == "ragged"
    return _rows_prep(dev, *_random_rows(rng, rng.integers(1, 12, (1037, 2))))


@pytest.mark.gpu
@pytest.mark.parametrize("case", PRECULL_CASES)
def test_precull_kernel_matches_plain(case):
    """The pre-cull kernel `torch.equal` to `_precull_masks_plain` on the card
    in all six outputs, dead rows included; one launch."""
    dev = _cuda()
    prep = _precull_prep(case, dev)
    before = launches("precull")
    got = tbin._precull_masks(prep, GRID[0])
    torch.cuda.synchronize()
    assert launches("precull") == before + 1
    want = tbin._precull_masks_plain(prep, GRID[0])
    for name, a, b in zip(PRECULL_OUT, got, want):
        assert a.dtype == torch.int32 and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
    lo, hi, _, sx, sy, _ = got
    if case == "bench":
        live = int((prep.tiles_touched > 0).sum())
        assert prep.rect.shape[0] == 1 << 19 and 0 < live <= 1 << 17
        assert bool((lo[prep.tiles_touched == 0] == 0).all())
    if case == "edge_rects":
        assert bool((sx > 1).any()) and bool((hi != 0).any()) and bool((lo < 0).any())
    if case == "full_grid":
        assert bool((sx == 15).all()) and bool((sy == 8).all())
    if case == "alpha_edge":
        bit0 = lo & 1
        assert bool((bit0 == 1).any()) and bool((bit0 == 0).any())


@pytest.mark.gpu
def test_precull_kernel_on_no_rows_launches_nothing():
    dev = _cuda()
    prep = _rows_prep(dev, np.zeros((0, 4)), np.zeros((0, 2)), np.zeros((0, 3)), np.zeros(0))
    before = launches("precull")
    out = tbin._precull_masks(prep, GRID[0])
    assert launches("precull") == before
    assert all(t.shape == (0,) and t.dtype == torch.int32 for t in out)


@pytest.mark.gpu
def test_binning_with_precull_kernel_matches_plain_precull(monkeypatch):
    """`bin_instances_packed` + `segment_relay` on the card at the training
    step's shape (P = 524,288, 2^22 slots) with the pre-cull kernel and with
    its plain version: every output `torch.equal`; one launch."""
    dev = _cuda()
    prep = _bench_prep(dev)
    p = prep.rect.shape[0]

    def run():
        inst = bin_instances_packed(prep, *GRID, 1 << 22, tile_cull=True)
        seg = segment_relay(inst.sorted_g, inst.starts, inst.counts, 1 << 22, p, inst.sorted_key)
        return [t for t in (*inst, *seg) if t is not None]

    before = launches("precull")
    got = run()
    assert launches("precull") == before + 1
    monkeypatch.setattr(tbin, "precull", lambda pr: tbin._precull_masks_plain(pr, GRID[0]))
    want = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3]) > 0  # instances emitted


@pytest.mark.gpu
def test_render_request_launches_one_precull():
    """A render request through the production layout runs the pre-cull
    kernel once, and the expansion kernel once."""
    dev = _cuda()
    m = GaussianModel.from_numpy(random_model_np(81, 2048, 1500), device=dev)
    before = launches("precull", "expand_keys")
    with torch.inference_mode():
        render_model(m, Camera(CameraType.LONLAT, 256, 128), torch.eye(4, device=dev),
                     torch.zeros(3, device=dev), torch.zeros(3, device=dev), 3,
                     RasterConfig(max_instances=1 << 14, **PROD_KW))
    torch.cuda.synchronize()
    assert launches("precull", "expand_keys") == (before[0] + 1, before[1] + 1)


# the packed binning's expansion (`csrc/expand_keys.cu`) against its plain
# version, on inputs built on the card: the benchmark's cloud at the training
# step's shape (P = 524,288, a quarter live, 2^22 slots, the cull on); its
# emission truncated at 2^18 slots (live bound) and at 300,001 (none); a slot
# count that is not a multiple of 2^16 (no live bound) and exactly one chunk;
# a tile window; the cull off; runs of ranks with no tiles; an owner window
# wider than a block's stage (one rank in 64 emits); no emission at all; one row
EXPAND_CASES = {
    # case: (slots, tile_cull, tile_lo, n_tiles)
    "bench": (1 << 22, True, 0, None),
    "truncated": (1 << 18, True, 0, None),
    "truncated_ragged": (300_001, True, 0, None),
    "ragged_slots": ((1 << 22) - 12_345, True, 0, None),
    "one_chunk": (1 << 16, True, 0, None),
    "tile_window": (1 << 22, True, 1_234, 2_000),
    "no_cull": (1 << 22, False, 0, None),
    "zero_runs": (1 << 20, True, 0, None),
    "wide_window": (1 << 16, True, 0, None),
    "no_emission": (1 << 22, True, 0, None),
    "one_row": (1 << 17, True, 0, None),
}


def _expand_inputs(prep, tile_cull, cull=None):
    """What `bin_instances_packed` hands the expansion: the cull masks (the
    pre-cull's, or ``cull`` with its budget), the depth order, the budget and
    its offsets in that order."""
    if cull is None:
        tiles, cull = tbin._emission_budget(prep, GRID[0], tile_cull)
    else:
        tiles = (tbin._popcount32(cull[0]) + tbin._popcount32(cull[1])) * cull[2] * cull[3]
    return (cull, *tbin._depth_ranks(prep.depths, tiles))


def _expand_prep(case, dev):
    rng = np.random.default_rng(110 + list(EXPAND_CASES).index(case))
    if case in ("bench", "truncated", "truncated_ragged", "ragged_slots", "tile_window",
                "no_cull"):
        return _bench_prep(dev)
    if case == "one_chunk":
        return _rows_prep(dev, *_random_rows(rng, rng.integers(1, 9, (2000, 2))))
    if case == "zero_runs":
        # alternating runs of emitting ranks and of ranks with no tiles, 1 to 3,000 long
        n = 1 << 17
        prep = _rows_prep(dev, *_random_rows(rng, rng.integers(1, 6, (n, 2))))
        runs = np.repeat(np.arange(n) % 2, rng.integers(1, 3000, n))[:n]
        keep = torch.as_tensor(runs, dtype=torch.int32, device=dev)
        return prep._replace(tiles_touched=prep.tiles_touched * keep)
    if case == "wide_window":
        n = 1 << 19
        rect, means, conic, opac = _random_rows(rng, np.ones((n, 2), int), sigma=(40.0, 80.0))
        return _rows_prep(dev, rect, means, conic, opac, (np.arange(n) % 64 == 0).astype(int))
    if case == "no_emission":
        rect, means, conic, opac = _random_rows(rng, rng.integers(1, 6, (4096, 2)))
        return _rows_prep(dev, rect, means, conic, opac, np.zeros(4096, int))
    assert case == "one_row"
    return _rows_prep(dev, [[40, 20, 52, 29]], [[740.0, 390.0]], [[2e-4, 1e-5, 3e-4]], [0.9])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_keys_kernel_matches_plain(case):
    """The expansion kernel's keys `torch.equal` to `_expand_keys_plain`'s on
    the card, dead slots included; one launch."""
    dev = _cuda()
    slots, tile_cull, tile_lo, n_tiles = EXPAND_CASES[case]
    prep = _expand_prep(case, dev)
    cull, perm, tiles_d, offsets_d = _expand_inputs(prep, tile_cull)
    args = (prep, cull, perm, tiles_d, offsets_d, slots, GRID[0],
            n_tiles or GRID[0] * GRID[1], tile_lo)
    before = launches("expand_keys")
    got = tbin._packed_keys(*args)
    torch.cuda.synchronize()
    assert launches("expand_keys") == before + 1
    want = tbin._expand_keys_plain(*args)
    assert got.dtype == torch.int64 and got.shape == want.shape == (slots,)
    assert torch.equal(got, want), int((got != want).sum())
    total, live = int(offsets_d[-1] + tiles_d[-1]), int(((want >> tbin.RANK_BITS) < args[7]).sum())
    if case == "bench":
        assert prep.rect.shape[0] == 1 << 19 and 0 < total <= slots and live > 0
    if case.startswith("truncated"):
        assert total > slots
    if case in ("one_chunk", "zero_runs", "wide_window", "one_row"):
        assert 0 < live and total < slots
    if case == "no_emission":
        assert total == 0 and bool((want == args[7] << tbin.RANK_BITS).all())


@pytest.mark.gpu
def test_expand_keys_kernel_selects_the_kth_set_bit():
    """The kernel's block select against `_kth_set_bit` on random masks: 1x1
    blocks of an 8x8 rect at the grid's corner and alpha 1, so every slot's
    tile is the block its k-th set bit names, k the slot's index in its row."""
    dev = _cuda()
    rng = np.random.default_rng(120)
    n = 1 << 14
    words = rng.integers(-(1 << 31), 1 << 31, size=(2, n)).astype(np.int32)
    words[:, :6] = [[-1, 0, -(1 << 31), 1, 0, -1], [-1, -(1 << 31), 0, 0, 1, 0]]
    lo, hi = (torch.as_tensor(w, device=dev) for w in words)
    one = torch.ones(n, dtype=torch.int32, device=dev)
    prep = _rows_prep(dev, np.tile([0, 0, 8, 8], (n, 1)), np.zeros((n, 2)), np.zeros((n, 3)),
                      np.ones(n))
    cull, perm, tiles_d, offsets_d = _expand_inputs(prep, True, (lo, hi, one, one, 8 * one))
    slots = int(offsets_d[-1] + tiles_d[-1])
    args = (prep, cull, perm, tiles_d, offsets_d, slots, GRID[0], GRID[0] * GRID[1])
    key = tbin.expand_keys(*args)
    assert torch.equal(key, tbin._expand_keys_plain(*args))
    g = (key & ((1 << tbin.RANK_BITS) - 1)).long()
    tid = key >> tbin.RANK_BITS
    block = (tid // GRID[0]) * 8 + tid % GRID[0]
    k = torch.arange(slots, device=dev) - offsets_d.long()[g]
    assert torch.equal(block.int(), tbin._kth_set_bit(lo[g], hi[g], k.int()))


@pytest.mark.gpu
@pytest.mark.parametrize("with_emission", [False, True])
def test_packed_binning_with_expand_kernel_matches_plain(monkeypatch, with_emission):
    """`bin_instances_packed` at the training step's shape (P = 524,288, 2^22
    slots, the cull on) with the expansion kernel and with its plain version:
    every output `torch.equal`, the survivor payload too; one launch."""
    dev = _cuda()
    prep = _bench_prep(dev)

    def run():
        out = bin_instances_packed(prep, *GRID, 1 << 22, tile_cull=True,
                                   with_emission=with_emission)
        return [t for t in out if t is not None]

    before = launches("expand_keys")
    got = run()
    assert launches("expand_keys") == before + 1
    monkeypatch.setattr(tbin, "expand_keys", tbin._expand_keys_plain)
    want = run()
    assert len(got) == len(want) == (11 if with_emission else 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3]) > 0  # instances emitted


@pytest.mark.gpu
def test_guarded_asin_is_autograds_on_the_card():
    """The lonlat latitude's asin on the card: forward and derivative bit for
    bit autograd's for |x| < 1, finite at ±1 (where autograd's is inf)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(32)
    x = torch.rand(1 << 20, device=dev, generator=gen) * 2 - 1
    x[:3] = torch.tensor([1 - 2**-24, -(1 - 2**-24), 0.0], device=dev)
    x.requires_grad_(True)
    up = torch.randn(x.shape, device=dev, generator=gen)
    (want,) = torch.autograd.grad(torch.asin(x), [x], up)
    (got,) = torch.autograd.grad(tcam._Asin.apply(x), [x], up)
    assert torch.equal(got, want) and torch.equal(tcam._Asin.apply(x), torch.asin(x))
    e = torch.tensor([1.0, -1.0], device=dev, requires_grad=True)
    (d,) = torch.autograd.grad(tcam._Asin.apply(e).sum(), [e])
    assert bool(torch.isfinite(d).all())
