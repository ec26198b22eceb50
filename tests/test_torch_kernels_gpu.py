"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Marked `gpu`; each test skips without a CUDA device. This module
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Inputs come from the port's own CPU pipeline on numpy-seeded clouds.
Bars: forward atol 1e-5 (the kernel sums the log-transmittance
sequentially, the plain version per 32-instance step — summation order
only); backward rows max |Δ| ≤ 1e-4·max|plain| per row (the same relative
bar as `chip_smoke.py`; the kernel sums the pixel partials by warp
shuffles, the plain version with torch.sum); the training step on the card
against the same step on the CPU at the gradient bars of
tests/test_torch_trainer.py."""

import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.model.optimizer import LRConfig, init_adam
from omnigs_torch.ops import composite_seg as tcs
from omnigs_torch.ops.binning import bin_instances_packed, segment_relay
from omnigs_torch.ops.preprocess import preprocess
from omnigs_torch.ops.rasterize import RasterConfig, _tiles_to_image
from omnigs_torch.train.renderer import render_model
from omnigs_torch.train.trainer import train_step

from torch_helpers import PROD_KW, random_cloud_np, random_model_np, to_torch


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    return torch.device("cuda")


def _slab(seed, n, w, h, squeeze, max_instances):
    c = to_torch(random_cloud_np(seed, n))
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


@pytest.mark.gpu
@pytest.mark.parametrize(
    "seed,n,squeeze",
    [(41, 24, (1.0, 1.0, 1.0)), (42, 512, (0.2, 0.2, 1.0))],
    ids=["sparse", "multichunk"],
)
def test_composite_seg_fwd_kernel_matches_plain(seed, n, squeeze):
    dev = _cuda()
    slab, seg, gx, num_tiles = _slab(seed, n, 256, 128, squeeze, 1 << 14)
    args = [t.to(dev) for t in (slab, seg.starts8, seg.counts, seg.live8)]
    before = tcs.composite_seg_fwd.launches
    kc, kt = tcs.composite_seg_fwd(*args, num_tiles, gx)
    torch.cuda.synchronize()
    assert tcs.composite_seg_fwd.launches == before + 1
    pc, pt, _, _ = tcs.composite_seg_fwd_plain(
        args[0], args[1], args[2], num_tiles, gx
    )
    np.testing.assert_allclose(kc.cpu().numpy(), pc.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(kt.cpu().numpy(), pt.cpu().numpy(), atol=1e-5)
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
        out[str(d)] = [t.cpu() for t in (*inst, *seg)]
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


def _bwd_inputs(dev, seed, n, squeeze):
    slab, seg, gx, num_tiles = _slab(seed, n, 256, 128, squeeze, 1 << 14)
    args = [t.to(dev) for t in (slab, seg.starts8, seg.counts, seg.live8)]
    color, final_t = tcs.composite_seg_fwd(*args, num_tiles, gx)
    color_full = (color + final_t[:, None, :] * 0.2).contiguous()
    rng = np.random.default_rng(seed)
    dcolor = torch.from_numpy(
        rng.normal(size=(num_tiles, 3, 256)).astype(np.float32)
    ).to(dev)
    return args, color_full, dcolor, seg, gx, num_tiles


@pytest.mark.gpu
@pytest.mark.parametrize(
    "seed,n,squeeze",
    [(41, 24, (1.0, 1.0, 1.0)), (42, 512, (0.2, 0.2, 1.0))],
    ids=["sparse", "multichunk"],
)
def test_composite_seg_bwd_kernel_matches_plain(seed, n, squeeze):
    dev = _cuda()
    args, color_full, dcolor, seg, gx, num_tiles = _bwd_inputs(dev, seed, n, squeeze)
    before = tcs.composite_seg_bwd.launches
    got = tcs.composite_seg_bwd(*args, color_full, dcolor, num_tiles, gx)
    torch.cuda.synchronize()
    assert tcs.composite_seg_bwd.launches == before + 1
    ref = tcs.composite_seg_bwd_plain(
        args[0], args[1], args[2], color_full, dcolor, num_tiles, gx
    )
    for r in range(tcs.NGRAD):
        scale = float(ref[r].abs().max())
        assert scale > 0
        assert float((got[r] - ref[r]).abs().max()) <= 1e-4 * scale, r
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
