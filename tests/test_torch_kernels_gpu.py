"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Marked `gpu`; each test skips without a CUDA device. This module
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Inputs come from the port's own CPU pipeline on numpy-seeded clouds.
Bars: atol 1e-5 (the kernel sums the log-transmittance sequentially, the
plain version per 32-instance step — summation order only)."""

import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops import composite_seg as tcs
from omnigs_torch.ops.binning import bin_instances_packed, segment_relay
from omnigs_torch.ops.preprocess import preprocess
from omnigs_torch.ops.rasterize import RasterConfig, _tiles_to_image
from omnigs_torch.train.renderer import render_model

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
