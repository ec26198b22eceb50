"""PyTorch port vs JAX reference: the gradients of `rasterize` on the
production path (segmented, packed, tight- and tile-culled), through the
autograd Function, the segmented backward, the instance → Gaussian
reduction and autograd back through `preprocess`.

Bars: the JAX suite's gradient bars between its own backends (rtol 2e-3,
atol 1e-4·max|ref|, tests/test_pallas_seg.py); the goldens' gradients at
tests/test_goldens.py's bars (rtol 2e-3, atol 2e-4·max)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.ops.rasterize import rasterize as trasterize
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.ops.rasterize import rasterize as jrasterize

from torch_helpers import PROD_KW, random_cloud_np

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
KEYS = ("means3d", "scales", "quats", "opacities", "shs")


def _pose():
    c, s = np.cos(0.4), np.sin(0.4)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    vm[:3, 3] = [0.1, -0.05, 0.2]
    campos = (-vm[:3, :3].T @ vm[:3, 3]).astype(np.float32)
    return vm, campos


def _weights(shape):
    return np.linspace(0.5, 1.5, int(np.prod(shape)), dtype=np.float32).reshape(shape)


def _jax_grads(arrays, ndc, w, h, sh_degree, vm, campos, bg, cfg):
    def loss(m, s, q, o, sh, nd):
        res = jrasterize(
            m, s, q, o, sh, camera=Camera(CameraType.LONLAT, w, h),
            viewmatrix=jnp.asarray(vm), campos=jnp.asarray(campos),
            bg=jnp.asarray(bg), sh_degree=sh_degree, config=cfg, means2d_ndc=nd,
        )
        return jnp.sum(res.image * jnp.asarray(_weights(res.image.shape)))

    args = [jnp.asarray(a) for a in arrays] + [jnp.asarray(ndc)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(*args)]


def _torch_grads(arrays, ndc, w, h, sh_degree, vm, campos, bg, cfg):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]
    nd = torch.from_numpy(np.array(ndc)).requires_grad_(True)
    res = trasterize(
        *leaves, camera=TCamera(TCameraType.LONLAT, w, h),
        viewmatrix=torch.from_numpy(vm), campos=torch.from_numpy(campos),
        bg=torch.from_numpy(bg), sh_degree=sh_degree, config=cfg, means2d_ndc=nd,
    )
    loss = torch.sum(res.image * torch.from_numpy(_weights(tuple(res.image.shape))))
    return [g.numpy() for g in torch.autograd.grad(loss, leaves + [nd])], res


@pytest.mark.parametrize("sh_degree", [2, 3])
def test_rasterize_grads_match_jax(sh_degree):
    c = random_cloud_np(61 + sh_degree, 96)
    arrays = [c[k] for k in KEYS]
    ndc = np.zeros((96, 2), np.float32)
    vm, campos = _pose()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    common = (ndc, 128, 64, sh_degree, vm, campos, bg)
    ref = _jax_grads(
        arrays, *common,
        JRasterConfig(max_instances=1 << 12, interpret=True, **PROD_KW),
    )
    got, res = _torch_grads(
        arrays, *common, TRasterConfig(max_instances=1 << 12, **PROD_KW)
    )
    assert int(res.truncated) == 0
    for g, r, name in zip(got, ref, KEYS + ("means2d_ndc",)):
        assert g.shape == r.shape, name
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(
            g, r, rtol=2e-3, atol=1e-4 * np.abs(r).max(), err_msg=name
        )


@pytest.mark.parametrize(
    "fname,width,height,sh_degree",
    [("simple_cloud.npz", 512, 256, 0), ("random_cloud.npz", 256, 128, 3)],
    ids=["simple_cloud", "random_cloud"],
)
def test_golden_grads(fname, width, height, sh_degree):
    """The oracle's gradients of the goldens through the port's production
    path with 3σ rects (tight culling is not output-identical at the
    right/bottom rect edge, ROADMAP queue 3)."""
    data = np.load(GOLDEN_DIR / fname)
    leaves = [torch.from_numpy(data[f"in_{k}"]).requires_grad_(True) for k in KEYS]
    res = trasterize(
        *leaves, camera=TCamera(TCameraType.LONLAT, width, height),
        viewmatrix=torch.eye(4), campos=torch.zeros(3),
        bg=torch.tensor([0.1, 0.2, 0.3]), sh_degree=sh_degree,
        config=TRasterConfig(max_instances=1 << 15, **dict(PROD_KW, tight_culling=False)),
    )
    loss = torch.sum(res.image * torch.from_numpy(data["loss_w"]))
    grads = torch.autograd.grad(loss, leaves)
    for g, k in zip(grads, KEYS):
        ref = data[f"g_{k}"]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=2e-3, atol=2e-4 * scale, err_msg=k
        )
