"""PyTorch port vs JAX reference, end to end through the layouts beside the
packed key: the ghost-aligned slab (``ghost_align``), the compact 2-key
binning without a depth presort (segmented and tile-major) and the dense
XLA-style compositor (``backend="xla"``), each through `rasterize` and its
gradient; the goldens through the XLA backend; the XLA backend's float32
distance from float64, which the JAX package's float32 has too.

Bars: image and final_T atol 1e-5, n_contrib, radii, truncation and
overflow equal (tests/test_pallas_raster.py); gradients rtol 2e-3, atol
1e-4·max|ref| (tests/test_gather_reduce.py); the goldens at
tests/test_goldens.py's bars; port and JAX float32 within 1% of the
Pallas-vs-XLA gradient bar of each other."""

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
from omnigs_torch.utils import profiling
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.ops.rasterize import rasterize as jrasterize

from torch_helpers import PROD_KW, random_cloud_np

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
KEYS = ("means3d", "scales", "quats", "opacities", "shs")
W, H = 128, 64
TILE_KW = dict(PROD_KW, want_ncontrib=True, segmented=False)

LAYOUTS = {
    # the chip check's pairing (scripts/check_jit_parity.py:196-205)
    "ghost": dict(TILE_KW, ghost_align=True, depth_presort=False, gather_reduce=False,
                  want_ncontrib=False),
    # ghost slab with the survivor-rank payload and a live-slab trim
    "ghost_gather_trim": dict(TILE_KW, ghost_align=True, aligned_cap=1024),
    "nopresort_seg": dict(PROD_KW, depth_presort=False),
    "nopresort_tile": dict(TILE_KW, depth_presort=False),
    "nopresort_tile_scatter": dict(TILE_KW, depth_presort=False, gather_reduce=False),
    "xla": dict(backend="xla", tile_cap=64, chunk=16, tight_culling=True),
    "xla_overflow": dict(backend="xla", tile_cap=16, chunk=8),
}
# which kernels of the port each layout launches (CPU tensors run the
# plain versions; the counters must not move)
SEG = ("nopresort_seg",)


def _pose():
    c, s = np.cos(0.4), np.sin(0.4)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    vm[:3, 3] = [0.05, -0.1, 0.15]
    campos = (-vm[:3, :3].T @ vm[:3, 3]).astype(np.float32)
    return vm, campos


def _weights(shape):
    return np.linspace(0.5, 1.5, int(np.prod(shape)), dtype=np.float32).reshape(shape)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rasterize_layout_matches_jax(layout):
    n = 80
    c = random_cloud_np(81, n, scale_mu=-1.4)
    arrays = [c[k] for k in KEYS]
    ndc = np.zeros((n, 2), np.float32)
    vm, campos = _pose()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = LAYOUTS[layout]
    interp = dict(interpret=True) if kw.get("backend") == "pallas" else {}

    def jloss(*a):
        res = jrasterize(
            *a[:5], camera=Camera(CameraType.LONLAT, W, H),
            viewmatrix=jnp.asarray(vm), campos=jnp.asarray(campos),
            bg=jnp.asarray(bg), sh_degree=2,
            config=JRasterConfig(max_instances=1 << 12, **interp, **kw),
            means2d_ndc=a[5],
        )
        return jnp.sum(res.image * jnp.asarray(_weights(res.image.shape))), res

    (_, res_j), grads_j = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(ndc)
    )
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays + [ndc]]
    before = profiling.counters()["launches"]
    res_t = trasterize(
        *leaves[:5], camera=TCamera(TCameraType.LONLAT, W, H),
        viewmatrix=torch.from_numpy(vm), campos=torch.from_numpy(campos),
        bg=torch.from_numpy(bg), sh_degree=2,
        config=TRasterConfig(max_instances=1 << 12, **kw), means2d_ndc=leaves[5],
    )
    loss = torch.sum(res_t.image * torch.from_numpy(_weights(tuple(res_t.image.shape))))
    grads_t = torch.autograd.grad(loss, leaves)
    assert profiling.counters()["launches"] == before  # CPU: plain versions
    np.testing.assert_allclose(res_t.image.detach().numpy(), np.asarray(res_j.image), atol=1e-5)
    np.testing.assert_allclose(res_t.final_T.numpy(), np.asarray(res_j.final_T), atol=1e-5)
    np.testing.assert_array_equal(res_t.n_contrib.numpy(), np.asarray(res_j.n_contrib))
    np.testing.assert_array_equal(res_t.radii.detach().numpy(), np.asarray(res_j.radii))
    assert int(res_t.truncated) == int(res_j.truncated)
    assert int(res_t.overflow) == int(res_j.overflow)
    assert (int(res_t.truncated) > 0) == layout.endswith("_trim")
    assert (int(res_t.overflow) > 0) == layout.endswith("_overflow")
    computes_nc = kw.get("backend") == "xla" or (kw["want_ncontrib"] and not kw["segmented"])
    assert (int(res_t.n_contrib.max()) > 0) == computes_nc
    for g, r, name in zip(grads_t, grads_j, KEYS + ("means2d_ndc",)):
        r = np.asarray(r)
        assert g.shape == r.shape and np.abs(r).max() > 0, name
        np.testing.assert_allclose(
            g.numpy(), r, rtol=2e-3, atol=1e-4 * np.abs(r).max(), err_msg=name
        )


@pytest.mark.parametrize(
    "fname,width,height,sh_degree",
    [("simple_cloud.npz", 512, 256, 0), ("random_cloud.npz", 256, 128, 3)],
    ids=["simple_cloud", "random_cloud"],
)
def test_goldens_xla(fname, width, height, sh_degree):
    """The oracle's image, final_T and gradients through the XLA backend
    with tests/test_goldens.py's config."""
    data = np.load(GOLDEN_DIR / fname)
    leaves = [torch.from_numpy(data[f"in_{k}"]).requires_grad_(True) for k in KEYS]
    res = trasterize(
        *leaves, camera=TCamera(TCameraType.LONLAT, width, height),
        viewmatrix=torch.eye(4), campos=torch.zeros(3),
        bg=torch.tensor([0.1, 0.2, 0.3]), sh_degree=sh_degree,
        config=TRasterConfig(max_instances=1 << 15, tile_cap=256, chunk=32),
    )
    np.testing.assert_allclose(res.image.detach().numpy(), data["image"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.final_T.numpy(), data["final_T"], rtol=1e-5, atol=1e-6)
    assert int(res.truncated) == 0 and int(res.overflow) == 0
    loss = torch.sum(res.image * torch.from_numpy(data["loss_w"]))
    for g, k in zip(torch.autograd.grad(loss, leaves), KEYS):
        ref = data[f"g_{k}"]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3, atol=2e-4 * scale, err_msg=k)


def test_layouts_render_alike():
    """The same cloud through every layout of the port: images within 1e-5
    of the packed-key segmented render (the production layout)."""
    c = {k: torch.from_numpy(v) for k, v in random_cloud_np(82, 120, scale_mu=-1.6).items()}
    vm, campos = _pose()
    out = {}
    for name, kw in dict(LAYOUTS, packed=PROD_KW).items():
        if name.endswith(("_trim", "_overflow")):
            continue
        with torch.inference_mode():
            out[name] = trasterize(
                *[c[k] for k in KEYS], camera=TCamera(TCameraType.LONLAT, W, H),
                viewmatrix=torch.from_numpy(vm), campos=torch.from_numpy(campos),
                bg=torch.zeros(3), sh_degree=3,
                config=TRasterConfig(max_instances=1 << 13, **dict(kw, tight_culling=True)),
            )
    ref = out.pop("packed")
    for name, res in out.items():
        np.testing.assert_allclose(res.image.numpy(), ref.image.numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(res.final_T.numpy(), ref.final_T.numpy(), atol=1e-5,
                                   err_msg=name)


def _bar_ratio(got, ref):
    """Per Gaussian: max |got − ref| / (1e-4·max|ref| + 1e-3·|ref|), the
    JAX package's Pallas-vs-XLA gradient bar (tests/test_pallas_raster.py)."""
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    err = np.abs(np.asarray(got, np.float64).reshape(ref.shape) - ref)
    return np.where(err == 0, 0.0, err / (1e-4 * np.abs(ref).max() + 1e-3 * np.abs(ref))).max(axis=1)


def test_xla_float32_gap_matches_the_reference():
    """The XLA backend's float32 gradients miss the float64 ones at the JAX
    bar on a small cloud (Gaussian 61's opacity, 1.66× the bar: one of its
    pairs sits at α = 1/255, live in one precision only), and the JAX
    package's float32 XLA path misses them the same way: the port's and the
    reference's float32 gradients lie within 1% of the bar of each other."""
    w, h, n = 128, 64, 800
    c = random_cloud_np(3, n, scale_mu=-2.0)
    arrays = [c[k] for k in KEYS]
    vm, campos = np.eye(4, dtype=np.float32), np.zeros(3, np.float32)
    wts = np.random.default_rng(3).uniform(0.5, 1.5, size=(3, h, w)).astype(np.float32)
    kw = dict(backend="xla", tile_cap=1024, chunk=32, tight_culling=True)

    def jloss(*a):
        res = jrasterize(
            *a, camera=Camera(CameraType.LONLAT, w, h), viewmatrix=jnp.asarray(vm),
            campos=jnp.asarray(campos), bg=jnp.zeros(3), sh_degree=2,
            config=JRasterConfig(max_instances=1 << 14, **kw),
        )
        return jnp.sum(res.image * jnp.asarray(wts))

    grads_j = jax.grad(jloss, argnums=tuple(range(5)))(*[jnp.asarray(a) for a in arrays])
    grads = {}
    for dt in (torch.float32, torch.float64):
        leaves = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in arrays]
        res = trasterize(
            *leaves, camera=TCamera(TCameraType.LONLAT, w, h),
            viewmatrix=torch.from_numpy(vm).to(dt), campos=torch.from_numpy(campos).to(dt),
            bg=torch.zeros(3, dtype=dt), sh_degree=2,
            config=TRasterConfig(max_instances=1 << 14, **kw),
        )
        loss = torch.sum(res.image * torch.from_numpy(wts).to(dt))
        grads[dt] = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    for i, name in enumerate(KEYS):
        exact = grads[torch.float64][i]
        port = _bar_ratio(grads[torch.float32][i], exact)
        ref = _bar_ratio(np.asarray(grads_j[i]), exact)
        assert _bar_ratio(grads[torch.float32][i], np.asarray(grads_j[i])).max() <= 0.01, name
        np.testing.assert_allclose(port, ref, atol=0.01, err_msg=name)
    opacity = _bar_ratio(grads[torch.float32][3], grads[torch.float64][3])
    assert int(np.argmax(opacity)) == 61 and opacity[61] > 1.0
