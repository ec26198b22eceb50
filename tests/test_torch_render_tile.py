"""PyTorch port vs JAX reference, end to end on the tile-major path
(``RasterConfig.segmented=False``, what ``Tpu.want_ncontrib: 1`` selects):
`rasterize` with its three gradient routes and the ``aligned_cap`` trim,
the committed goldens, the config mapping, and one training step.

Bars: image and final_T atol 1e-5, n_contrib, radii and truncation equal
(tests/test_pallas_raster.py); gradients rtol 2e-3, atol 1e-4·max|ref|
(tests/test_gather_reduce.py); the goldens at tests/test_goldens.py's bars;
the training step at tests/test_torch_trainer.py's."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnigs_torch.config as tconfig
from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.model import optimizer as topt
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.ops.rasterize import rasterize as trasterize
from omnigs_torch.train import trainer as ttrainer
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.ops.rasterize import rasterize as jrasterize
from omnigs_tpu.train import trainer as jtrainer

from torch_helpers import PROD_KW, launches, random_cloud_np, random_model_np

REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
KEYS = ("means3d", "scales", "quats", "opacities", "shs")
# the production knobs with n_contrib on: raster_config_from then picks the
# tile-major path
TILE_KW = dict(PROD_KW, want_ncontrib=True, segmented=False)
W, H = 64, 32


def _pose():
    c, s = np.cos(0.5), np.sin(0.5)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    vm[:3, 3] = [0.1, -0.05, 0.2]
    campos = (-vm[:3, :3].T @ vm[:3, 3]).astype(np.float32)
    return vm, campos


def _weights(shape):
    return np.linspace(0.5, 1.5, int(np.prod(shape)), dtype=np.float32).reshape(shape)


ROUTES = {
    # max_instances ≤ 2^21 with gather_reduce on: the gather reduction
    "gather": dict(),
    "scatter": dict(gather_reduce=False),
    # P ≤ FUSED_REDUCE_MAX_P and no emission payload: the fused backward
    "fused": dict(gather_reduce=False, fused_reduce=True),
    # the live-slab trim drops whole tiles, counted in truncated
    "gather_trim": dict(aligned_cap=128),
    "scatter_trim": dict(gather_reduce=False, aligned_cap=128),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_rasterize_matches_jax(route):
    c = random_cloud_np(71, 96, scale_mu=-1.3)
    arrays = [c[k] for k in KEYS]
    ndc = np.zeros((96, 2), np.float32)
    vm, campos = _pose()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(TILE_KW, **ROUTES[route])

    def jloss(*a):
        res = jrasterize(
            *a[:5], camera=Camera(CameraType.LONLAT, W, H),
            viewmatrix=jnp.asarray(vm), campos=jnp.asarray(campos),
            bg=jnp.asarray(bg), sh_degree=2,
            config=JRasterConfig(max_instances=1 << 12, interpret=True, **kw),
            means2d_ndc=a[5],
        )
        return jnp.sum(res.image * jnp.asarray(_weights(res.image.shape))), res

    (_, res_j), grads_j = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(ndc)
    )
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays + [ndc]]
    res_t = trasterize(
        *leaves[:5], camera=TCamera(TCameraType.LONLAT, W, H),
        viewmatrix=torch.from_numpy(vm), campos=torch.from_numpy(campos),
        bg=torch.from_numpy(bg), sh_degree=2,
        config=TRasterConfig(max_instances=1 << 12, **kw), means2d_ndc=leaves[5],
    )
    loss = torch.sum(res_t.image * torch.from_numpy(_weights(tuple(res_t.image.shape))))
    grads_t = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(res_t.image.detach().numpy(), np.asarray(res_j.image), atol=1e-5)
    np.testing.assert_allclose(res_t.final_T.numpy(), np.asarray(res_j.final_T), atol=1e-5)
    np.testing.assert_array_equal(res_t.n_contrib.numpy(), np.asarray(res_j.n_contrib))
    np.testing.assert_array_equal(res_t.radii.detach().numpy(), np.asarray(res_j.radii))
    assert int(res_t.truncated) == int(res_j.truncated)
    assert (int(res_t.truncated) > 0) == route.endswith("_trim")
    assert int(res_t.n_contrib.max()) > 0
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
def test_goldens(fname, width, height, sh_degree):
    """The oracle's image, final_T and gradients through the tile-major
    path with 3σ rects (tight culling is not output-identical at the
    right/bottom rect edge, ROADMAP queue 3)."""
    data = np.load(GOLDEN_DIR / fname)
    leaves = [torch.from_numpy(data[f"in_{k}"]).requires_grad_(True) for k in KEYS]
    res = trasterize(
        *leaves, camera=TCamera(TCameraType.LONLAT, width, height),
        viewmatrix=torch.eye(4), campos=torch.zeros(3),
        bg=torch.tensor([0.1, 0.2, 0.3]), sh_degree=sh_degree,
        config=TRasterConfig(max_instances=1 << 15, **dict(TILE_KW, tight_culling=False)),
    )
    np.testing.assert_allclose(res.image.detach().numpy(), data["image"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.final_T.numpy(), data["final_T"], rtol=1e-5, atol=1e-6)
    assert int(res.truncated) == 0 and int(res.n_contrib.max()) > 0
    loss = torch.sum(res.image * torch.from_numpy(data["loss_w"]))
    for g, k in zip(torch.autograd.grad(loss, leaves), KEYS):
        ref = data[f"g_{k}"]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3, atol=2e-4 * scale, err_msg=k)


def _yaml_config(**tpu):
    cfg = tconfig.load_config(REPO / "cfg" / "lonlat" / "360roam_lonlat.yaml")
    cfg.tpu = dataclasses.replace(cfg.tpu, **tpu)
    return cfg


def test_raster_config_selects_tile_major():
    """``Tpu.want_ncontrib: 1`` or ``Tpu.segmented: 0`` picks the tile-major
    path; the production YAML gives a 2^22 cap, above which the gather
    reduction demotes to the scatter; fused_reduce stays off."""
    for tpu, ncontrib in ((dict(want_ncontrib=True), True), (dict(segmented=False), False)):
        cfg = tconfig.raster_config_from(_yaml_config(**tpu))
        assert cfg == TRasterConfig(
            max_instances=1 << 22, tile_cap=1024, chunk=64, aligned_cap=None,
            **dict(TILE_KW, want_ncontrib=ncontrib),
        )


def test_tile_major_matches_segmented():
    """The two compositing layouts of the same instances: the same image
    and final_T; only the tile-major one fills n_contrib."""
    fields = random_model_np(72, 160, 128)
    vm, campos = _pose()
    m = TModel.from_numpy(fields, device="cpu")
    out = {}
    for name, kw in (("tile", TILE_KW), ("seg", PROD_KW)):
        with torch.inference_mode():
            out[name] = trasterize(
                m.xyz, m.get_scaling(), m.get_rotation(), m.get_opacity(),
                m.get_features(), camera=TCamera(TCameraType.LONLAT, 128, 64),
                viewmatrix=torch.from_numpy(vm), campos=torch.from_numpy(campos),
                bg=torch.zeros(3), sh_degree=3, active_mask=m.active,
                config=TRasterConfig(max_instances=1 << 12, **kw),
            )
    np.testing.assert_allclose(out["tile"].image.numpy(), out["seg"].image.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["tile"].final_T.numpy(), out["seg"].final_T.numpy(), atol=1e-5)
    assert int(out["tile"].n_contrib.max()) > 0 and int(out["seg"].n_contrib.max()) == 0


def test_train_step_matches_jax():
    """One training step through the tile-major config (``Tpu.want_ncontrib:
    1``) against the JAX `train_step` on the same state and view."""
    W2, H2 = 128, 64
    fields = random_model_np(73, 64, 48, scale_mu=-2.5)
    vm, campos = _pose()
    gt = np.random.default_rng(73).uniform(size=(3, H2, W2)).astype(np.float32)
    t_cfg = tconfig.raster_config_from(_yaml_config(want_ncontrib=True, max_instances=1 << 13))
    assert not t_cfg.segmented and t_cfg.want_ncontrib
    j_cfg = JRasterConfig(max_instances=1 << 13, interpret=True, **TILE_KW)
    lr_cfg = topt.LRConfig()
    kw = dict(sh_degree=2, lambda_dssim=0.2, skip_bottom_px=4, update_stats=True,
              do_adam=True, skip_opacity_update=False, spatial_lr_scale=2.0)
    tm = TModel.from_numpy(fields, device="cpu")
    tstate = topt.init_adam(tm.params())
    jm, jstate, jaux = jtrainer.train_step(
        JModel(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jopt.init_adam({k: jnp.asarray(fields[k]) for k in tm.params()}),
        jnp.asarray(vm), jnp.asarray(campos), jnp.asarray(gt), jnp.asarray(5),
        camera=Camera(CameraType.LONLAT, W2, H2), raster_cfg=j_cfg,
        lr_cfg=jopt.LRConfig(), bg=jnp.zeros(3), **kw,
    )
    before = (launches("composite_tile_fwd"), launches("composite_tile_bwd"))
    taux = ttrainer.train_step(
        tm, tstate, torch.from_numpy(vm)[None], torch.from_numpy(campos)[None],
        torch.from_numpy(gt)[None], 5, camera=TCamera(TCameraType.LONLAT, W2, H2),
        raster_cfg=t_cfg, lr_cfg=lr_cfg, bg=torch.zeros(3), **kw,
    )
    assert (launches("composite_tile_fwd"), launches("composite_tile_bwd")) == before
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert int(taux["truncated"]) == int(jaux["truncated"]) == 0
    ndc_ref = np.asarray(jm.xyz_gradient_accum)
    np.testing.assert_allclose(tm.xyz_gradient_accum.numpy(), ndc_ref, rtol=2e-3,
                               atol=1e-4 * np.abs(ndc_ref).max() + 1e-12)
    for name in tm.params():
        mu_ref = np.asarray(jstate.mu[name])
        np.testing.assert_allclose(
            tstate.mu[name].numpy(), mu_ref, rtol=2e-3,
            atol=1e-4 * np.abs(mu_ref).max() + 1e-12, err_msg=name,
        )
