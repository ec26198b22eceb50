"""PyTorch port vs JAX reference, end to end: `render_model` with the
production RasterConfig, the committed goldens, the brute-force oracle,
model carry-over, PLY files across packages, config loading, and the
port's independence from JAX.

Bars: image and final_T atol 1e-5 against the JAX segmented path (the
bar tests/test_pallas_seg.py holds that path to); the goldens with the
bars of tests/test_goldens.py; radii, truncation and integer fields
equal."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnigs_torch.config as tconfig
import omnigs_tpu.config as jconfig
from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.io import ply as tply
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops import oracle as toracle
from omnigs_torch.ops import preprocess as tpre
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.ops.rasterize import rasterize as trasterize
from omnigs_torch.train.renderer import render_model as trender
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.io import ply as jply
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops import oracle as joracle
from omnigs_tpu.ops import preprocess as jpre
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.ops.rasterize import rasterize as jrasterize
from omnigs_tpu.train.renderer import render_model as jrender

from torch_helpers import PROD_KW, random_cloud_np, random_model_np

REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
LONLAT_CFGS = sorted((REPO / "cfg" / "lonlat").glob("*.yaml"))


def _pose():
    c, s = np.cos(0.7), np.sin(0.7)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    vm[:3, 3] = [0.2, 0.1, -0.3]
    campos = (-vm[:3, :3].T @ vm[:3, 3]).astype(np.float32)
    return vm, campos


def _jmodel(fields):
    return JModel(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("sh_degree", [2, 3])
def test_render_model_matches_jax(sh_degree):
    fields = random_model_np(51, 160, 128)
    vm, campos = _pose()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    res_j = jrender(
        _jmodel(fields), Camera(CameraType.LONLAT, 128, 64), jnp.asarray(vm),
        jnp.asarray(campos), jnp.asarray(bg), sh_degree,
        JRasterConfig(max_instances=1 << 12, interpret=True, **PROD_KW),
    )
    with torch.inference_mode():
        res_t = trender(
            TModel.from_numpy(fields, device="cpu"),
            TCamera(TCameraType.LONLAT, 128, 64), torch.from_numpy(vm),
            torch.from_numpy(campos), torch.from_numpy(bg), sh_degree,
            TRasterConfig(max_instances=1 << 12, **PROD_KW),
        )
    np.testing.assert_allclose(res_t.image.numpy(), np.asarray(res_j.image), atol=1e-5)
    np.testing.assert_allclose(res_t.final_T.numpy(), np.asarray(res_j.final_T), atol=1e-5)
    np.testing.assert_array_equal(res_t.radii.numpy(), np.asarray(res_j.radii))
    assert int(res_t.truncated) == int(res_j.truncated) == 0
    assert float(res_t.final_T.min()) < 0.9  # the view is not empty


@pytest.mark.parametrize(
    "fname,width,height,sh_degree",
    [("simple_cloud.npz", 512, 256, 0), ("random_cloud.npz", 256, 128, 3)],
    ids=["simple_cloud", "random_cloud"],
)
def test_goldens(fname, width, height, sh_degree):
    """The production path without tight culling: the goldens pin the
    oracle's 3σ rects, and the tight radius is not output-identical at the
    right/bottom rect edge (a reference quirk the port keeps; ROADMAP
    queue 3)."""
    data = np.load(GOLDEN_DIR / fname)
    args = [torch.from_numpy(data[f"in_{k}"]) for k in
            ("means3d", "scales", "quats", "opacities", "shs")]
    with torch.inference_mode():
        res = trasterize(
            *args, camera=TCamera(TCameraType.LONLAT, width, height),
            viewmatrix=torch.eye(4), campos=torch.zeros(3),
            bg=torch.tensor([0.1, 0.2, 0.3]), sh_degree=sh_degree,
            config=TRasterConfig(
                max_instances=1 << 15, **dict(PROD_KW, tight_culling=False)
            ),
        )
    np.testing.assert_allclose(res.image.numpy(), data["image"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.final_T.numpy(), data["final_T"], rtol=1e-5, atol=1e-6)


FLAG_CASES = {
    "render_depth": dict(render_depth=True),
    "convert_SHs": dict(convert_SHs=True),
    "compute_cov3D": dict(compute_cov3D=True, scale_modifier=1.3),
    "means2d_ndc": dict(means2d_ndc=np.full((160, 2), 0.01, np.float32)),
}


@pytest.mark.parametrize("flag", list(FLAG_CASES))
def test_render_flags_match_jax(flag):
    fields = random_model_np(56, 160, 128)
    vm, campos = _pose()
    kw = FLAG_CASES[flag]
    ndc = kw.get("means2d_ndc")
    res_j = jrender(
        _jmodel(fields), Camera(CameraType.LONLAT, 128, 64), jnp.asarray(vm),
        jnp.asarray(campos), jnp.zeros(3), 3,
        JRasterConfig(max_instances=1 << 12, interpret=True, **PROD_KW),
        **dict(kw, means2d_ndc=None if ndc is None else jnp.asarray(ndc)),
    )
    with torch.inference_mode():
        res_t = trender(
            TModel.from_numpy(fields, device="cpu"),
            TCamera(TCameraType.LONLAT, 128, 64), torch.from_numpy(vm),
            torch.from_numpy(campos), torch.zeros(3), 3,
            TRasterConfig(max_instances=1 << 12, **PROD_KW),
            **dict(kw, means2d_ndc=None if ndc is None else torch.from_numpy(ndc)),
        )
    np.testing.assert_allclose(res_t.image.numpy(), np.asarray(res_j.image), atol=1e-5)
    np.testing.assert_allclose(res_t.final_T.numpy(), np.asarray(res_j.final_T), atol=1e-5)


def test_tight_culling_rect_edge_quirk():
    """Tight culling is not output-identical at the right/bottom rect edge
    (a reference-side quirk, ROADMAP queue 3): both packages leave the
    golden by the same > 1e-3 and agree with each other."""
    data = np.load(GOLDEN_DIR / "random_cloud.npz")
    keys = ("means3d", "scales", "quats", "opacities", "shs")
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    res_j = jrasterize(
        *[jnp.asarray(data[f"in_{k}"]) for k in keys],
        camera=Camera(CameraType.LONLAT, 256, 128), viewmatrix=jnp.eye(4),
        campos=jnp.zeros(3), bg=jnp.asarray(bg), sh_degree=3,
        config=JRasterConfig(max_instances=1 << 15, interpret=True, **PROD_KW),
    )
    with torch.inference_mode():
        res_t = trasterize(
            *[torch.from_numpy(data[f"in_{k}"]) for k in keys],
            camera=TCamera(TCameraType.LONLAT, 256, 128),
            viewmatrix=torch.eye(4), campos=torch.zeros(3),
            bg=torch.from_numpy(bg), sh_degree=3,
            config=TRasterConfig(max_instances=1 << 15, **PROD_KW),
        )
    np.testing.assert_allclose(res_t.image.numpy(), np.asarray(res_j.image), atol=1e-5)
    assert np.abs(res_t.image.numpy() - data["image"]).max() > 1e-3
    assert np.abs(np.asarray(res_j.image) - data["image"]).max() > 1e-3


@pytest.mark.parametrize("mode", ["tile_accurate", "all_visible", "features"])
def test_oracle_matches_jax(mode):
    c = random_cloud_np(52, 64)
    vm, campos = _pose()
    keys = ("means3d", "scales", "quats", "opacities", "shs")
    pj = jpre.preprocess(
        *[jnp.asarray(c[k]) for k in keys], Camera(CameraType.LONLAT, 64, 32),
        jnp.asarray(vm), jnp.asarray(campos), 3,
    )
    arrays = [np.array(x) for x in pj]
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    feats = np.linspace(0.5, 2.0, 64, dtype=np.float32)
    kw_j = dict(tile_accurate=mode != "all_visible")
    kw_t = dict(kw_j)
    if mode == "features":
        kw_j["features"], kw_t["features"] = jnp.asarray(feats), torch.from_numpy(feats)
    out_j = joracle.render_oracle(
        jpre.Preprocessed(*[jnp.asarray(a) for a in arrays]),
        Camera(CameraType.LONLAT, 64, 32), jnp.asarray(bg), **kw_j,
    )
    out_t = toracle.render_oracle(
        tpre.Preprocessed(*[torch.from_numpy(a) for a in arrays]),
        TCamera(TCameraType.LONLAT, 64, 32), torch.from_numpy(bg), **kw_t,
    )
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-5)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-5)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


def test_model_carry_over():
    fields = random_model_np(53, 40, 30)
    jm = _jmodel(fields)
    tm = TModel.from_numpy({k: np.asarray(getattr(jm, k)) for k in fields}, device="cpu")
    back = tm.to_numpy()
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == np.asarray(getattr(jm, k)).dtype, k
    assert set(tm.params()) == set(jm.params())
    assert all(p.requires_grad for p in tm.params().values())
    assert tm.capacity == jm.capacity
    for name in ("get_scaling", "get_rotation", "get_opacity", "get_features"):
        np.testing.assert_allclose(
            getattr(tm, name)().detach().numpy(), np.asarray(getattr(jm, name)()),
            rtol=1e-6, atol=1e-7, err_msg=name,
        )
    empty_t = TModel.empty(8, device="cpu").to_numpy()
    empty_j = JModel.empty(8)
    for k in fields:
        np.testing.assert_array_equal(empty_t[k], np.asarray(getattr(empty_j, k)), err_msg=k)


def test_ply_across_packages(tmp_path):
    fields = random_model_np(54, 48, 40)
    jm = _jmodel(fields)
    tm = TModel.from_numpy(fields, device="cpu")
    jply.save_gaussian_ply(tmp_path / "j.ply", jm)
    tply.save_gaussian_ply(tmp_path / "t.ply", tm)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    from_j = tply.load_gaussian_ply(tmp_path / "j.ply", capacity=48, device="cpu").to_numpy()
    from_t = jply.load_gaussian_ply(tmp_path / "t.ply", capacity=48)
    for k, v in fields.items():
        np.testing.assert_array_equal(from_j[k], v, err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(from_t, k)), v, err_msg=k)


@pytest.mark.parametrize("path", LONLAT_CFGS, ids=[p.stem for p in LONLAT_CFGS])
def test_load_config_matches_jax(path):
    assert dataclasses.asdict(tconfig.load_config(path)) == dataclasses.asdict(
        jconfig.load_config(path)
    )


def test_raster_config_from_production():
    cfg = tconfig.raster_config_from(
        tconfig.load_config(REPO / "cfg" / "lonlat" / "360roam_lonlat.yaml")
    )
    assert cfg == TRasterConfig(
        max_instances=1 << 22, tile_cap=1024, chunk=64, aligned_cap=None, **PROD_KW
    )


def test_unported_configs_raise():
    """Every `RasterConfig` the JAX package accepts renders (the XLA
    backend, the 2-key binning without a depth presort, segmented or not);
    the combinations it rejects raise ValueError, and so does the pinhole
    camera (not a `RasterConfig` field) without ``full_proj``, as in JAX."""
    c = {k: torch.from_numpy(v) for k, v in random_cloud_np(55, 8).items()}
    kw = dict(camera=TCamera(TCameraType.LONLAT, 64, 32), viewmatrix=torch.eye(4),
              campos=torch.zeros(3), bg=torch.zeros(3), sh_degree=0)
    args = [c[k] for k in ("means3d", "scales", "quats", "opacities", "shs")]
    for cfg in (
        TRasterConfig(),
        TRasterConfig(backend="pallas", want_ncontrib=False),
        TRasterConfig(backend="pallas", want_ncontrib=False, segmented=True),
    ):
        res = trasterize(*args, config=cfg, **kw)
        assert res.image.shape == (3, 32, 64) and bool(torch.isfinite(res.image).all())
    for bad in (
        dict(segmented=True),  # needs the kernel backend
        dict(backend="pallas", segmented=True),  # no n_contrib when segmented
        dict(backend="pallas", segmented=True, want_ncontrib=False, ghost_align=True),
        dict(tile_cap=100, chunk=32),
        dict(backend="cuda"),
    ):
        with pytest.raises(ValueError):
            TRasterConfig(**bad)
    with pytest.raises(ValueError, match="pinhole camera requires full_proj"):
        trasterize(*args, config=TRasterConfig(), **dict(
            kw, camera=TCamera(TCameraType.PINHOLE, 64, 32, fx=50.0, fy=50.0)))


def test_port_imports_no_jax():
    script = (
        "import sys, torch\n"
        "from omnigs_torch.cameras import Camera, CameraType\n"
        "from omnigs_torch.config import load_config, raster_config_from\n"
        "from omnigs_torch.io.ply import load_gaussian_ply, save_gaussian_ply\n"
        "from omnigs_torch.model.gaussians import GaussianModel\n"
        "from omnigs_torch.train.renderer import render_model\n"
        "m = GaussianModel.empty(16, device='cpu')\n"
        "with torch.no_grad():\n"
        "    m.scaling[:8] = -1.0; m.opacity[:8] = 2.0\n"
        "    m.xyz[:8] = torch.randn(8, 3, generator=torch.Generator().manual_seed(0)) * 3\n"
        "m.active[:8] = True\n"
        "cfg = raster_config_from(load_config('cfg/lonlat/360roam_lonlat.yaml'))\n"
        "with torch.inference_mode():\n"
        "    r = render_model(m, Camera(CameraType.LONLAT, 64, 32), torch.eye(4),\n"
        "                     torch.zeros(3), torch.zeros(3), 3, cfg)\n"
        "assert r.image.shape == (3, 32, 64) and bool(torch.isfinite(r.image).all())\n"
        "import dataclasses\n"
        "from omnigs_torch.ops import composite_tile\n"
        "tile = dataclasses.replace(cfg, want_ncontrib=True, segmented=False)\n"
        "with torch.inference_mode():\n"
        "    rt = render_model(m, Camera(CameraType.LONLAT, 64, 32), torch.eye(4),\n"
        "                      torch.zeros(3), torch.zeros(3), 3, tile)\n"
        "assert float((rt.image - r.image).abs().max()) <= 1e-5\n"
        "assert int(rt.n_contrib.max()) > 0\n"
        "from omnigs_torch.model.optimizer import LRConfig, init_adam\n"
        "from omnigs_torch.train.trainer import train_step\n"
        "st = init_adam(m.params())\n"
        "aux = train_step(m, st, torch.eye(4)[None], torch.zeros(1, 3), r.image[None] * 0.5, 1,\n"
        "                 camera=Camera(CameraType.LONLAT, 64, 32), sh_degree=3,\n"
        "                 raster_cfg=cfg, lr_cfg=LRConfig(), spatial_lr_scale=1.0,\n"
        "                 bg=torch.zeros(3))\n"
        "assert bool(torch.isfinite(aux['loss'])) and int(st.count) == 1\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'omnigs_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
