"""PyTorch port vs JAX reference: the last examples and tools
(omnigs_torch/examples/{simple_cloud,train_360roam,train_egonerf}.py,
io/native_loader.ImagePool, utils/profiling.trace,
scripts/protocol_run.sh).

Bars: `simple_cloud`'s image within atol 1e-5 of the JAX package's render
of the same cloud (the JAX script's XLA-backend config, as it runs on a
CPU); every `ImagePool` image bitwise equal to `load_image`; a Chrome
trace written; the wrappers' argv as the JAX wrappers build it, with the
port's CLI; the protocol script parses."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omnigs_torch.examples import simple_cloud, train_360roam, train_egonerf
from omnigs_torch.io import native_loader as tnl
from omnigs_torch.utils.profiling import trace

from torch_helpers import REPO


def _jax_simple_cloud(width, height, d=2.0):
    """The JAX script's cloud and render (examples/simple_cloud.py)."""
    from omnigs_tpu.cameras import Camera, CameraType
    from omnigs_tpu.model.gaussians import from_pcd
    from omnigs_tpu.ops.knn import mean_sq_knn_dist
    from omnigs_tpu.ops.rasterize import RasterConfig
    from omnigs_tpu.train.renderer import render_model

    pts = jnp.array([[d, -5 * d, d], [-d, 0.5 * d, -0.7 * d], [d, d, -d]], jnp.float32)
    cols = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], jnp.float32)
    model = from_pcd(pts, cols, 3, mean_sq_knn_dist(pts))
    model = model.replace(scaling=jnp.full_like(model.scaling, -0.3),
                          opacity=jnp.full_like(model.opacity, 5.0))
    res = render_model(model, Camera(CameraType.LONLAT, width, height), jnp.eye(4),
                       jnp.zeros(3), jnp.zeros(3), sh_degree=0,
                       config=RasterConfig(max_instances=1 << 16, tile_cap=64, chunk=16))
    return np.asarray(res.image)


@pytest.mark.parametrize("dist", [2.0, 1.5])
def test_simple_cloud_matches_jax(tmp_path, dist):
    out = simple_cloud.main([str(tmp_path), str(dist), "--width", "64", "--height", "32",
                             "--device", "cpu"])
    ref = _jax_simple_cloud(64, 32, dist)
    assert out["image"].shape == ref.shape == (3, 32, 64)
    assert out["truncated"] == 0
    np.testing.assert_allclose(out["image"], ref, atol=1e-5)
    assert float(ref.max()) > 0.1  # the three splats are in view
    png = np.asarray(Image.open(out["path"]))
    assert png.shape == (32, 64, 3)


def test_image_pool_equals_load_image(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(7):
        p = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (20 + i, 30, 3), np.uint8)).save(p)
        paths.append(p)
    pool = tnl.ImagePool(24, 16, n_threads=3)
    got = dict(pool.load_all(paths))
    assert sorted(got) == list(range(7))
    for i, p in enumerate(paths):
        assert got[i].dtype == np.float32 and got[i].shape == (16, 24, 3)
        np.testing.assert_array_equal(got[i], tnl.load_image(p, 24, 16))
    pool.close()
    pool.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        next(pool.load_all(paths))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "tr") as log_dir:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    assert Path(log_dir) == tmp_path / "tr"
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("module", [train_360roam, train_egonerf])
def test_wrappers_run_the_port_cli(module, tmp_path):
    argv = module.command("cfg.yaml", tmp_path / "scene", "out", ["--iters", "5"])
    assert argv == [sys.executable, "-m", "omnigs_torch.examples.train_openmvg_lonlat",
                    "cfg.yaml", "out",
                    str(tmp_path / "scene" / "openMVG" / "data_openmvg.json"),
                    str(tmp_path / "scene" / "openMVG" / "scene.ply"), "--iters", "5"]
    with pytest.raises(SystemExit) as e:
        module.main(["only", "two"])
    assert e.value.code == 1


def test_protocol_script_parses():
    script = REPO / "omnigs_torch" / "scripts" / "protocol_run.sh"
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    assert "32,010" in text and "omnigs_torch.examples.train_openmvg_lonlat" in text
    assert "JAX_COMPILATION_CACHE_DIR" not in text


def test_every_port_module_imports_without_jax():
    """Importing every module of `omnigs_torch` (the viewer, the examples
    and the scripts included) loads no JAX and nothing of `omnigs_tpu`."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import omnigs_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(omnigs_torch.__path__, 'omnigs_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'omnigs_torch.viewer.live' in names and 'omnigs_torch.examples.view_result' in names\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'omnigs_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    import os

    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) > 30
