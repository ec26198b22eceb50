"""PyTorch port vs JAX reference: `ops/loss.ssim_rows` and the sharded
render (`omnigs_torch/parallel/shard.py::sharded_render`) on gloo ranks.

The ranks are spawned processes that import the port only
(tests/torch_parallel_workers.py); the JAX values are computed here, JAX
on the CPU. Bars: ssim_rows the SSIM map's bar of tests/test_torch_loss.py
(rtol 1e-5, atol 1e-6); images atol 1e-5 against JAX's single-device `render_model`
(ROADMAP's image bar), and every rank's image bitwise rank 0's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import loss as tloss
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops import loss as jloss
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.train.renderer import render_model as jrender

from torch_helpers import PROD_KW, random_model_np
from torch_parallel_workers import render_worker, run_ranks

W, H = 64, 32
# the XLA route and the kernel route (segmented, and tile-major), each
# through its plain versions on the CPU
ROUTES = {
    "xla": dict(max_instances=1 << 12, tile_cap=64, chunk=16),
    "segmented": dict(max_instances=1 << 12, **PROD_KW),
    "tile_major": dict(max_instances=1 << 12, backend="pallas", tile_culling=True,
                       want_ncontrib=True, depth_presort=True),
}


@pytest.mark.parametrize("row0,nrows", [(0, 9), (5, 11), (20, 12), (24, 12), (0, 32)])
def test_ssim_rows_matches_jax(row0, nrows):
    """Row blocks that cut the halo at the top, in the middle, at the
    bottom and past the tail (24 + 12 > 32), and the whole image."""
    rng = np.random.default_rng(row0 + nrows)
    a = rng.uniform(size=(3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    ref = np.asarray(jloss.ssim_rows(jnp.asarray(a), jnp.asarray(b), row0, nrows, H))
    got = tloss.ssim_rows(torch.from_numpy(a), torch.from_numpy(b), row0, nrows, H).numpy()
    valid = min(nrows, H - row0)
    np.testing.assert_allclose(got[:, :valid], ref[:, :valid], rtol=1e-5, atol=1e-6)
    # and the rows of the full map
    full = tloss.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=False).numpy()
    np.testing.assert_allclose(got[:, :valid], full[:, row0 : row0 + valid], rtol=1e-5, atol=1e-6)


def _fields():
    return random_model_np(0, 64, 48)


def _pose():
    vm = np.eye(4, dtype=np.float32)
    vm[0, 3] = 0.05
    return vm, (-vm[:3, 3]).astype(np.float32), np.array([0.2, 0.3, 0.4], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_image():
    vm, campos, bg = _pose()
    return np.asarray(
        jrender(
            JModel(**{k: jnp.asarray(v) for k, v in _fields().items()}),
            Camera(CameraType.LONLAT, W, H), jnp.asarray(vm), jnp.asarray(campos),
            jnp.asarray(bg), 2, JRasterConfig(**ROUTES["xla"]),
        ).image
    )


@pytest.mark.parametrize("data,gauss", [(1, 2), (2, 1), (2, 2)])
def test_sharded_render_matches_jax_single_device(tmp_path, data, gauss):
    fields = _fields()
    vm, campos, bg = _pose()
    ref = _jax_image()
    ranks = run_ranks(
        tmp_path, data * gauss, render_worker, data, gauss, fields, (W, H), vm,
        campos, bg, 2, list(ROUTES.values()),
    )
    for name, img in zip(ROUTES, ranks[0]):
        assert img.shape == (3, H, W)
        np.testing.assert_allclose(img, ref, atol=1e-5, err_msg=name)
    for r, images in enumerate(ranks[1:], 1):
        for name, img, img0 in zip(ROUTES, images, ranks[0]):
            assert np.array_equal(img, img0), (r, name)
