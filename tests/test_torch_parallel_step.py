"""PyTorch port vs JAX reference: the sharded training step
(`omnigs_torch/parallel/shard.py::sharded_train_step`) on gloo ranks.

The port's contract is one device's gradient: the gradient of the mean
loss over the step's views, whatever the mesh. Each parameter group's
gradient, gathered from the shards (read from Adam's first moment, mu =
0.1·g on the first step), is held against `jax.grad` of JAX's
single-device mean loss at ROADMAP's gradient bar (rtol 2e-3, atol
1e-4·max|ref|), and the densification statistics against JAX's
single-device statistics summed over the views. The JAX sharded step does
not meet that contract: its gradients are n_gauss times one device's
(tests/test_torch_parallel_factor.py, on record in ROADMAP queue 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops import loss as jloss
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.train import trainer as jtrainer
from omnigs_tpu.train.renderer import render_model as jrender

from torch_helpers import PROD_KW, random_model_np
from torch_parallel_workers import run_ranks, step_worker

W, H = 64, 32
CAMERA = Camera(CameraType.LONLAT, W, H)
XLA_KW = dict(max_instances=1 << 12, tile_cap=64, chunk=16)
SH = 2
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _fields():
    return random_model_np(3, 64, 48, scale_mu=-2.5)


def _views():
    """Two poses, each with a noisy ground truth around 0.4 / 0.6 (a
    constant one makes SSIM's σ12 a cancellation beside c2)."""
    rng = np.random.default_rng(4)
    out = []
    for k, (dy, level) in enumerate(((0.0, 0.4), (0.05, 0.6))):
        vm = np.eye(4, dtype=np.float32)
        vm[1, 3] = dy
        gt = level + rng.uniform(-0.1, 0.1, (3, H, W))
        out.append((vm, (-vm[:3, 3]).astype(np.float32), gt.astype(np.float32)))
    return out


def _jmodel(fields):
    return JModel(**{k: jnp.asarray(v) for k, v in fields.items()})


def _grad_close(got, ref, name):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4 * scale, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """jax.grad of the single-device mean loss, and the statistics of one
    single-device step per view."""
    fields, views = _fields(), _views()
    model = _jmodel(fields)

    def mean_loss(params):
        m = model.with_params(params)
        total = 0.0
        for vm, cp, gt in views:
            img = jrender(m, CAMERA, jnp.asarray(vm), jnp.asarray(cp), jnp.zeros(3), SH,
                          JRasterConfig(**XLA_KW)).image
            gt = jnp.asarray(gt)
            total += 0.8 * jloss.l1_loss(img, gt) + 0.2 * (1.0 - jloss.ssim(img, gt))
        return total / len(views)

    loss, grads = jax.jit(jax.value_and_grad(mean_loss))(model.params())
    m = model
    for vm, cp, gt in views:
        m, _, _ = jtrainer.train_step(
            m, jopt.init_adam(m.params()), jnp.asarray(vm), jnp.asarray(cp),
            jnp.asarray(gt), jnp.asarray(1), camera=CAMERA, sh_degree=SH,
            raster_cfg=JRasterConfig(**XLA_KW), lr_cfg=jopt.LRConfig(),
            spatial_lr_scale=1.0, bg=jnp.zeros(3), update_stats=True, do_adam=False,
        )
    stats = {k: np.asarray(getattr(m, k)) for k in ("xyz_gradient_accum", "denom", "max_radii2d")}
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}, stats


@pytest.mark.parametrize(
    "data,gauss,route", [(1, 2, "xla"), (2, 2, "xla"), (2, 2, "segmented")]
)
def test_sharded_grads_match_single_device(tmp_path, data, gauss, route):
    fields, views = _fields(), _views()
    loss, grads, stats = _jax_reference()
    # the kernel route without tight culling, whose opacity-aware radii
    # the XLA reference would not share
    cfg_kw = XLA_KW if route == "xla" else dict(
        max_instances=1 << 12, **{**PROD_KW, "tight_culling": False}
    )
    ranks = run_ranks(
        tmp_path, data * gauss, step_worker, data, gauss, fields, (W, H), views,
        cfg_kw, dict(sh_degree=SH, spatial_lr_scale=1.0),
    )
    # data row d is ranks d·G … d·G + G − 1; each loaded its own views
    for r, rank_out in enumerate(ranks):
        assert rank_out.pop("local_rows").tolist() == [r // gauss]
    got = ranks[0]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    for k in PARAMS:
        _grad_close(got[f"mu/{k}"] / 0.1, grads[k], k)
    for k, ref in stats.items():
        _grad_close(got[k], ref, k)
    # every rank holds the same gathered state and logs the same loss
    for other in ranks[1:]:
        for k, v in got.items():
            assert np.array_equal(other[k], v), k
