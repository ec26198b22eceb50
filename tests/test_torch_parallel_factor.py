"""The reference's factor, on record (ROADMAP queue 3): JAX's sharded
training step (`omnigs_tpu/parallel/shard.py::make_sharded_train_step`)
differentiates the psum'd loss on every gauss shard, so its gradients are
n_gauss times one device's; the port's sharded step
(`omnigs_torch/parallel/shard.py`) computes one device's. JAX runs here on
the conftest's eight virtual CPU devices, the port on eight gloo ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.parallel.mesh import DATA_AXIS, GAUSS_AXIS, make_mesh
from omnigs_tpu.parallel.shard import make_sharded_train_step
from omnigs_tpu.train import trainer as jtrainer

from test_torch_parallel_step import (
    CAMERA, PARAMS, SH, XLA_KW, W, H, _fields, _grad_close, _jmodel, _views,
)
from torch_parallel_workers import run_ranks, step_worker


def _jax_sharded_step(fields, view, data, gauss):
    """JAX's `make_sharded_train_step` on ``view`` stacked ``data`` times →
    the Adam state and model after the step."""
    mesh = make_mesh(data=data, gauss=gauss)
    model = _jmodel(fields)
    opt_state = jopt.init_adam(model.params())
    gspec = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P(GAUSS_AXIS)), model)
    ospec = jax.tree_util.tree_map(
        lambda _: NamedSharding(mesh, P(GAUSS_AXIS)), opt_state
    ).replace(count=NamedSharding(mesh, P()))
    dspec = NamedSharding(mesh, P(DATA_AXIS))
    vm, cp, gt = view
    step = make_sharded_train_step(
        mesh, CAMERA, SH, JRasterConfig(**XLA_KW), jopt.LRConfig(), 1.0, bg=jnp.zeros(3)
    )
    m, o, _ = step(
        jax.device_put(model, gspec), jax.device_put(opt_state, ospec),
        jax.device_put(jnp.tile(jnp.asarray(vm)[None], (data, 1, 1)), dspec),
        jax.device_put(jnp.tile(jnp.asarray(cp)[None], (data, 1)), dspec),
        jax.device_put(jnp.tile(jnp.asarray(gt)[None], (data, 1, 1, 1)), dspec),
        jnp.asarray(1),
    )
    return m, o


def test_jax_sharded_grad_is_n_gauss_times(tmp_path):
    """The reference's factor, shown at mesh (2, 4) on one view stacked
    twice: JAX's sharded Adam first moments are 4 = n_gauss times JAX's
    single-device ones (so its gradient is), and its screen-space statistic
    8 = n_data · n_gauss times one view's; the port's moments equal the
    single-device ones and its statistic is 2 = n_data times one view's
    (the two views summed), each at the gradient bar."""
    fields, view = _fields(), _views()[0]
    vm, cp, gt = view
    single_m, single_o, _ = jtrainer.train_step(
        _jmodel(fields), jopt.init_adam(_jmodel(fields).params()), jnp.asarray(vm),
        jnp.asarray(cp), jnp.asarray(gt), jnp.asarray(1), camera=CAMERA, sh_degree=SH,
        raster_cfg=JRasterConfig(**XLA_KW), lr_cfg=jopt.LRConfig(),
        spatial_lr_scale=1.0, bg=jnp.zeros(3),
    )
    sharded_m, sharded_o = _jax_sharded_step(fields, view, 2, 4)
    port = run_ranks(
        tmp_path, 8, step_worker, 2, 4, fields, (W, H), [view, view], XLA_KW,
        dict(sh_degree=SH, spatial_lr_scale=1.0),
    )[0]

    def ratio(a, b):
        a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
        live = np.abs(b) > 1e-2 * np.abs(b).max()
        assert live.sum() > 10
        return a[live] / b[live]

    for k in PARAMS:
        ref = np.asarray(single_o.mu[k])
        np.testing.assert_allclose(ratio(sharded_o.mu[k], ref), 4.0, rtol=1e-4, err_msg=k)
        _grad_close(port[f"mu/{k}"], ref, k)
    accum = np.asarray(single_m.xyz_gradient_accum)
    np.testing.assert_allclose(ratio(sharded_m.xyz_gradient_accum, accum), 8.0, rtol=1e-4)
    _grad_close(port["xyz_gradient_accum"], 2.0 * accum, "xyz_gradient_accum")
