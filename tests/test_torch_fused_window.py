"""PyTorch port vs JAX reference: the one-program training window
(omnigs_torch/train/trainer.py `train_steps_fused`, `Trainer._ensure_banks`,
`Trainer.train_window`, `Trainer.drain_losses`, `capture_key`) on
tests/test_torch_trainer.py's tiny scene, the JAX side on the segmented
path in Pallas interpret mode. On the CPU the window runs its steps
eagerly (the plain version of the card's CUDA graph, which
tests/test_torch_kernels_gpu.py holds bitwise to eager iterations).

Bars: JAX `train_steps_fused` against the port's on the same staged rows,
K = 5: losses within rel 1e-4 (the trajectory test's bar), Adam moments
within rtol 2e-3, atol 1e-4·max|ref| (the gradient bars); the port's
banked windows bitwise equal to as many `train_iteration`s, with the
ground-truth bank on the device and on the host; `drain_losses` over
windows and single steps equal to JAX's EMA and counters on the same
values; the capture key changing exactly when what a captured step bakes
in changes."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.model import optimizer as topt
from omnigs_torch.model.gaussians import FIELD_NAMES, PARAM_NAMES
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.train import trainer as ttrainer
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.train import trainer as jtrainer

from test_torch_trainer import H, N_GT, W, _trainers
from test_torch_trainer_window import _assert_equal_states, _port_trainer, _state
from torch_helpers import random_model_np

K = 5


def test_train_steps_fused_matches_jax():
    """Five steps from one state over the scene's rows [1, 0, 2, 2, 1]:
    JAX's scan over the stacked rows against the port's window over the
    banks and the rows (and over the stacked rows, bitwise the same)."""
    jt, tt = _trainers(0)
    fields = random_model_np(3, 64, N_GT, scale_mu=-2.5)
    rows = np.array([1, 0, 2, 2, 1])
    kfs = [jt.scene.keyframes[i] for i in range(3)]
    vms = np.stack([kf.viewmatrix for kf in kfs])
    cps = np.stack([kf.campos for kf in kfs])
    gts = np.stack([kf.image.transpose(2, 0, 1) for kf in kfs])
    kw = dict(sh_degree=1, lambda_dssim=0.2, skip_bottom_px=4, update_stats=True,
              spatial_lr_scale=2.0)
    jm, jstate, (jl, jov, jtr) = jtrainer.train_steps_fused(
        JModel(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jopt.init_adam({k: jnp.asarray(fields[k]) for k in PARAM_NAMES}),
        jnp.asarray(vms[rows]), jnp.asarray(cps[rows]), jnp.asarray(gts[rows]), jnp.asarray(5),
        camera=Camera(CameraType.LONLAT, W, H), raster_cfg=jt.raster_cfg, lr_cfg=jt.lr_cfg,
        bg=jnp.zeros(3), **kw,
    )
    out = []
    for banked in (True, False):
        tm = TModel.from_numpy(fields, device="cpu")
        tstate = topt.init_adam(tm.params())
        banks = (vms, cps, gts) if banked else (vms[rows], cps[rows], gts[rows])
        tl, tov, ttr = ttrainer.train_steps_fused(
            tm, tstate, *(torch.from_numpy(np.ascontiguousarray(b)) for b in banks), 5,
            rows=rows if banked else None, camera=TCamera(TCameraType.LONLAT, W, H),
            raster_cfg=tt.raster_cfg, lr_cfg=tt.lr_cfg, bg=torch.zeros(3), **kw,
        )
        out.append((tm, tstate, tl))
    (tm, tstate, tl), (tm2, tstate2, tl2) = out
    assert torch.equal(tl, tl2)
    for name in tm.params():
        assert torch.equal(tstate.mu[name], tstate2.mu[name]), name
    assert tl.shape == (K,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    assert int(tov) == int(jov) and int(ttr) == int(jtr) == 0
    assert int(tstate.count) == int(jstate.count) == K
    for m in ("mu", "nu"):
        for name in tm.params():
            ref = np.asarray(getattr(jstate, m)[name])
            np.testing.assert_allclose(
                getattr(tstate, m)[name].numpy(), ref, rtol=2e-3,
                atol=1e-4 * float(np.abs(ref).max()) + 1e-12, err_msg=f"{m}/{name}")
    np.testing.assert_array_equal(tm.denom.numpy(), np.asarray(jm.denom))


@pytest.mark.parametrize("bank", ["device", "host"])
def test_banked_windows_equal_iterations_bitwise(bank):
    """Windows of up to 5 through densify (every 5th iteration from 3) and
    opacity resets (every 8th) until 14, the ground truths from a bank on
    the device or (``Tpu.gt_bank_mb: 0``) on the host, against 16
    `train_iteration`s; the per-keyframe ground-truth cache stays empty."""
    opt = dict(densify_from_iter=3, densification_interval=5, densify_until_iter=14,
               opacity_reset_interval=8, max_num_iterations=20, position_lr_max_steps=20)
    a, b = _port_trainer(3, **opt), _port_trainer(3, **opt)
    if bank == "host":
        a.config.tpu.gt_bank_mb = b.config.tpu.gt_bank_mb = 0
    windows = 0
    while a.iteration < 16:
        took = a.train_window(min(K, 16 - a.iteration))
        windows += took > 0
        if not took:
            a.train_iteration()
    for _ in range(16):
        b.train_iteration()
    assert windows >= 3 and a.iteration == b.iteration == 16
    assert a.gt_bank_on_device is b.gt_bank_on_device is (bank == "device")
    assert a._gt_cache == b._gt_cache == {}
    assert a.sampler.used_times == b.sampler.used_times
    _assert_equal_states(_state(a), _state(b))
    assert torch.equal(torch.cat([x.reshape(-1) for x, _, _ in a._pending_losses]),
                       torch.stack([x for x, _, _ in b._pending_losses]))
    # a new keyframe set builds the banks again
    old = a._banks
    a.scene.keyframes[7] = a.scene.keyframes[0]
    assert a._ensure_banks() is not old and len(a._banks[0]) == 4
    assert a._ensure_banks() is a._banks


def test_drain_losses_matches_jax():
    """The same queue in both packages (windows of 3 and 2 losses, single
    steps between, capacity counters): the same last loss, EMA and totals."""
    rng = np.random.default_rng(0)
    queue = [(rng.uniform(size=3), 0, 2), (rng.uniform(), 1, 0), (rng.uniform(size=2), 0, 0),
             (rng.uniform(), 4, 1)]
    got = []
    for to in (jnp.asarray, torch.as_tensor):
        tr = types.SimpleNamespace(
            ema_loss=0.25, last_loss=0.0, total_overflow=0, total_truncated=0,
            _pending_losses=[(to(np.asarray(x, np.float32)), to(np.int32(ov)),
                              to(np.int32(t))) for x, ov, t in queue])
        drain = (jtrainer if to is jnp.asarray else ttrainer).Trainer.drain_losses
        with pytest.warns(UserWarning, match="capacity pressure"):
            last = drain(tr)
        got.append((last, tr.ema_loss, tr.total_overflow, tr.total_truncated,
                    tr._pending_losses))
    assert got[0] == got[1]
    assert got[1][2:] == (5, 3, [])


def _key(tr):
    """The `capture_key` of a window of one step from the trainer's state."""
    banks, mask, kw = tr._window_inputs(1)
    return ttrainer.capture_key(tr.model, tr.opt_state, *banks, mask, **kw)


def test_capture_key_follows_what_a_step_bakes_in(tmp_path):
    """The key stays through windows and a densify (both write in place)
    and changes with an LR, λ, an SH-degree bump and a loaded checkpoint."""
    tr = _port_trainer(5, densify_from_iter=0, densification_interval=4,
                       densify_until_iter=500, opacity_reset_interval=0)
    key = _key(tr)
    assert _key(tr) == key
    assert tr.train_window(3) == 3 and _key(tr) == key
    tr.train_iteration()  # iteration 4 densifies in place
    assert _key(tr) == key
    tr.save_checkpoint(tmp_path / "ckpt.pt")
    tr.set_variable_parameters({"feature_lr": 0.003})
    lr_key = _key(tr)
    assert lr_key != key
    tr.set_variable_parameters({"lambda_dssim": 0.3})
    assert _key(tr) not in (key, lr_key)
    it = tr.iteration
    tr.iteration = 1000
    bumped = _key(tr)
    tr.iteration = it
    assert bumped != _key(tr) and tr.sh_degree == 0
    ptrs = {k: getattr(tr.model, k).data_ptr() for k in FIELD_NAMES}
    before = _key(tr)
    tr.load_checkpoint(tmp_path / "ckpt.pt")
    assert _key(tr) != before
    assert all(getattr(tr.model, k).data_ptr() != p for k, p in ptrs.items())
