"""PyTorch port vs JAX reference: the Trainer API of the training CLI
(omnigs_torch/train/trainer.py `train_window`, `_next_event_iter`,
`get/set_variable_parameters`, `save/load_checkpoint`, and
omnigs_torch/train/checkpoint.py) on tests/test_torch_trainer.py's tiny
scene, the JAX side on the segmented path in Pallas interpret mode.

Bars: the event schedule equal; a window bitwise equal to as many single
iterations (parameters, statistics, Adam state, losses); port windows
against JAX windows with the same keyframe order and losses within rel
1e-4 (the trajectory test's bar); the checkpoint round trip bitwise; a
JAX state carried over into the port: losses within rel 1e-4, Adam
moments within rtol 2e-3, atol 1e-4·max|ref| (the gradient bars)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import omnigs_torch.config as tconfig
import omnigs_tpu.config as jconfig
from omnigs_torch.model.gaussians import FIELD_NAMES, PARAM_NAMES
from omnigs_torch.train import trainer as ttrainer
from omnigs_torch.train.checkpoint import checkpoint_from_numpy
from omnigs_tpu.train import trainer as jtrainer

from test_torch_trainer import _configs, _record_order, _scenes, _trainers

NO_DENSIFY = dict(densify_from_iter=1000, opacity_reset_interval=0)


def _port_trainer(seed=0, **opt):
    _, ts = _scenes(seed)
    _, cfg = _configs(**opt)
    tr = ttrainer.Trainer(ts, cfg, seed=7, device="cpu")
    tr.init_from_sfm()
    return tr


def _state(tr):
    out = {f"model/{k}": getattr(tr.model, k).detach().clone() for k in FIELD_NAMES}
    for k in PARAM_NAMES:
        out[f"mu/{k}"] = tr.opt_state.mu[k].clone()
        out[f"nu/{k}"] = tr.opt_state.nu[k].clone()
    out["count"] = tr.opt_state.count.clone()
    return out


def _assert_equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("opt", [
    {},
    dict(densify_from_iter=150, densification_interval=100, densify_until_iter=500,
         opacity_reset_interval=0, max_num_iterations=600),
    dict(densify_from_iter=7, densification_interval=0, densify_until_iter=2500,
         opacity_reset_interval=30, max_num_iterations=1300),
])
def test_next_event_iter_matches_jax(opt):
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        for k, v in opt.items():
            setattr(cfg.opt, k, v)
        cfgs.append(types.SimpleNamespace(config=cfg))
    its = list(range(0, 1100, 7)) + [99, 100, 149, 150, 499, 500, 599, 600, 999, 1000,
                                     2999, 3000, 14999, 15000, 32009, 32010, 40000]
    got = [ttrainer.Trainer._next_event_iter(cfgs[1], it) for it in its]
    assert got == [jtrainer.Trainer._next_event_iter(cfgs[0], it) for it in its]
    assert all(g > it for g, it in zip(got, its))


def test_window_equals_single_iterations_bitwise():
    """Windows of up to 4 through densify (every 5th iteration from 3) and
    opacity resets (every 8th) until 14, against the same 16 iterations one
    at a time."""
    opt = dict(densify_from_iter=3, densification_interval=5, densify_until_iter=14,
               opacity_reset_interval=8, max_num_iterations=20, position_lr_max_steps=20)
    a, b = _port_trainer(3, **opt), _port_trainer(3, **opt)
    windows = 0
    while a.iteration < 16:
        took = a.train_window(min(4, 16 - a.iteration))
        if took:
            windows += 1
            assert 0 < took <= 4
        else:
            a.train_iteration()
    for _ in range(16):
        b.train_iteration()
    assert windows >= 3 and a.iteration == b.iteration == 16
    assert a.sampler.used_times == b.sampler.used_times
    _assert_equal_states(_state(a), _state(b))
    assert torch.equal(torch.stack([x for x, _, _ in a._pending_losses]),
                       torch.stack([x for x, _, _ in b._pending_losses]))
    assert a.drain_losses() == b.drain_losses() and a.ema_loss == b.ema_loss
    assert a.total_truncated == b.total_truncated == 0
    # an event next: no window
    a.iteration = 19
    assert a.train_window(4) == 0


def test_windows_match_jax():
    """Two windows of 3 from iteration 0 in both packages: the same
    keyframes, in the same order, and losses within rel 1e-4."""
    jt, tt = _trainers(4, **NO_DENSIFY)
    jorder, torder = _record_order(jt), _record_order(tt)
    for _ in range(2):
        assert jt.train_window(3) == tt.train_window(3) == 3
    assert jorder == torder and jt.iteration == tt.iteration == 6
    jl = np.concatenate([np.atleast_1d(np.asarray(x)) for x, _, _ in jt._pending_losses])
    tl = [float(x) for x, _, _ in tt._pending_losses]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jt.drain_losses()
    tt.drain_losses()
    assert tt.total_truncated == jt.total_truncated == 0
    assert tt.total_overflow == jt.total_overflow


def test_variable_parameters_match_jax():
    js, ts = _scenes(0)
    jcfg, tcfg = _configs()
    jt = jtrainer.Trainer(js, jcfg, seed=1)
    tt = ttrainer.Trainer(ts, tcfg, seed=1, device="cpu")
    assert ttrainer.Trainer.VARIABLE_PARAMS == jtrainer.Trainer.VARIABLE_PARAMS
    assert tt.get_variable_parameters() == jt.get_variable_parameters()
    updates = dict(position_lr_init=2e-4, scaling_lr=0.004, lambda_dssim=0.3,
                   densification_interval=50.0, opacity_reset_interval=1000,
                   new_keyframe_times_of_use=3)
    for t in (jt, tt):
        t.set_variable_parameters(updates)
        with pytest.raises(KeyError):
            t.set_variable_parameters({"no_such_parameter": 1})
    got, want = tt.get_variable_parameters(), jt.get_variable_parameters()
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    assert got["densification_interval"] == 50 and got["position_lr_init"] == 2e-4
    assert tt.sampler.times_of_use == jt.sampler.times_of_use == 3
    assert dataclasses.asdict(tt.lr_cfg) == dataclasses.asdict(jt.lr_cfg)


def test_checkpoint_round_trip_bitwise(tmp_path):
    tr = _port_trainer(5, **NO_DENSIFY)
    for _ in range(4):
        tr.train_iteration()
    tr.save_checkpoint(tmp_path / "ckpt.pt")
    saved = _state(tr)
    rng = tr.sampler.rng.getstate()
    charges = {f: kf.remaining_times_of_use for f, kf in tr.scene.keyframes.items()}
    tr.train(3, fuse=2)
    first = _state(tr)
    tr.load_checkpoint(tmp_path / "ckpt.pt")
    assert tr.iteration == 4
    _assert_equal_states(_state(tr), saved)
    tr.sampler.rng.setstate(rng)
    for f, kf in tr.scene.keyframes.items():
        kf.remaining_times_of_use = charges[f]
    tr.train(3, fuse=2)
    assert tr.iteration == 7
    _assert_equal_states(_state(tr), first)
    with pytest.raises(ValueError, match="capacity"):
        tr.config.tpu.capacity = 32
        tr.load_checkpoint(tmp_path / "ckpt.pt")


def test_carry_over_from_jax(tmp_path):
    """A JAX trainer's state after 3 iterations → `checkpoint_from_numpy` →
    a port trainer; both then take 3 more iterations."""
    jt, tt = _trainers(6, **NO_DENSIFY)
    for _ in range(3):
        jt.train_iteration()
    model_np = {k: np.asarray(getattr(jt.model, k)) for k in FIELD_NAMES}
    opt_np = {f"{m}/{k}": np.asarray(getattr(jt.opt_state, m)[k])
              for m in ("mu", "nu") for k in PARAM_NAMES}
    opt_np["count"] = np.asarray(jt.opt_state.count)
    checkpoint_from_numpy(model_np, opt_np, jt.iteration, tmp_path / "carry.pt")
    tt.load_checkpoint(tmp_path / "carry.pt")
    assert tt.iteration == 3 and int(tt.opt_state.count) == 3
    for _ in range(3):  # the port's sampler draws what the JAX one drew
        tt.sampler.sample()
    jorder, torder = _record_order(jt), _record_order(tt)
    jl = [float(jt.train_iteration()["loss"]) for _ in range(3)]
    tl = [float(tt.train_iteration()["loss"]) for _ in range(3)]
    assert jorder == torder
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for m in ("mu", "nu"):
        for k in PARAM_NAMES:
            ref = np.asarray(getattr(jt.opt_state, m)[k])
            np.testing.assert_allclose(getattr(tt.opt_state, m)[k].numpy(), ref, rtol=2e-3,
                                       atol=1e-4 * float(np.abs(ref).max()), err_msg=f"{m}/{k}")
