"""PyTorch port vs JAX reference: the training step and loop
(omnigs_torch/train/trainer.py) on a tiny synthetic scene.

Both packages get the same scene (ground truth rendered once, by the port,
from a seeded cloud) and the same starting state. The JAX trainer runs on
the CPU, where `config.raster_config_from` demotes the kernel path to the
XLA compositor, so the JAX side is forced onto the segmented path in
Pallas interpret mode (``RasterConfig(**PROD_KW, interpret=True)``), the
path the port runs.

Bars: loss rel 1e-5; gradients (read from Adam's first moment, mu = 0.1·g
on the first step) and the densification statistics at the JAX suite's
gradient bars (rtol 2e-3, atol 1e-4·max|ref|). Adam's first step moves each
entry by lr·sign(g): where |g| is below the gradient bar the two packages
may step in opposite directions, so there the updated parameters are held
within 2·lr of each other, elsewhere within 1e-6. Trajectory: the same
keyframe order and per-step losses within rel 1e-4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnigs_torch.config as tconfig
import omnigs_tpu.config as jconfig
from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.model import optimizer as topt
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.scene.keyframe import Keyframe as TKeyframe
from omnigs_torch.scene.scene import Scene as TScene
from omnigs_torch.train import trainer as ttrainer
from omnigs_torch.train.renderer import render_model as trender
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.scene.keyframe import Keyframe as JKeyframe
from omnigs_tpu.scene.scene import Scene as JScene
from omnigs_tpu.train import trainer as jtrainer

from torch_helpers import PROD_KW, random_model_np

W, H = 128, 64
MAX_INST = 1 << 13
N_GT = 48


def _scene_np(seed=0, n_views=3):
    """Keyframe poses and GT images (H, W, 3) rendered by the port from a
    seeded cloud, a noisy SfM cloud from its means, and dc colors."""
    rng = np.random.default_rng(seed)
    f = random_model_np(seed + 100, N_GT, N_GT)
    gt_model = TModel.from_numpy(f, device="cpu")
    views = []
    for _ in range(n_views):
        angle = rng.normal() * 0.2
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = (rng.normal(size=3) * 0.1).astype(np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = R, t
        with torch.inference_mode():
            res = trender(
                gt_model, TCamera(TCameraType.LONLAT, W, H), torch.from_numpy(vm),
                torch.from_numpy(-R.T @ t), torch.zeros(3), 3,
                TRasterConfig(max_instances=MAX_INST, **PROD_KW),
            )
        views.append((R, t, res.image.permute(1, 2, 0).numpy().copy()))
    points = (f["xyz"] + rng.normal(size=(N_GT, 3)) * 0.05).astype(np.float32)
    colors = np.clip(f["features_dc"][:, 0] * 0.28209479177387814 + 0.5, 0, 1)
    return views, points, colors.astype(np.float32)


def _scenes(seed=0):
    views, points, colors = _scene_np(seed)
    js, ts = JScene(), TScene()
    for i, (R, t, img) in enumerate(views):
        js.add_keyframe(JKeyframe(i, Camera(CameraType.LONLAT, W, H), R, t, image=img))
        ts.add_keyframe(TKeyframe(i, TCamera(TCameraType.LONLAT, W, H), R, t, image=img))
    for s in (js, ts):
        s.points, s.colors = points, colors
    return js, ts


def _configs(**opt):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        cfg.tpu = dataclasses.replace(cfg.tpu, capacity=64, max_instances=MAX_INST)
        for k, v in opt.items():
            setattr(cfg.opt, k, v)
        out.append(cfg)
    return out


def _trainers(seed=0, **opt):
    js, ts = _scenes(seed)
    jcfg, tcfg = _configs(**opt)
    jt = jtrainer.Trainer(js, jcfg, seed=7)
    # the JAX trainer demotes the kernel path on a CPU backend: force the
    # segmented path the port runs, in Pallas interpret mode
    jt.raster_cfg = JRasterConfig(max_instances=MAX_INST, interpret=True, **PROD_KW)
    tt = ttrainer.Trainer(ts, tcfg, seed=7, device="cpu")
    assert tt.raster_cfg == TRasterConfig(max_instances=MAX_INST, tile_cap=1024,
                                          chunk=64, **PROD_KW)
    jt.init_from_sfm()
    tt.init_from_sfm()
    return jt, tt


def _grad_close(got, ref, name):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4 * scale + 1e-12,
                               err_msg=name)


def test_train_step_matches_jax():
    jt, tt = _trainers(0)
    # the same starting state in both packages: anisotropic, rotated
    # Gaussians, so every parameter group has a gradient
    fields = random_model_np(3, 64, N_GT, scale_mu=-2.5)
    tm = TModel.from_numpy(fields, device="cpu")
    tstate = topt.init_adam(tm.params())
    kf = jt.scene.keyframes[1]
    vm, campos = kf.viewmatrix, kf.campos
    gt = kf.image.transpose(2, 0, 1)
    kw = dict(sh_degree=1, lambda_dssim=0.2, skip_bottom_px=4, update_stats=True,
              do_adam=True, skip_opacity_update=False, spatial_lr_scale=2.0)
    jm, jstate, jaux = jtrainer.train_step(
        JModel(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jopt.init_adam({k: jnp.asarray(fields[k]) for k in tm.params()}),
        jnp.asarray(vm), jnp.asarray(campos), jnp.asarray(gt), jnp.asarray(5),
        camera=Camera(CameraType.LONLAT, W, H), raster_cfg=jt.raster_cfg,
        lr_cfg=jt.lr_cfg, bg=jnp.zeros(3), **kw,
    )
    taux = ttrainer.train_step(
        tm, tstate, torch.from_numpy(vm), torch.from_numpy(campos),
        torch.from_numpy(np.ascontiguousarray(gt)), 5,
        camera=TCamera(TCameraType.LONLAT, W, H), raster_cfg=tt.raster_cfg,
        lr_cfg=tt.lr_cfg, bg=torch.zeros(3), **kw,
    )
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(taux["radii"].numpy(), np.asarray(jaux["radii"]))
    assert int(taux["truncated"]) == int(jaux["truncated"]) == 0
    # densification statistics: the ndc gradient norms
    _grad_close(tm.xyz_gradient_accum.numpy(), np.asarray(jm.xyz_gradient_accum), "ndc")
    np.testing.assert_array_equal(tm.denom.numpy(), np.asarray(jm.denom))
    np.testing.assert_array_equal(tm.max_radii2d.numpy(), np.asarray(jm.max_radii2d))
    assert int(tstate.count) == int(jstate.count) == 1
    lrs = jopt.group_lrs(jt.lr_cfg, 2.0, 5)
    for name, p in tm.params().items():
        mu_ref = np.asarray(jstate.mu[name])
        # mu = 0.1·g and nu = 0.001·g² on the first step
        _grad_close(tstate.mu[name].numpy(), mu_ref, f"mu/{name}")
        _grad_close(np.sqrt(tstate.nu[name].numpy() / 0.001),
                    np.sqrt(np.asarray(jstate.nu[name]) / 0.001), f"nu/{name}")
        g_ref = np.abs(mu_ref / 0.1)
        small = g_ref <= 2e-3 * g_ref + 1e-4 * g_ref.max()
        lr = float(lrs[name])
        bound = np.where(small, 2.0 * lr + 1e-6, 1e-6)
        diff = np.abs(p.detach().numpy() - np.asarray(getattr(jm, name)))
        assert (diff <= bound).all(), (name, float(diff.max()))
        assert float(np.abs(p.detach().numpy() - fields[name]).max()) > 0, name


def _record_order(trainer):
    order = []
    sample = trainer.sampler.sample

    def recording():
        kf = sample()
        order.append(kf.fid)
        return kf

    trainer.sampler.sample = recording
    return order


def test_trajectory_matches_jax():
    """Six iterations with densify off: the same keyframe order and
    per-step losses within rel 1e-4."""
    jt, tt = _trainers(1, densify_from_iter=1000, opacity_reset_interval=0)
    jorder, torder = _record_order(jt), _record_order(tt)
    jl, tl = [], []
    for _ in range(6):
        jl.append(float(jt.train_iteration()["loss"]))
        tl.append(float(tt.train_iteration()["loss"]))
    assert jorder == torder
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tt.drain_losses() == pytest.approx(tl[-1])
    assert tt.total_truncated == 0


def test_port_training_reduces_loss():
    """Port only, 40 iterations through densify (as tests/test_trainer.py):
    the loss drops and everything stays finite."""
    _, ts = _scenes(2)
    _, cfg = _configs(densify_from_iter=10, densification_interval=10,
                      densify_until_iter=35, opacity_reset_interval=0,
                      position_lr_max_steps=40)
    cfg.tpu.capacity = 128
    tr = ttrainer.Trainer(ts, cfg, device="cpu")
    tr.init_from_sfm()
    assert int(tr.model.num_active) == N_GT
    losses = [float(tr.train_iteration()["loss"]) for _ in range(40)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[35:]) < np.mean(losses[:5]), losses
    for k, v in tr.model.to_numpy().items():
        assert v.dtype == bool or np.isfinite(v).all(), k
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.train_window(4)
