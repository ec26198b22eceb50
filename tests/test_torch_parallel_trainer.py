"""PyTorch port vs JAX reference: `ParallelTrainer`
(`omnigs_torch/train/trainer_parallel.py`) on gloo ranks.

The port at mesh (2, 2) against JAX's `ParallelTrainer` at (2, 4) (the
conftest's eight virtual CPU devices), with the config of
tests/test_parallel_trainer.py, over the iterations before the first
densify (19: densify runs at iteration 20). JAX's sharded gradients are
n_gauss times one device's (tests/test_torch_parallel_factor.py); Adam's
ε = 1e-15 makes the parameter updates blind to that scale, so the two
trajectories agree: losses within rtol 1e-5, the gathered parameters at
ROADMAP's gradient bar (rtol 2e-3, atol 1e-4·max|ref|) in 99% of entries
and within two Adam steps (2·lr) in all: where a gradient lies below the
two packages' float noise, Adam's ±lr steps may part (the bar of
tests/test_torch_trainer.py for one step). Both packages train on the
same numpy scene (`torch_parallel_workers.scene_np`). The JAX sharded
path preprocesses without `tight_culling` (`omnigs_tpu/parallel/shard.py:67`)
where the port honours it, so both run with it off here. Every rank of the
port logs bitwise the same losses, and `train_window` logs the single
steps' losses.
"""

import dataclasses

import numpy as np

from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.config import Config
from omnigs_tpu.scene.keyframe import Keyframe
from omnigs_tpu.scene.scene import Scene
from omnigs_tpu.train.trainer_parallel import ParallelTrainer as JParallelTrainer

from torch_parallel_workers import run_ranks, scene_np, trainer_worker

TPU = dict(capacity=128, max_instances=1 << 12, tile_cap=64, chunk=8, backend="xla",
           tight_culling=False)
OPT = dict(densify_from_iter=10, densification_interval=10, densify_until_iter=25,
           opacity_reset_interval=0, position_lr_max_steps=30)
ITERS = 19
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _jax_scene(data):
    """The JAX package's `Scene` of a `scene_np` scene."""
    scene = Scene()
    for fid, (w, h, R, t, img) in enumerate(data["views"]):
        scene.add_keyframe(Keyframe(fid, Camera(CameraType.LONLAT, w, h), R, t, image=img))
    scene.points, scene.colors = data["points"], data["colors"]
    return scene


def test_parallel_trainer_matches_jax(tmp_path):
    data = scene_np(0, 64, 32, 4)
    cfg = Config()
    cfg.tpu = dataclasses.replace(cfg.tpu, **TPU, mesh_data=2, mesh_gauss=4)
    for k, v in OPT.items():
        setattr(cfg.opt, k, v)
    jt = JParallelTrainer(_jax_scene(data), cfg)
    jt.init_from_sfm()
    ref_losses = np.array([float(jt.train_iteration()) for _ in range(ITERS)])
    ref = jt.host_model()

    ranks = run_ranks(
        tmp_path, 4, trainer_worker, data, dict(TPU, mesh_data=2, mesh_gauss=2),
        OPT, 0, [("step", ITERS)],
    )
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
    lr = dict(xyz=cfg.opt.position_lr_init * jt.cameras_extent,
              features_dc=cfg.opt.feature_lr, features_rest=cfg.opt.feature_lr / 20,
              opacity=cfg.opt.opacity_lr, scaling=cfg.opt.scaling_lr,
              rotation=cfg.opt.rotation_lr)
    for k in PARAMS:
        want = np.asarray(getattr(ref, k))
        diff = np.abs(got["model"][k] - want)
        bar = 2e-3 * np.abs(want) + 1e-4 * np.abs(want).max()
        # Adam steps ±lr where a gradient is below the two packages' float
        # noise, so there the two may part by up to two steps
        assert (diff <= np.maximum(bar, 2 * lr[k])).all(), k
        assert (diff <= bar).mean() >= 0.99, k
    # lock-step: every rank logged the same losses, bit for bit
    for r in ranks[1:]:
        assert np.array_equal(r["losses"], got["losses"])
        assert r["model"] is None and r["iteration"] == ITERS


def test_parallel_train_window_matches_single_steps(tmp_path):
    """Windows of `train_window` (ending before every event) log the single
    steps' losses, on mesh (1, 2) across the densify at iteration 8."""
    data = scene_np(9, 32, 16, 3)
    tpu = dict(TPU, capacity=64, mesh_data=1, mesh_gauss=2, fuse_steps=3)
    opt = dict(OPT, densify_from_iter=4, densification_interval=4)
    steps = run_ranks(tmp_path, 2, trainer_worker, data, tpu, opt, 2, [("step", 11)])
    windows = run_ranks(tmp_path, 2, trainer_worker, data, tpu, opt, 2, [("window", 11)])
    for a, b in zip(steps, windows):
        assert np.array_equal(a["losses"], b["losses"])
    for k in PARAMS:
        assert np.array_equal(steps[0]["model"][k], windows[0]["model"][k]), k
