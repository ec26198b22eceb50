"""PyTorch port vs JAX reference: coarse-to-fine pyramid training
(omnigs_torch/train/trainer.py `train_iteration` under ``GausPyramid.do``,
`Keyframe.current_pyramid_level`, the per-level ground truth and undistort
masks) on a 64×32 lonlat scene with two sub-levels (16×16 — the 8-pixel
level height clamped to 16 — and 32×16, then 64×32).

Both trainers start from the same state (the JAX trainer's, carried over
with `checkpoint_from_numpy`), the JAX one on the segmented path in Pallas
interpret mode. Bars: the same keyframe order and level sequence; the
per-level ground truth and masks bitwise equal (cv2 on the host in both);
losses within rel 1e-4 and the Adam moments within rtol 2e-3, atol
1e-4·max|ref| (tests/test_torch_trainer.py's bars); `train_window`
takes no step."""

import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.model.gaussians import FIELD_NAMES, PARAM_NAMES
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.scene.keyframe import Keyframe as TKeyframe
from omnigs_torch.scene.scene import Scene as TScene
from omnigs_torch.train import trainer as ttrainer
from omnigs_torch.train.checkpoint import checkpoint_from_numpy
from omnigs_torch.train.renderer import render_model as trender
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.scene.keyframe import Keyframe as JKeyframe
from omnigs_tpu.scene.scene import Scene as JScene
from omnigs_tpu.train import trainer as jtrainer

from test_torch_trainer import _configs, _record_order
from torch_helpers import PROD_KW, random_model_np

W, H = 64, 32
MAX_INST = 1 << 12
DIST_KW = dict(fx=40.0, fy=40.0, cx=32.0, cy=16.0, distortion=(0.3, 0.05, 0.0, 0.0, 0.0))


def _scenes(seed=4, n_views=3):
    """Three lonlat keyframes whose ground truth the port renders from a
    seeded cloud, plus a distorted pinhole camera registered beside them
    (for the per-level masks; no keyframe uses it)."""
    rng = np.random.default_rng(seed)
    f = random_model_np(seed + 100, 48, 48)
    gt_model = TModel.from_numpy(f, device="cpu")
    js = JScene(cameras={0: Camera(CameraType.LONLAT, W, H),
                         1: Camera(CameraType.PINHOLE, W, H, **DIST_KW)})
    ts = TScene(cameras={0: TCamera(TCameraType.LONLAT, W, H),
                         1: TCamera(TCameraType.PINHOLE, W, H, **DIST_KW)})
    for i in range(n_views):
        a = rng.normal() * 0.2
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        t = (rng.normal(size=3) * 0.1).astype(np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = R, t
        with torch.inference_mode():
            img = trender(gt_model, ts.cameras[0], torch.from_numpy(vm),
                          torch.from_numpy(-R.T @ t), torch.zeros(3), 3,
                          TRasterConfig(max_instances=MAX_INST, **PROD_KW)).image
        img = img.permute(1, 2, 0).numpy().copy()
        js.add_keyframe(JKeyframe(i, js.cameras[0], R, t, image=img))
        ts.add_keyframe(TKeyframe(i, ts.cameras[0], R, t, image=img))
    pts = (f["xyz"] + rng.normal(size=(48, 3)) * 0.05).astype(np.float32)
    cols = np.clip(f["features_dc"][:, 0] * 0.28209479177387814 + 0.5, 0, 1)
    for s in (js, ts):
        s.points, s.colors = pts, cols.astype(np.float32)
    return js, ts


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    js, ts = _scenes()
    jcfg, tcfg = _configs(densify_from_iter=1000, opacity_reset_interval=0)
    for cfg in (jcfg, tcfg):
        cfg.pyramid.do, cfg.pyramid.num_sub_levels = True, 2
        cfg.pyramid.sub_level_times_of_use = 4
    jt = jtrainer.Trainer(js, jcfg, seed=3)
    jt.raster_cfg = JRasterConfig(max_instances=MAX_INST, interpret=True, **PROD_KW)
    tt = ttrainer.Trainer(ts, tcfg, seed=3, device="cpu")
    tt.raster_cfg = TRasterConfig(max_instances=MAX_INST, **PROD_KW)
    jt.init_from_sfm()
    tt.init_from_sfm()
    path = tmp_path_factory.mktemp("carry") / "state.pt"
    checkpoint_from_numpy(
        {k: np.asarray(getattr(jt.model, k)) for k in FIELD_NAMES},
        {**{f"{m}/{k}": np.asarray(getattr(jt.opt_state, m)[k])
            for m in ("mu", "nu") for k in PARAM_NAMES},
         "count": np.asarray(jt.opt_state.count)}, 0, path)
    tt.load_checkpoint(path)
    orders = _record_order(jt), _record_order(tt)
    runs = {"jax": [], "port": []}
    windows = []
    for _ in range(40):
        windows.append((jt.train_window(4), tt.train_window(4)))
        for name, tr in (("jax", jt), ("port", tt)):
            aux = tr.train_iteration()
            runs[name].append((float(aux["loss"]), tuple(aux["image"].shape)))
    return jt, tt, orders, runs, windows


def test_level_sequence_and_losses_match_jax(trained):
    jt, tt, (jorder, torder), runs, windows = trained
    assert jorder == torder and len(torder) == 40
    assert [s for _, s in runs["port"]] == [tuple(s) for _, s in runs["jax"]]
    sizes = [s for _, s in runs["port"]]
    # each keyframe: 4 uses at 16×16, 4 at 32×16, then full size
    assert sizes.count((3, 16, 16)) == sizes.count((3, 16, 32)) == 12
    assert sizes.count((3, 32, 64)) == 16
    for kf in tt.scene.keyframes.values():
        assert kf.pyramid_budgets == [0, 0]
    np.testing.assert_allclose([v for v, _ in runs["port"]], [v for v, _ in runs["jax"]],
                               rtol=1e-4)
    assert windows == [(0, 0)] * 40
    for m in ("mu", "nu"):
        for k in PARAM_NAMES:
            ref = np.asarray(getattr(jt.opt_state, m)[k])
            np.testing.assert_allclose(getattr(tt.opt_state, m)[k].numpy(), ref, rtol=2e-3,
                                       atol=1e-4 * float(np.abs(ref).max()), err_msg=f"{m}/{k}")


def test_level_ground_truth_matches_jax(trained):
    jt, tt, *_ = trained
    assert sorted(tt._gt_cache) == sorted(jt._gt_cache)
    assert {w for _, w in tt._gt_cache} == {16, 32, 64}
    for key, ref in jt._gt_cache.items():
        got = tt._gt_cache[key]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=str(key))


@pytest.mark.parametrize("size", [(16, 16), (32, 16), (64, 32)])
def test_level_masks_match_jax(trained, size):
    jt, tt, *_ = trained
    jcam, tcam = jt.scene.cameras[1], tt.scene.cameras[1]
    level = (Camera(CameraType.LONLAT, *size), TCamera(TCameraType.LONLAT, *size))
    ref = np.asarray(jt._mask(jcam, level[0]))
    got = tt._mask(tcam, level[1])
    assert got.shape == (size[1], size[0])
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tt._mask(tt.scene.cameras[0], level[1]) is None
