"""PyTorch port vs JAX reference: undistortion (omnigs_torch/cameras.py
`init_undistort_map_and_mask` / `undistort_image`, the scene's mask
registry, pinhole intrinsics and undistortion at load in io/openmvg.py,
and the mask in the training loss and in eval), mirroring
tests/test_undistort.py.

Bars: maps, masks and undistorted images bitwise equal (both are the same
cv2 calls on the host); cameras equal; losses rel 1e-5 and eval metrics
rel 1e-5 against the JAX package (the trainer tests' loss bar), the JAX
side on the segmented path in Pallas interpret mode."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnigs_torch.cameras as tcams
import omnigs_tpu.cameras as jcams
from omnigs_torch.io.openmvg import load_openmvg_scene as tload
from omnigs_torch.model import optimizer as topt
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops import loss as tloss
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.scene.keyframe import Keyframe as TKeyframe
from omnigs_torch.scene.scene import Scene as TScene
from omnigs_torch.train import eval as teval
from omnigs_torch.train import trainer as ttrainer
from omnigs_torch.train.renderer import render_model as trender
from omnigs_tpu.io.openmvg import load_openmvg_scene as jload
from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.scene.keyframe import Keyframe as JKeyframe
from omnigs_tpu.scene.scene import Scene as JScene
from omnigs_tpu.train import eval as jeval
from omnigs_tpu.train import trainer as jtrainer

from torch_helpers import PROD_KW, SCENE_ARGS, random_model_np, run_jax_script

cv2 = pytest.importorskip("cv2")

CAM_KW = dict(fx=40.0, fy=40.0, cx=32.0, cy=24.0, distortion=(0.3, 0.05, 0.0, 0.0, 0.0))
JCAM = jcams.Camera(jcams.CameraType.PINHOLE, 64, 48, **CAM_KW)
TCAM = tcams.Camera(tcams.CameraType.PINHOLE, 64, 48, **CAM_KW)


@pytest.mark.parametrize("distortion", [CAM_KW["distortion"], (-0.2, 0.0, 0.0, 0.0, 0.04),
                                        (0.1, 0.0, 0.0, 0.0)])
def test_maps_and_mask_match_jax(distortion):
    jc = dataclasses.replace(JCAM, distortion=distortion)
    tc = dataclasses.replace(TCAM, distortion=distortion)
    ref = jcams.init_undistort_map_and_mask(jc)
    got = tcams.init_undistort_map_and_mask(tc)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    mask = got[2]
    assert mask.shape == (48, 64) and mask[24, 32] == 1.0
    img = np.random.default_rng(0).uniform(size=(48, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcams.undistort_image(img, *got[:2]),
                                  jcams.undistort_image(img, *ref[:2]))
    assert tcams.init_undistort_map_and_mask(
        tcams.Camera(tcams.CameraType.LONLAT, 64, 32)) == (None, None, None)


def test_scene_mask_registry():
    lonlat = tcams.Camera(tcams.CameraType.LONLAT, 64, 32)
    scene = TScene(cameras={0: TCAM, 1: lonlat})
    mask = scene.undistort_mask(TCAM)
    np.testing.assert_array_equal(mask, JScene(cameras={0: JCAM}).undistort_mask(JCAM))
    assert scene.undistort_mask(lonlat) is None
    assert set(scene.undistort_masks) == {TCAM}
    scene.build_undistort_masks()  # idempotent
    assert scene.undistort_mask(TCAM) is mask


@pytest.fixture(scope="module")
def pinhole_scene(tmp_path_factory):
    """The JAX script's small scene, its intrinsic made a radial-k3 pinhole."""
    out = tmp_path_factory.mktemp("scene")
    run_jax_script("scripts/make_synthetic_scene.py", [out, *SCENE_ARGS])
    root = json.loads((out / "sfm_data_train.json").read_text())
    intr = root["intrinsics"][0]["value"]
    intr["polymorphic_name"] = "pinhole_radial_k3"
    v0 = intr["ptr_wrapper"]["data"]["value0"]
    intr["ptr_wrapper"]["data"] = {
        "value0": {"value0": v0, "focal_length": 30.0, "principal_point": [31.5, 16.25]},
        "disto_k3": [0.25, 0.02, -0.01],
    }
    (out / "pinhole.json").write_text(json.dumps(root))
    return out


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_openmvg_pinhole_matches_jax(pinhole_scene, scale):
    kw = dict(image_root=pinhole_scene / "images", resolution_scale=scale)
    js = jload(pinhole_scene / "pinhole.json", **kw)
    ts = tload(pinhole_scene / "pinhole.json", **kw)
    (jc,), (tc,) = js.cameras.values(), ts.cameras.values()
    assert tc.camera_type == tcams.CameraType.PINHOLE
    assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
    assert tc.distortion == (0.25, 0.02, 0.0, 0.0, -0.01)
    assert (tc.width, tc.fx) == (int(round(64 * scale)), 30.0 * scale)
    for fid, jk in js.keyframes.items():
        tk = ts.keyframes[fid]
        assert tk.image.dtype == np.float32
        np.testing.assert_array_equal(tk.image, jk.image)
        np.testing.assert_allclose(tk.full_proj, jk.full_proj, rtol=1e-6)
    # undistorted once at load: the raw frame remapped through the maps
    from omnigs_torch.io.native_loader import load_image

    m1, m2, _ = tcams.init_undistort_map_and_mask(tc)
    kf = ts.keyframes[0]
    raw = load_image(pinhole_scene / "images" / kf.img_filename, tc.width, tc.height)
    assert np.array_equal(kf.image, tcams.undistort_image(raw, m1, m2))
    assert not np.array_equal(kf.image, raw)
    np.testing.assert_array_equal(ts.undistort_mask(tc), js.undistort_mask(jc))


def _lonlat_step_inputs():
    """A model, a ground truth and a mask. The ground truth is not constant
    (tests/test_undistort.py's is 0.4 everywhere): against a constant the
    SSIM's σ12 is a cancellation of ~1e-8 beside c2 = 9e-4, and the two
    packages' matrix products round it differently at ~1e-5 of the loss."""
    fields = random_model_np(8, 32, 24)
    gt = np.random.default_rng(9).uniform(0.2, 0.6, (3, 32, 64)).astype(np.float32)
    mask = (np.indices((32, 64)).sum(0) % 3 != 0).astype(np.float32)
    return fields, gt, mask


def test_train_step_applies_mask():
    """The port's loss with a mask equals its loss on a manually masked
    render and JAX's masked loss, and differs from the unmasked loss."""
    fields, gt, mask = _lonlat_step_inputs()
    tcam = tcams.Camera(tcams.CameraType.LONLAT, 64, 32)
    cfg = TRasterConfig(max_instances=1 << 12, **PROD_KW)
    kw = dict(camera=tcam, sh_degree=2, raster_cfg=cfg, lr_cfg=topt.LRConfig(),
              spatial_lr_scale=1.0, bg=torch.zeros(3), update_stats=False, do_adam=False)

    def step(m):
        model = TModel.from_numpy(fields, device="cpu")
        return float(ttrainer.train_step(
            model, topt.init_adam(model.params()), torch.eye(4)[None], torch.zeros(1, 3),
            torch.from_numpy(gt)[None], 1, None if m is None else torch.from_numpy(m), **kw,
        )["loss"])

    with torch.inference_mode():
        pred = trender(TModel.from_numpy(fields, device="cpu"), tcam, torch.eye(4),
                       torch.zeros(3), torch.zeros(3), 2, cfg).image * torch.from_numpy(mask)
        expect = float(tloss.training_loss(pred, torch.from_numpy(gt)))
    masked = step(mask)
    assert masked == pytest.approx(expect, rel=1e-5)
    assert abs(step(None) - masked) > 1e-6
    jm = JModel(**{k: jnp.asarray(v) for k, v in fields.items()})
    _, _, jaux = jtrainer.train_step(
        jm, jopt.init_adam(jm.params()), jnp.eye(4), jnp.zeros(3), jnp.asarray(gt),
        jnp.asarray(1), jnp.asarray(mask), camera=jcams.Camera(jcams.CameraType.LONLAT, 64, 32),
        sh_degree=2, raster_cfg=JRasterConfig(max_instances=1 << 12, interpret=True, **PROD_KW),
        lr_cfg=jopt.LRConfig(), spatial_lr_scale=1.0, bg=jnp.zeros(3), update_stats=False,
        do_adam=False,
    )
    assert masked == pytest.approx(float(jaux["loss"]), rel=1e-5)


def test_eval_applies_mask():
    fields, _, _ = _lonlat_step_inputs()
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    gt = np.random.default_rng(1).uniform(size=(16, 32, 3)).astype(np.float32)
    tk = TKeyframe(0, tcams.Camera(tcams.CameraType.LONLAT, 32, 16), R, t, image=gt)
    jk = JKeyframe(0, jcams.Camera(jcams.CameraType.LONLAT, 32, 16), R, t, image=gt)
    mask = np.zeros((16, 32), np.float32)
    mask[:, :16] = 1.0
    tm = TModel.from_numpy(fields, device="cpu")
    tcfg = TRasterConfig(max_instances=1 << 12, **PROD_KW)
    _, masked, m_masked = teval.render_and_record_keyframe(tm, tk, 2, tcfg, torch.zeros(3),
                                                           mask=mask)
    _, _, m_plain = teval.render_and_record_keyframe(tm, tk, 2, tcfg, torch.zeros(3))
    assert float(masked[:, :, 16:].abs().max()) == 0.0
    assert m_masked["psnr"] != m_plain["psnr"]
    _, jmasked, jm_masked = jeval.render_and_record_keyframe(
        JModel(**{k: jnp.asarray(v) for k, v in fields.items()}), jk, 2,
        JRasterConfig(max_instances=1 << 12, interpret=True, **PROD_KW), jnp.zeros(3),
        mask=mask)
    np.testing.assert_allclose(masked.numpy(), np.asarray(jmasked), atol=1e-5)
    for k in ("ssim", "psnr", "psnr_gs"):
        assert m_masked[k] == pytest.approx(jm_masked[k], rel=1e-5), k
