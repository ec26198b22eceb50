"""PyTorch port vs JAX reference: result recording and evaluation
(omnigs_torch/train/{record,eval}.py) on the JAX script's 64×32 scene and
one seeded model.

The JAX renders run the segmented path in Pallas interpret mode, the path
the port runs (tests/test_torch_trainer.py). Bars: the record files
byte-equal; the metric files with the same names, keyframes and line
format; SSIM, PSNR and PSNR-GS within 1e-4; rendered, ground-truth and
loss images within one level per byte; the render time by format only."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omnigs_torch.io.openmvg import load_openmvg_scene as tload
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.scene.scene import KeyframeSampler as TSampler
from omnigs_torch.train import eval as teval
from omnigs_torch.train import record as trecord
from omnigs_tpu.io.openmvg import load_openmvg_scene as jload
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.scene.scene import KeyframeSampler as JSampler
from omnigs_tpu.train import eval as jeval
from omnigs_tpu.train import record as jrecord

from torch_helpers import PROD_KW, SCENE_ARGS, random_model_np, run_jax_script

MAX_INST = 1 << 13
LINE = re.compile(r"^\d+ -?\d+\.\d{6}$")


def _read_png(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    run_jax_script("scripts/make_synthetic_scene.py", [d, *SCENE_ARGS])
    js = jload(d / "sfm_data_train.json", d / "points.ply")
    ts = tload(d / "sfm_data_train.json", d / "points.ply")
    fields = random_model_np(11, 128, 96, scale_mu=-2.5)
    jm = JModel(**{k: jnp.asarray(v) for k, v in fields.items()})
    tm = TModel.from_numpy(fields, device="cpu")
    return js, ts, jm, tm


@pytest.mark.parametrize("record", ["cameras", "cfg_args", "used_times", "ply"])
def test_record_files_byte_equal(setup, tmp_path, record):
    js, ts, jm, tm = setup
    outs = []
    for pkg, scene, model, sampler_cls in ((jrecord, js, jm, JSampler),
                                           (trecord, ts, tm, TSampler)):
        out = tmp_path / pkg.__name__.split(".")[0]
        out.mkdir()
        if record == "cameras":
            pkg.save_cameras_json(scene, out)
        elif record == "cfg_args":
            pkg.save_model_params(out, 3, False, "/data/sfm.json", str(out))
        elif record == "used_times":
            sampler = sampler_cls(scene, 2, seed=4)
            for _ in range(7):
                sampler.sample()
            pkg.write_keyframe_used_times(sampler, out / "used_times", "_shutdown")
        else:
            assert pkg.save_ply_checkpoint(model, out, 12) == out / "12" / "ply" / "point_cloud.ply"
        outs.append(out)
    jfiles = sorted(p.relative_to(outs[0]) for p in outs[0].rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(outs[1]) for p in outs[1].rglob("*") if p.is_file())
    assert tfiles == jfiles and jfiles
    for rel in jfiles:
        got, want = (outs[1] / rel).read_bytes(), (outs[0] / rel).read_bytes()
        if record == "cfg_args":  # the model path names each package's directory
            got = got.replace(str(outs[1]).encode(), b"OUT")
            want = want.replace(str(outs[0]).encode(), b"OUT")
        assert got == want, rel


def test_render_and_record_all_keyframes(setup, tmp_path):
    js, ts, jm, tm = setup
    kw = dict(name_suffix="_x", skip_bottom_ratio=0.1, record_rendered_image=True,
              record_ground_truth_image=True, record_loss_image=True)
    jmeans = jeval.render_and_record_all_keyframes(
        jm, js, 1, JRasterConfig(max_instances=MAX_INST, interpret=True, **PROD_KW),
        jnp.zeros(3), result_dir=tmp_path / "j", **kw)
    tmeans = teval.render_and_record_all_keyframes(
        tm, ts, 1, TRasterConfig(max_instances=MAX_INST, **PROD_KW), torch.zeros(3),
        result_dir=tmp_path / "t", **kw)
    assert sorted(tmeans) == sorted(jmeans) == ["psnr", "psnr_gs", "render_time_ms", "ssim"]
    for k in ("ssim", "psnr", "psnr_gs"):
        assert abs(tmeans[k] - jmeans[k]) <= 1e-4, k
    jfiles = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert tfiles == jfiles
    assert len([f for f in jfiles if f.suffix == ".txt"]) == 4
    for rel in jfiles:
        t, j = tmp_path / "t" / rel, tmp_path / "j" / rel
        if rel.suffix == ".png":
            diff = _read_png(t).astype(np.int16) - _read_png(j).astype(np.int16)
            assert np.abs(diff).max() <= 1, rel
            continue
        tl, jl = t.read_text().splitlines(), j.read_text().splitlines()
        assert [x.split()[0] for x in tl] == [x.split()[0] for x in jl] == ["0", "1", "2"]
        assert all(LINE.match(x) for x in tl + jl), rel
        if not rel.name.startswith("render_time"):
            np.testing.assert_allclose([float(x.split()[1]) for x in tl],
                                       [float(x.split()[1]) for x in jl], rtol=0, atol=1e-4)


def test_training_after_eval(setup):
    """Eval computes its metrics without autograd (under inference mode):
    a training step after it still differentiates its loss, SSIM included."""
    from omnigs_torch.model import optimizer as topt
    from omnigs_torch.train.trainer import train_step

    _, ts, _, _ = setup
    cfg = TRasterConfig(max_instances=MAX_INST, **PROD_KW)
    teval.render_and_record_all_keyframes(
        TModel.from_numpy(random_model_np(11, 128, 96, scale_mu=-2.5), device="cpu"),
        ts, 1, cfg, torch.zeros(3))
    model = TModel.from_numpy(random_model_np(12, 128, 96, scale_mu=-2.5), device="cpu")
    kf = ts.keyframes[0]
    aux = train_step(model, topt.init_adam(model.params()), torch.from_numpy(kf.viewmatrix),
                     torch.from_numpy(kf.campos),
                     torch.from_numpy(np.ascontiguousarray(kf.image.transpose(2, 0, 1))), 1,
                     camera=kf.camera, sh_degree=1, raster_cfg=cfg, lr_cfg=topt.LRConfig(),
                     spatial_lr_scale=1.0, bg=torch.zeros(3))
    assert np.isfinite(float(aux["loss"]))
