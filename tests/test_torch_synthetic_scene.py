"""PyTorch port vs JAX reference: the synthetic scene script
(omnigs_torch/scripts/make_synthetic_scene.py against
scripts/make_synthetic_scene.py) at 64×32 on the CPU, where both render
through their dense plain compositor (``backend="xla"``).

Bars: ``points.ply`` byte-equal; ``sfm_data_{train,test}.json`` equal
except ``root_path``; the float renders within 1e-5 (the image bar of
tests/test_pallas_seg.py) before quantization; the PNGs within one level
per byte."""

import json

import numpy as np
import pytest
from PIL import Image

import omnigs_tpu.train.eval as jeval
from omnigs_torch.scripts import make_synthetic_scene as tscript

from torch_helpers import SCENE_ARGS, run_jax_script


def _read_png(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    jrenders = {}
    save = jeval.save_image

    def capture(path, img):
        jrenders[path.name] = np.asarray(img)
        save(path, img)

    jeval.save_image = capture
    try:
        run_jax_script("scripts/make_synthetic_scene.py", [root / "jax", *SCENE_ARGS])
    finally:
        jeval.save_image = save
    trenders = tscript.main([str(root / "port"), *SCENE_ARGS, "--device", "cpu"])
    return root / "jax", root / "port", jrenders, trenders


def test_points_ply_is_byte_equal(scenes):
    jdir, tdir, _, _ = scenes
    assert (tdir / "points.ply").read_bytes() == (jdir / "points.ply").read_bytes()


@pytest.mark.parametrize("split", ["train", "test"])
def test_sfm_json_equal_but_root_path(scenes, split):
    jdir, tdir, _, _ = scenes
    j = json.loads((jdir / f"sfm_data_{split}.json").read_text())
    t = json.loads((tdir / f"sfm_data_{split}.json").read_text())
    assert t.pop("root_path") == str(tdir / "images")
    j.pop("root_path")
    assert t == j


def test_renders_and_pngs_match(scenes):
    jdir, tdir, jrenders, trenders = scenes
    assert sorted(trenders) == sorted(jrenders) == [
        "test_000.png", "train_000.png", "train_001.png", "train_002.png"]
    for name, ref in jrenders.items():
        assert trenders[name].shape == ref.shape == (3, 32, 64)
        np.testing.assert_allclose(trenders[name], ref, rtol=0, atol=1e-5, err_msg=name)
        got = _read_png(tdir / "images" / name).astype(np.int16)
        want = _read_png(jdir / "images" / name).astype(np.int16)
        assert np.abs(got - want).max() <= 1, name
