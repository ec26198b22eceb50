"""PyTorch port vs JAX reference: the scene's file formats
(omnigs_torch/io/{ply,native_loader,openmvg}.py, train/eval.save_image).

Bars: the points PLY byte-equal between the packages (float and double
xyz); `load_image` bitwise equal to the JAX package's native loader at
identity size, for RGB and RGBA files PIL wrote and for files with every
scanline filter, and within 1e-6 when resizing; `save_image`'s PNG
byte-equal to the JAX package's; a scene loaded from the JAX script's openMVG files equal
in cameras, poses, images and points."""

import json
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from omnigs_torch.io import native_loader as tnl
from omnigs_torch.io.openmvg import load_openmvg_scene as tload
from omnigs_torch.io.ply import load_points_ply as tload_pts
from omnigs_torch.io.ply import save_points_ply as tsave_pts
from omnigs_torch.train.eval import save_image as tsave_image
from omnigs_tpu.io import native_loader as jnl
from omnigs_tpu.io.openmvg import load_openmvg_scene as jload
from omnigs_tpu.io.ply import _write_ply as jwrite_ply
from omnigs_tpu.io.ply import load_points_ply as jload_pts
from omnigs_tpu.io.ply import save_points_ply as jsave_pts
from omnigs_tpu.train.eval import save_image as jsave_image

from torch_helpers import SCENE_ARGS, run_jax_script


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    out = tmp_path_factory.mktemp("scene")
    run_jax_script("scripts/make_synthetic_scene.py", [out, *SCENE_ARGS])
    return out


def _image(seed, h=37, w=53, channels=3):
    """Smooth ramps with rows of noise: PIL's adaptive filtering then picks
    several filter types."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 4, y * 6, (x + y) * 2, 255 - x][:channels], -1)
    arr = base.astype(np.uint8)
    arr[::3] = np.random.default_rng(seed).integers(0, 256, arr[::3].shape, np.uint8)
    return arr


def test_points_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(-0.1, 1.1, size=(50, 3)).astype(np.float32)
    jsave_pts(tmp_path / "j.ply", pts, cols)
    tsave_pts(tmp_path / "t.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for got, ref in zip(tload_pts(tmp_path / "t.ply"), jload_pts(tmp_path / "t.ply")):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("typ", ["float", "double"])
def test_points_ply_loads_as_jax(tmp_path, typ):
    """Double xyz (EgoNeRF) and float xyz without colors (grey)."""
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(40, 3))
    cols = [(n, typ, xyz[:, i]) for i, n in enumerate("xyz")]
    if typ == "double":
        rgb = rng.integers(0, 256, size=(40, 3)).astype(np.uint8)
        cols += [(n, "uchar", rgb[:, i]) for i, n in enumerate(("red", "green", "blue"))]
    jwrite_ply(tmp_path / "p.ply", cols)
    for got, ref in zip(tload_pts(tmp_path / "p.ply"), jload_pts(tmp_path / "p.ply")):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_load_image_reads_pil_files_as_native_loader(tmp_path, mode):
    """PIL's adaptively filtered files; an alpha channel is dropped."""
    assert jnl.build_native() and jnl.native_available()
    arr = _image(2, channels=len(mode))
    Image.fromarray(arr, mode).save(tmp_path / "a.png")
    data = (tmp_path / "a.png").read_bytes()
    idat = [data[p + 8 : p + 8 + int.from_bytes(data[p : p + 4], "big")]
            for p in range(8, len(data) - 4) if data[p + 4 : p + 8] == b"IDAT"]
    scan = zlib.decompress(b"".join(idat))
    stride = arr.shape[1] * len(mode) + 1
    assert len({scan[r * stride] for r in range(arr.shape[0])}) > 1  # filtered rows
    got = tnl.load_image(tmp_path / "a.png", 53, 37)
    np.testing.assert_array_equal(got, jnl.load_image(tmp_path / "a.png", 53, 37))
    np.testing.assert_array_equal(got, arr[..., :3].astype(np.float32) * tnl.INV_255)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered_png(rgb, kinds):
    """An RGB PNG whose row y uses filter ``kinds[y % len(kinds)]``."""
    h, w, _ = rgb.shape
    raw = rgb.reshape(h, w * 3).astype(np.int64)
    rows = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = raw[y]
        prior = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (tnl.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_load_image_undoes_every_filter(tmp_path, kinds):
    assert jnl.build_native() and jnl.native_available()
    arr = _image(3)
    (tmp_path / "f.png").write_bytes(_filtered_png(arr, kinds))
    got = tnl.load_image(tmp_path / "f.png", 53, 37)
    np.testing.assert_array_equal(got, jnl.load_image(tmp_path / "f.png", 53, 37))
    np.testing.assert_array_equal(got, arr.astype(np.float32) * tnl.INV_255)


def test_save_image_bytes_match_jax(tmp_path):
    img = np.random.default_rng(4).uniform(-0.1, 1.1, size=(3, 37, 53)).astype(np.float32)
    jsave_image(tmp_path / "j.png", img)
    tsave_image(tmp_path / "t.png", img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


@pytest.mark.parametrize("size", [(53, 37), (20, 15), (100, 80), (53, 20)])
def test_load_image_matches_native_loader(tmp_path, size):
    """The native loader's arithmetic: `* (1.0f/255.0f)` (not `/ 255`) and
    its point-sampled bilinear resize."""
    assert jnl.build_native() and jnl.native_available()
    Image.fromarray(_image(5)).save(tmp_path / "a.png")
    got = tnl.load_image(tmp_path / "a.png", *size)
    ref = jnl.load_image(tmp_path / "a.png", *size)
    assert got.dtype == np.float32 and got.shape == (size[1], size[0], 3)
    if size == (53, 37):
        np.testing.assert_array_equal(got, ref)
        # the division rounds some bytes the other way
        assert not np.array_equal(got, _image(5).astype(np.float32) / 255)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_load_image_other_formats_go_native(tmp_path, monkeypatch):
    assert jnl.build_native()
    Image.fromarray(_image(6)).save(tmp_path / "a.jpg", quality=90)
    np.testing.assert_array_equal(tnl.load_image(tmp_path / "a.jpg", 53, 37),
                                  jnl.load_image(tmp_path / "a.jpg", 53, 37))
    monkeypatch.setattr(tnl, "SO_PATH", tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="native image loader"):
        tnl.load_image(tmp_path / "a.jpg", 53, 37)


def test_openmvg_scene_matches_jax(jax_scene):
    kw = dict(znear=0.05, zfar=50.0)
    js = jload(jax_scene / "sfm_data_train.json", jax_scene / "points.ply", **kw)
    ts = tload(jax_scene / "sfm_data_train.json", jax_scene / "points.ply", **kw)
    assert {k: (c.width, c.height, int(c.camera_type)) for k, c in ts.cameras.items()} == {
        k: (c.width, c.height, int(c.camera_type)) for k, c in js.cameras.items()}
    assert sorted(ts.keyframes) == sorted(js.keyframes) == [0, 1, 2]
    for fid, jk in js.keyframes.items():
        tk = ts.keyframes[fid]
        assert (tk.img_filename, tk.znear, tk.zfar) == (jk.img_filename, 0.05, 50.0)
        np.testing.assert_array_equal(tk.R_cw, jk.R_cw)
        np.testing.assert_array_equal(tk.t_cw, jk.t_cw)
        np.testing.assert_array_equal(tk.image, jk.image)
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)
    # image_root, resolution_scale and image_filter as in JAX
    kw = dict(image_root=jax_scene / "images", resolution_scale=0.5,
              image_filter=lambda fid: fid != 1)
    js = jload(jax_scene / "sfm_data_test.json", **kw)
    ts = tload(jax_scene / "sfm_data_test.json", **kw)
    assert ts.points is None and ts.keyframes[0].image.shape == (16, 32, 3)
    np.testing.assert_allclose(ts.keyframes[0].image, js.keyframes[0].image, rtol=0, atol=1e-6)


def _as_pinhole(jax_scene, out_json, disto_k3=(0.1, 0.01, 0.002)):
    """The scene's train JSON with its intrinsic made a radial-k3 pinhole."""
    root = json.loads((jax_scene / "sfm_data_train.json").read_text())
    intr = root["intrinsics"][0]["value"]
    intr["polymorphic_name"] = "pinhole_radial_k3"
    v0 = intr["ptr_wrapper"]["data"]["value0"]
    intr["ptr_wrapper"]["data"] = {
        "value0": {"value0": v0, "focal_length": 30.0, "principal_point": [31.5, 16.25]},
        "disto_k3": list(disto_k3),
    }
    out_json.write_text(json.dumps(root))
    return out_json


def test_openmvg_pinhole_raises(tmp_path, jax_scene):
    """A pinhole scene loads in both packages with equal cameras, and then
    raises at its first training step, in the port as in JAX: neither
    trainer passes `full_proj` (ROADMAP, reference-side behaviours)."""
    from omnigs_torch.config import load_config as tload_config
    from omnigs_torch.train.trainer import Trainer as TTrainer
    from omnigs_tpu.config import load_config as jload_config
    from omnigs_tpu.train.trainer import Trainer as JTrainer

    from torch_helpers import tiny_yaml

    sfm = _as_pinhole(jax_scene, tmp_path / "sfm.json")
    kw = dict(image_root=jax_scene / "images")
    js = jload(sfm, jax_scene / "points.ply", **kw)
    ts = tload(sfm, jax_scene / "points.ply", **kw)
    assert ts.cameras == {k: type(ts.cameras[k])(**vars(c)) for k, c in js.cameras.items()}
    yaml = tiny_yaml(tmp_path / "cfg.yaml")
    jt = JTrainer(js, jload_config(yaml))
    tt = TTrainer(ts, tload_config(yaml), device="cpu")
    for tr in (jt, tt):
        tr.init_from_sfm()
        with pytest.raises(ValueError, match="pinhole camera requires full_proj"):
            tr.train_iteration()
