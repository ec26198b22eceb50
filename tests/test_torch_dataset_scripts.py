"""The port's dataset scripts and the native image pool:

* `omnigs_torch/scripts/dataset_to_openmvg.py` writes the same bytes as
  the JAX package's `scripts/dataset_to_openmvg.py` (both JSON splits and
  the `--make-points` PLY) from a `pose_c2w.json` written here;
* `omnigs_torch/scripts/run_benchmark.py` trains and tests a two-scene
  list of tiny synthetic scenes through the port's CLIs (`--device cpu`);
* `io/native_loader.ImagePool` over the native library equals
  `load_image` image for image, a file the library cannot decode takes
  `load_image`'s own path (here its error), and without the library the
  pool's thread pool gives the same images;
* the slice's modules import and run with JAX unimportable.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from omnigs_torch.io import native_loader as tnl
from omnigs_torch.scripts import dataset_to_openmvg, make_synthetic_scene, run_benchmark

from torch_helpers import REPO, run_jax_script, tiny_yaml


def _pose_file(scene_dir, seed):
    rng = np.random.default_rng(seed)

    def frames(n, prefix):
        out = []
        for i in range(n):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            w, x, y, z = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, rng.normal(size=3)
            out.append({"rgb_file": f"{prefix}_{i:03d}.jpg", "transform_matrix": T.tolist()})
        return out

    (scene_dir / "images").mkdir(parents=True)
    (scene_dir / "pose_c2w.json").write_text(
        json.dumps({"train": frames(5, "tr"), "test": frames(2, "te")})
    )


def test_dataset_to_openmvg_bytes_equal_jax(tmp_path):
    for k, scene in enumerate(("alpha", "beta")):
        _pose_file(tmp_path / scene, k)
    scene_list = tmp_path / "scenes.txt"
    scene_list.write_text("alpha\nbeta\n")
    outputs = ["openMVG/data_openmvg.json", "openMVG/data_openmvg_test.json",
               "openMVG/scene_init.ply"]

    def run(convert):
        for split in ("train", "test"):
            convert(["--dataset-dir", tmp_path, "--scene-list", scene_list, "--img-width",
                     640, "--img-height", 320, "--split", split, "--make-points", 300])
        got = {(s, o): (tmp_path / s / o).read_bytes() for s in ("alpha", "beta") for o in outputs}
        for s in ("alpha", "beta"):
            shutil.rmtree(tmp_path / s / "openMVG")
        return got

    ref = run(lambda argv: run_jax_script("scripts/dataset_to_openmvg.py", argv))
    got = run(lambda argv: dataset_to_openmvg.main([str(a) for a in argv]))
    assert got.keys() == ref.keys()
    for key, data in ref.items():
        assert got[key] == data, key


def test_run_benchmark_sweeps_two_scenes(tmp_path, monkeypatch):
    # the CLIs' processes take one thread each beside the other test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k, name in enumerate(("s0", "s1")):
        make_synthetic_scene.main([
            str(tmp_path / name), "--width", "32", "--height", "16", "--gaussians", "48",
            "--train-views", "2", "--test-views", "1", "--seed", str(5 + k), "--device", "cpu",
        ])
    (tmp_path / "scenes.txt").write_text("s0\ns1\n")
    cfg = tiny_yaml(tmp_path / "tiny.yaml", **{"Optimization.max_num_iterations": 2})
    run_benchmark.main([
        "--dataset-dir", str(tmp_path), "--scene-list", str(tmp_path / "scenes.txt"),
        "--cfg", str(cfg), "--result-root", str(tmp_path / "out"), "--test-iters", "2",
        "--sfm-json", "sfm_data_train.json", "--test-json", "sfm_data_test.json",
        "--points-ply", "points.ply", "--device", "cpu",
    ])
    for name in ("s0", "s1"):
        out = tmp_path / "out" / name
        assert (out / "2" / "ply" / "point_cloud.ply").is_file()
        assert any((out / "2_test").iterdir())


def _pngs(tmp_path, n=6):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        p = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (20 + i, 30, 3), np.uint8)).save(p)
        paths.append(p)
    return paths


def test_image_pool_native_equals_load_image(tmp_path):
    paths = _pngs(tmp_path)
    pool = tnl.ImagePool(24, 16, n_threads=3)
    assert pool.native, "the native library should load on this host"
    got = dict(pool.load_all(paths))
    assert sorted(got) == list(range(len(paths)))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], tnl.load_image(p, 24, 16))
    pool.close()


def test_image_pool_undecodable_file_takes_load_image_path(tmp_path):
    paths = _pngs(tmp_path)
    bad = tmp_path / "cut.png"
    bad.write_bytes(paths[0].read_bytes()[:60])  # a PNG cut inside its data
    with pytest.raises(Exception) as direct:
        tnl.load_image(bad, 24, 16)
    pool = tnl.ImagePool(24, 16, n_threads=2)
    seen = {}
    with pytest.raises(type(direct.value)):
        for i, img in pool.load_all([*paths, bad]):
            seen[i] = img
    pool.close()
    for i, img in seen.items():
        np.testing.assert_array_equal(img, tnl.load_image(paths[i], 24, 16))


def test_image_pool_without_library_equals_native(tmp_path, monkeypatch):
    paths = _pngs(tmp_path)
    native = tnl.ImagePool(24, 16)
    want = dict(native.load_all(paths))
    native.close()
    monkeypatch.setattr(tnl, "_load_native", lambda: None)
    pool = tnl.ImagePool(24, 16)
    assert not pool.native
    got = dict(pool.load_all(paths))
    pool.close()
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


def test_pool_bench_pools_agree(tmp_path):
    """`scripts/pool_bench` at a tiny size: both pools give the same images
    of PNG and JPEG files, and every arm is timed."""
    from omnigs_torch.scripts import pool_bench

    lines = pool_bench.main(["--images", "3", "--src-width", "64", "--src-height", "32",
                             "--width", "40", "--height", "20", "--repeats", "1",
                             "--threads", "2", "--out", str(tmp_path)])
    assert [x["format"] for x in lines] == ["png", "jpg"]
    for x in lines:
        assert x["equal"] and len(x["native_s"]) == len(x["python_s"]) == 2


def test_slice_modules_import_no_jax():
    """The multi-device modules, the point ops, the scripts and the
    measurement layer import and run with ``jax`` and the JAX package
    unimportable."""
    script = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'omnigs_tpu', 'scripts'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from omnigs_torch.parallel import distributed, mesh, shard\n"
        "from omnigs_torch.train import trainer_parallel\n"
        "from omnigs_torch.model import transform\n"
        "from omnigs_torch.ops import stereo, loss\n"
        "from omnigs_torch.scripts import dataset_to_openmvg, pool_bench, run_benchmark, scaling_bench\n"
        "from omnigs_torch.io import native_loader\n"
        "from omnigs_torch.scripts import (bin_bench, converged_bench, example, kernel_bench,\n"
        "                                  subtile_analysis)\n"
        "from omnigs_torch.utils.profiling import roofline_report\n"
        "assert 0.0 < roofline_report(1920 * 960, 0.03, 142.7)['fraction_of_roofline'] < 1.0\n"
        "bin_bench.run('cpu', 64, 32, 32, 1 << 10)\n"
        "distributed.initialize()  # one process, no init_method: a no-op\n"
        "assert not torch.distributed.is_initialized()\n"
        "a = torch.rand(3, 32, 48, generator=torch.Generator().manual_seed(0))\n"
        "assert torch.equal(loss.ssim_rows(a, a * 0.9, 0, 32, 32), loss.ssim(a, a * 0.9, size_average=False))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'omnigs_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
