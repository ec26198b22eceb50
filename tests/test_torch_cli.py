"""PyTorch port vs JAX reference: the training and test CLIs
(omnigs_torch/examples/{train,test}_openmvg_lonlat.py with ``--device
cpu``) against examples/{train,test}_openmvg_lonlat.py on the JAX
script's 64×32 scene, a few iterations with windows, a densify and a
record; and the port's copy of the PSNR gate against scripts/psnr_gate.py.

Bars: the same output tree; the record files that do not depend on the
trained values byte-equal; every metric file in the reference's line
format; the gate's verdicts and report those of tests/test_quality_gate.py's
four cases."""

import re
import runpy

import pytest

from omnigs_torch.examples import test_openmvg_lonlat as ttest_cli
from omnigs_torch.examples import train_openmvg_lonlat as ttrain_cli
from omnigs_torch.scripts import psnr_gate as tgate

from torch_helpers import REPO, SCENE_ARGS, run_jax_script, tiny_yaml

LINE = re.compile(r"^\d+ -?\d+\.\d{6}$")
# record every 4 iterations, windows of up to 4, densify at 5
YAML = dict(Tpu__fuse_steps=4, Record__all_keyframes_record_interval=4,
            Optimization__densify_from_iter=2, Optimization__densification_interval=5)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_cli_trees_match_jax(tmp_path):
    scene = tmp_path / "scene"
    run_jax_script("scripts/make_synthetic_scene.py", [scene, *SCENE_ARGS])
    cfg = tiny_yaml(tmp_path / "tiny.yaml", **YAML)
    args = [scene / "sfm_data_train.json", scene / "points.ply",
            "--image-root", scene / "images", "--iters", 9, "--log-every", 3]
    run_jax_script("examples/train_openmvg_lonlat.py", [cfg, tmp_path / "j", *args])
    stats = ttrain_cli.main([str(a) for a in (cfg, tmp_path / "t", *args)] + ["--device", "cpu"])
    assert stats["iterations"] == 9 and stats["windows"] >= 2 and stats["single_steps"] >= 2
    assert stats["window_steps"] + stats["single_steps"] == 9
    for d in ("j", "t"):
        test_args = [cfg, tmp_path / d / "test", scene / "sfm_data_test.json",
                     tmp_path / d / "9" / "ply" / "point_cloud.ply"]
        if d == "j":
            run_jax_script("examples/test_openmvg_lonlat.py", test_args)
        else:
            means = ttest_cli.main([str(a) for a in test_args] + ["--device", "cpu"])
            assert means["psnr"] > 5
    jt, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert tt == jt
    for name in ("4/ply/point_cloud.ply", "8/ply/point_cloud.ply", "image_shutdown/2.png",
                 "test/psnr_test.txt", "used_times/keyframe_used_times_shutdown.txt"):
        assert name in tt
    for name in ("cameras.json", "used_times/keyframe_used_times_shutdown.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    args_t = (tmp_path / "t" / "cfg_args").read_text().replace(str(tmp_path / "t"), "OUT")
    assert args_t == (tmp_path / "j" / "cfg_args").read_text().replace(str(tmp_path / "j"), "OUT")
    for name in tt:
        if name.endswith(".txt") and "used_times" not in name and "Peak" not in name:
            lines = (tmp_path / "t" / name).read_text().splitlines()
            assert lines and all(LINE.match(x) for x in lines), name
    assert (tmp_path / "t" / "DevicePeakUsageMB.txt").read_text().startswith("unavailable")


def test_cli_trains_on_a_mesh(tmp_path):
    """``--mesh 2x1 --device cpu`` on two gloo ranks: both take the loop's
    windows and single steps with the same losses (all-reduced), rank 0
    writes the records and the PLYs of the whole model, whose live count
    is the trainer's."""
    from omnigs_torch.io.ply import load_gaussian_ply
    from omnigs_torch.scripts import make_synthetic_scene

    from torch_parallel_workers import cli_worker, run_ranks

    scene = tmp_path / "scene"
    make_synthetic_scene.main([str(scene), *SCENE_ARGS, "--device", "cpu"])
    cfg = tiny_yaml(tmp_path / "tiny.yaml", **YAML)
    argv = [str(a) for a in (cfg, tmp_path / "t", scene / "sfm_data_train.json",
                             scene / "points.ply", "--image-root", scene / "images",
                             "--iters", 6, "--log-every", 3, "--mesh", "2x1", "--device", "cpu")]
    ranks = run_ranks(tmp_path, 2, cli_worker, argv)
    for r in ranks:
        assert r["iterations"] == 6 and r["windows"] >= 1 and r["single_steps"] >= 1
        for k in ("window_steps", "single_steps", "ema_loss", "live"):
            assert r[k] == ranks[0][k], k
    out = tmp_path / "t"
    for name in ("cameras.json", "4/ply/point_cloud.ply", "6/ply/point_cloud.ply",
                 "image_shutdown/2.png", "used_times/keyframe_used_times_shutdown.txt"):
        assert (out / name).exists(), name
    ply = load_gaussian_ply(out / "6" / "ply" / "point_cloud.ply", device="cpu")
    assert int(ply.num_active) == ranks[0]["live"]


def test_cli_refuses_a_mesh_with_the_viewer(tmp_path):
    with pytest.raises(SystemExit):
        ttrain_cli.main(["cfg.yaml", str(tmp_path), "sfm.json", "points.ply", "--mesh", "2x1",
                         "--viewer", "8000", "--device", "cpu"])


MEASURED = 29.4
BAR = MEASURED - 0.5
NOISE = 0.15


@pytest.mark.parametrize("runs, ok", [
    ([[MEASURED - NOISE, MEASURED + 0.2, MEASURED], [MEASURED + NOISE, MEASURED - 0.1, MEASURED]],
     True),
    ([[MEASURED / 2] * 3, [MEASURED / 2] * 3], False),
    ([[MEASURED - 0.7 + NOISE] * 3, [MEASURED - 0.7 - NOISE] * 3], False),
    ([[MEASURED - 2 * 0.3] * 3, [MEASURED] * 3], True),
], ids=["healthy", "halved", "point7_db", "one_noisy_run"])
def test_psnr_gate_matches_jax(tmp_path, capsys, runs, ok):
    dirs = []
    for i, vals in enumerate(runs):
        d = tmp_path / f"run{i}"
        d.mkdir()
        (d / "psnr_test.txt").write_text("".join(f"view{j} {v}\n" for j, v in enumerate(vals)))
        dirs.append(str(d))
    jgate = runpy.run_path(str(REPO / "scripts" / "psnr_gate.py"), run_name="psnr_gate")
    assert jgate["main"](BAR, dirs) == (0 if ok else 1)
    jout = capsys.readouterr().out
    assert tgate.main(BAR, dirs) == (0 if ok else 1)
    assert capsys.readouterr().out == jout
    assert ("OK" if ok else "FAIL") in jout
