"""Scene-sweep benchmark runner: train each scene, then evaluate the saved
PLYs at the test iterations.

The port's copy of `scripts/run_benchmark.py`: the same arguments, plus
``--device`` (passed to both CLIs), running
``python -m omnigs_torch.examples.train_openmvg_lonlat`` and
``test_openmvg_lonlat``. Its default ``--cfg`` is the repository's
`cfg/lonlat/360roam_lonlat.yaml`.

    python -m omnigs_torch.scripts.run_benchmark --dataset-dir D \\
        --scene-list L --result-root R [--cfg CFG] [--test-iters 8000 32000] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--scene-list", required=True)
    ap.add_argument("--cfg", default=str(REPO / "cfg" / "lonlat" / "360roam_lonlat.yaml"))
    ap.add_argument("--result-root", required=True)
    ap.add_argument("--test-iters", type=int, nargs="*", default=[8000, 32000])
    ap.add_argument("--sfm-json", default="openMVG/data_openmvg.json")
    ap.add_argument("--test-json", default="openMVG/data_openmvg_test.json")
    ap.add_argument("--points-ply", default="openMVG/scene.ply")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(args.scene_list) as f:
        scenes = [line.strip() for line in f if line.strip()]
    # the CLIs run from the caller's directory, the package from this tree
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    for scene in scenes:
        scene_root = Path(args.dataset_dir) / scene
        result_dir = Path(args.result_root) / scene
        subprocess.run(
            [sys.executable, "-m", "omnigs_torch.examples.train_openmvg_lonlat", args.cfg,
             str(result_dir), str(scene_root / args.sfm_json),
             str(scene_root / args.points_ply), "--device", args.device],
            check=True, env=env,
        )
        for it in args.test_iters:
            subprocess.run(
                [sys.executable, "-m", "omnigs_torch.examples.test_openmvg_lonlat", args.cfg,
                 str(result_dir / f"{it}_test"), str(scene_root / args.test_json),
                 str(result_dir / str(it) / "ply" / "point_cloud.ply"), "--device", args.device],
                check=True, env=env,
            )


if __name__ == "__main__":
    main()
