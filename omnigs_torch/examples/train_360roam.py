"""360Roam training entry point: the port's training CLI with the 360Roam
scene layout (``<scene>/openMVG/data_openmvg.json`` +
``<scene>/openMVG/scene.ply``), as `examples/train_360roam.py`.

    python -m omnigs_torch.examples.train_360roam CFG_YAML SCENE_ROOT OUTPUT_DIR [extra args]
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def command(cfg, scene_root, out, extra=()):
    """The argv of the training CLI run for this scene layout."""
    scene = Path(scene_root)
    return [
        sys.executable, "-m", "omnigs_torch.examples.train_openmvg_lonlat",
        cfg, out,
        str(scene / "openMVG" / "data_openmvg.json"),
        str(scene / "openMVG" / "scene.ply"),
        *extra,
    ]


def main(argv=None, usage=__doc__):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(usage)
        sys.exit(1)
    sys.exit(subprocess.run(command(*argv[:3], argv[3:]), cwd=REPO).returncode)


if __name__ == "__main__":
    main()
