"""EgoNeRF (OmniBlender / Ricoh360) training entry point: the port's
training CLI with the openMVG scene layout, as `examples/train_egonerf.py`
(the datasets differ from 360Roam only in paths and double-precision PLY
xyz, which `io/ply.py` reads as it comes).

    python -m omnigs_torch.examples.train_egonerf CFG_YAML SCENE_ROOT OUTPUT_DIR [extra args]
"""

from omnigs_torch.examples.train_360roam import command, main  # noqa: F401

if __name__ == "__main__":
    main(usage=__doc__)
