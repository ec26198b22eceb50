"""The numerical smoke test: three hand-placed colored Gaussians, identity
pose, an equirect render written to ``simple_cloud.png``.

The port's copy of `examples/simple_cloud.py`: the same arguments and
cloud (the reference's overrides: log-scale −0.3, opacity logit 5.0; SH
degree 0), rendered through the kernel backend (tile-major), plus
``--device``. The JAX script's ``tile_cap`` and ``chunk`` configure only
its XLA backend.

    python -m omnigs_torch.examples.simple_cloud OUTPUT_DIR [dist]
        [--width 2000] [--height 1000] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model.gaussians import from_pcd
from omnigs_torch.ops.knn import mean_sq_knn_dist
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.train.eval import save_image
from omnigs_torch.train.renderer import render_model


def main(argv=None) -> dict:
    """Render and save; returns the image ((3, H, W) float32 on the host),
    the truncation counter and the PNG's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("output_dir")
    ap.add_argument("dist", type=float, nargs="?", default=2.0)
    ap.add_argument("--width", type=int, default=2000)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    d = args.dist
    pts = torch.tensor(
        [[d, -5 * d, d], [-d, 0.5 * d, -0.7 * d], [d, d, -d]], dtype=torch.float32,
        device=dev,
    )
    cols = torch.eye(3, dtype=torch.float32, device=dev)
    model = from_pcd(pts, cols, 3, mean_sq_knn_dist(pts))
    with torch.no_grad():
        model.scaling.fill_(-0.3)
        model.opacity.fill_(5.0)

    camera = Camera(CameraType.LONLAT, args.width, args.height)
    with torch.inference_mode():
        res = render_model(
            model, camera, torch.eye(4, device=dev), torch.zeros(3, device=dev),
            torch.zeros(3, device=dev), sh_degree=0,
            config=RasterConfig(max_instances=1 << 16, backend="pallas"),
        )
        image = res.image.cpu().numpy()
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_image(out / "simple_cloud.png", image)
    print(f"wrote {out / 'simple_cloud.png'}", flush=True)
    return dict(image=np.asarray(image), truncated=int(res.truncated),
                path=out / "simple_cloud.png")


if __name__ == "__main__":
    main()
