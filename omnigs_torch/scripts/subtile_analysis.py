"""The potential of sub-tile (8×8) early termination, measured from one
forward render on one card.

The port's copy of `scripts/subtile_analysis.py`. The compositing walk of
a tile stops when every pixel of the 16×16 tile has saturated (N <
T_STOP). Each pixel's stop rank is what ``n_contrib`` records, so one
forward render through the tile-major path (the only one that computes
``n_contrib``) gives the exact chunk counts that a termination per
quadrant (or per half) would walk:

  whole-tile chunks = Σ_t ceil(max_px n_contrib / 128)         (the walk)
  quadrant chunks   = Σ_t Σ_q ceil(max_q n_contrib / 128) / 4  (hypothetical)

`subtile_chunks` is that arithmetic. The printed ratios, quadrant and half
chunk work over whole-tile chunk work, bound what sub-tile termination
could save (1 − ratio, before the cost of its branches). The workload is
the JAX script's: lonlat 1920×960, P = 2^17 of the example model from the
identity pose, SH degree 3, the tile-major route with ``want_ncontrib``,
tight culling and tile culling, 26·2^16 instance slots, an 8,704·128-lane
slab; `run` takes smaller sizes for a run on the CPU.

    python -m omnigs_torch.scripts.subtile_analysis [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.ops.preprocess import TILE, tile_grid
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.scripts.example import SH_DEGREE, example_model
from omnigs_torch.train.renderer import render_model

CH = 128  # lanes per chunk of the walk


def subtile_chunks(n_contrib, gx: int, gy: int) -> dict:
    """Chunk work of whole-tile, quadrant (8×8) and half (8×16) termination
    from the (gy·16, gx·16) stop ranks ``n_contrib`` (0 = nothing), in
    units of a quarter tile for the whole and the halves, and the ratios."""
    nc = np.asarray(n_contrib).reshape(gy, TILE, gx, TILE).transpose(0, 2, 1, 3)

    def chunks(maxr):
        return np.ceil(maxr / CH)

    whole = chunks(nc.reshape(gy, gx, -1).max(-1)).sum() * 4  # ×4 quadrants
    q = nc.reshape(gy, gx, 2, 8, 2, 8).transpose(0, 1, 2, 4, 3, 5)
    quad = chunks(q.reshape(gy, gx, 4, -1).max(-1)).sum()
    h = nc.reshape(gy, gx, 2, 8, 16)  # 8×16 halves: split the rows only
    half = chunks(h.reshape(gy, gx, 2, -1).max(-1)).sum() * 2
    return {"whole": float(whole), "quadrant": float(quad), "half": float(half),
            "quadrant_ratio": float(quad / whole), "half_ratio": float(half / whole),
            "saving_bound": float(1.0 - quad / whole)}


def run(device, width=1920, height=960, gaussians=1 << 17, max_instances=26 << 16,
        aligned_cap=8704 * 128) -> dict:
    """One forward render of the example model → its `subtile_chunks`,
    ``truncated``, ``n_contrib`` (on the host) and the device; prints the
    JAX script's line."""
    dev = torch.device(device)
    cam = Camera(CameraType.LONLAT, width, height)
    gx, gy = tile_grid(cam)
    model = example_model(gaussians, dev)
    # the JAX script's config: tile-major with n_contrib
    cfg = RasterConfig(max_instances=max_instances, aligned_cap=aligned_cap,
                       backend="pallas", tight_culling=True, tile_culling=True,
                       want_ncontrib=True)
    with torch.inference_mode():
        res = render_model(model, cam, torch.eye(4, device=dev), torch.zeros(3, device=dev),
                           torch.zeros(3, device=dev), SH_DEGREE, cfg)
    nc = res.n_contrib.cpu().numpy()
    out = subtile_chunks(nc, gx, gy)
    print(f"quadrant-chunk-work / whole-tile: {out['quadrant_ratio']:.4f} "
          f"(halves: {out['half_ratio']:.4f}) — upper bound on kernel-time saving "
          f"= 1 − ratio (plus per-quadrant branch overhead)", flush=True)
    out.update(truncated=int(res.truncated), n_contrib=nc,
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
