"""Interactive viewer on a saved model, served over HTTP.

The port's copy of `examples/view_result.py`: the same arguments, the same
`RasterConfig` (2^21 instances, tight and tile culling, a live-slab cap of
2^21·5/8, the kernel backend: tile-major with ``n_contrib``), plus
``--device`` and ``--host``. Without a CUDA device it raises unless
``--device cpu`` is given.

    python -m omnigs_torch.examples.view_result MODEL_PLY [--width W]
        [--height H] [--port P] [--host 0.0.0.0] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.io.ply import load_gaussian_ply
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.viewer.server import ViewerState, make_server, render_view

RASTER_CONFIG = RasterConfig(
    max_instances=1 << 21,
    backend="pallas",
    tight_culling=True,
    tile_culling=True,
    aligned_cap=(1 << 21) * 5 // 8,
)


def make_render_fn(model, camera: Camera, config: RasterConfig = RASTER_CONFIG):
    """``render_fn(vm, campos, mode, scale)`` → (H, W, 3) tensor on the
    model's device: the color, or the depth normalised by its max."""
    bg = torch.zeros(3, device=model.xyz.device)

    def render_fn(vm, campos, mode, scale=1.0):
        return render_view(model, camera, vm, campos, bg, 3, config, mode, scale)

    return render_fn


def build_server(argv=None):
    """Load the PLY and return the viewer's server, not yet serving."""
    ap = argparse.ArgumentParser()
    ap.add_argument("model_ply")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("view_result: no CUDA device (pass --device cpu)")

    model = load_gaussian_ply(args.model_ply, device=device)
    camera = Camera(CameraType.LONLAT, args.width, args.height)
    state = ViewerState(make_render_fn(model, camera), args.width, args.height)
    return make_server(state, args.port, args.host)


def main(argv=None):
    httpd = build_server(argv)
    print(f"viewer listening on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
