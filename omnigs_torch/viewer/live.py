"""The viewer beside a running trainer.

Counterpart of `omnigs_tpu/viewer/live.py`: `start_live_viewer` serves the
trainer's live model over HTTP from a daemon thread and exposes its
variable parameters on ``/params``, so the page's editors change the
running optimisation.

The JAX viewer renders an immutable snapshot of ``tr.model``; the port's
trainer updates its tensors in place (Adam) and re-lays them
(densify/prune). So every frame renders under ``tr.lock``, which
`Trainer.train_iteration` holds for a whole iteration, on the request
thread, on the trainer's device and its default stream, and is read back
to the host before the lock is released: a frame never sees a
half-applied step. The render draws no random number and writes no state
(``torch.inference_mode``), so a run with the viewer attached trains
exactly as one without it.
"""

from __future__ import annotations

import threading

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.viewer.server import ViewerState, make_server, render_view


def make_live_render_fn(tr, scene, cfg, width: int):
    """Render-from-pose closure over the trainer's live model → (render_fn,
    width, height); ``render_fn(vm, campos, mode, scale)`` returns an (H, W,
    3) tensor on the trainer's device (depth normalised by its max)."""
    cam0 = next(iter(scene.keyframes.values())).camera
    height = max(width * cam0.height // cam0.width, 32)
    vcam = Camera(CameraType.LONLAT, width, height)
    sh_degree = cfg.model.sh_degree

    def render_fn(vm, campos, mode, scale=1.0):
        return render_view(tr.model, vcam, vm, campos, tr.bg, sh_degree, tr.raster_cfg,
                           mode, scale)

    return render_fn, width, height


def start_live_viewer(tr, scene, cfg, port: int, width: int = 960,
                      host: str = "0.0.0.0"):
    """Serve the live viewer from a daemon thread; returns the server
    (``shutdown()`` stops it; port 0 picks a free one,
    ``server_address[1]``)."""
    render_fn, width, height = make_live_render_fn(tr, scene, cfg, width)
    state = ViewerState(
        render_fn, width, height,
        params_get=tr.get_variable_parameters,
        params_set=tr.set_variable_parameters,
        lock=tr.lock,
    )
    httpd = make_server(state, port, host)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"live viewer on http://{host}:{httpd.server_address[1]}", flush=True)
    return httpd
