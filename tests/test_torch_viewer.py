"""PyTorch port vs JAX reference: the web viewer (omnigs_torch/viewer/
{server,live}.py, omnigs_torch/examples/view_result.py), mirroring
tests/test_viewer.py.

Bars: `_pose_to_viewmatrix` bitwise equal to JAX's; the page, ``/params``
and JPEG frames served; a served color frame within JPEG error of the
render (PSNR ≥ 30 dB); frames from the live trainer during training
(densify included), ``/params`` reaching it; and a run with the live
viewer attached ending `torch.equal` to the same run without it."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.io.ply import save_gaussian_ply
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.train import trainer as ttrainer
from omnigs_torch.train.renderer import render_model as trender
from omnigs_torch.viewer import server as tserver
from omnigs_torch.viewer.live import make_live_render_fn, start_live_viewer
from omnigs_tpu.viewer import server as jserver

from test_torch_trainer import _configs, _scenes
from test_torch_trainer_window import _assert_equal_states, _state
from torch_helpers import PROD_KW, random_model_np

Image = pytest.importorskip("PIL.Image")


def _post(port, path, obj, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=timeout).read()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30).read()


def _decode(jpg):
    return np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"), np.float32) / 255.0


@pytest.mark.parametrize("pose", [(0.0, 0.0, [0, 0, 0]), (0.3, -0.2, [0.1, 0.5, -2.0]),
                                  (-2.5, 1.1, [3.0, -1.0, 0.25])])
def test_pose_to_viewmatrix_matches_jax(pose):
    for got, ref in zip(tserver._pose_to_viewmatrix(*pose), jserver._pose_to_viewmatrix(*pose)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_viewer_serves_page_params_and_frames():
    camera = TCamera(TCameraType.LONLAT, 64, 32)
    model = TModel.from_numpy(random_model_np(21, 40, 32), device="cpu")
    cfg = TRasterConfig(max_instances=1 << 12, **PROD_KW)

    def render_fn(vm, campos, mode, scale=1.0):
        with torch.inference_mode():
            res = trender(model, camera, torch.as_tensor(vm), torch.as_tensor(campos),
                          torch.zeros(3), 2, cfg, render_depth=(mode == "depth"),
                          scale_modifier=scale)
        return res.image.permute(1, 2, 0)

    params = {"lambda_dssim": 0.2}
    state = tserver.ViewerState(
        render_fn, 64, 32, mask=np.ones((32, 64), np.float32),
        params_get=lambda: dict(params), params_set=params.update,
    )
    httpd = tserver.make_server(state, 0, "127.0.0.1")
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert b"omnigs_torch viewer" in _get(port, "/")
        jpg = _post(port, "/render", {"yaw": 0.3, "pitch": 0.0, "pos": [0, 0, 0],
                                      "mode": "color"})
        assert jpg[:2] == b"\xff\xd8" and len(jpg) > 100
        vm, campos = tserver._pose_to_viewmatrix(0.3, 0.0, [0, 0, 0])
        ref = render_fn(vm, campos, "color").numpy()
        mse = float(np.mean((_decode(jpg) - np.clip(ref, 0, 1)) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) >= 30.0
        for body in ({"mode": "depth"}, {"mode": "color", "scale": 0.5}):
            assert _post(port, "/render", body)[:2] == b"\xff\xd8"
        assert json.loads(_get(port, "/params")) == {"lambda_dssim": 0.2}
        _post(port, "/params", {"lambda_dssim": 0.35})
        assert params["lambda_dssim"] == 0.35
    finally:
        httpd.shutdown()


def test_view_result_serves_a_ply(tmp_path):
    from omnigs_torch.examples import view_result

    save_gaussian_ply(tmp_path / "m.ply", TModel.from_numpy(random_model_np(22, 32, 32),
                                                            device="cpu"))
    httpd = view_result.build_server([str(tmp_path / "m.ply"), "--width", "64", "--height",
                                      "32", "--port", "0", "--host", "127.0.0.1",
                                      "--device", "cpu"])
    assert view_result.RASTER_CONFIG.want_ncontrib and not view_result.RASTER_CONFIG.segmented
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for body in ({"mode": "color"}, {"mode": "depth", "scale": 0.5}):
            jpg = _post(port, "/render", body)
            assert jpg[:2] == b"\xff\xd8" and _decode(jpg).shape == (32, 64, 3)
        assert json.loads(_get(port, "/params")) == {}
    finally:
        httpd.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            view_result.build_server([str(tmp_path / "m.ply")])


LIVE_OPT = dict(densify_from_iter=3, densification_interval=5, densify_until_iter=30,
                opacity_reset_interval=0)


def _live_trainer():
    _, ts = _scenes(4)
    _, cfg = _configs(**LIVE_OPT)
    cfg.tpu.capacity = 128
    tr = ttrainer.Trainer(ts, cfg, seed=7, device="cpu")
    tr.init_from_sfm()
    return tr


def test_live_viewer_during_training():
    """Frames render from the live model while training (through two
    densify iterations) advances, ``/params`` changes the running trainer,
    and the run ends bitwise equal to the same run without the viewer."""
    tr = _live_trainer()
    httpd = start_live_viewer(tr, tr.scene, tr.config, 0, width=32, host="127.0.0.1")
    port = httpd.server_address[1]
    frames, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            for mode in ("color", "depth"):
                frames.append(_post(port, "/render", {"mode": mode, "yaw": 0.1 * len(frames)}))

    th = threading.Thread(target=client)
    th.start()
    try:
        assert "lambda_dssim" in json.loads(_get(port, "/params"))
        for it in range(12):
            if it == 6:
                _post(port, "/params", {"lambda_dssim": 0.42})
                assert tr.get_variable_parameters()["lambda_dssim"] == 0.42
            tr.train_iteration()
    finally:
        stop.set()
        th.join()
        httpd.shutdown()
    assert len(frames) >= 2 and all(f[:2] == b"\xff\xd8" for f in frames)
    assert _decode(frames[0]).shape == (32, 32, 3)  # height max(32·64/128, 32)

    ref = _live_trainer()
    for it in range(12):
        if it == 6:
            ref.set_variable_parameters({"lambda_dssim": 0.42})
        ref.train_iteration()
    assert int(tr.model.num_active) != 48  # densify ran
    _assert_equal_states(_state(tr), _state(ref))


def test_live_render_fn_shapes():
    tr = _live_trainer()
    render_fn, w, h = make_live_render_fn(tr, tr.scene, tr.config, 40)
    assert (w, h) == (40, 32)
    vm, campos = tserver._pose_to_viewmatrix(0.0, 0.0, [0, 0, 0])
    color, depth = render_fn(vm, campos, "color"), render_fn(vm, campos, "depth", 0.5)
    assert color.shape == depth.shape == (32, 40, 3)
    assert float(depth.max()) <= 1.0 and torch.equal(depth[..., 0], depth[..., 2])


def test_fair_lock_serves_waiters_in_order():
    """`Trainer.lock` is first come, first served (a training loop that
    releases and asks again queues behind a waiting frame)."""
    import time

    from omnigs_torch.train.trainer import FairLock

    lock, order = FairLock(), []
    lock.acquire()

    def waiter(name):
        with lock:
            order.append(name)

    threads = []
    for name in ("frame1", "frame2"):
        threads.append(threading.Thread(target=waiter, args=(name,)))
        threads[-1].start()
        while len(lock._queue) < len(threads):
            time.sleep(0.001)
    lock.release()
    with lock:  # the releasing thread asks again: it queues behind both
        order.append("trainer")
    for t in threads:
        t.join()
    assert order == ["frame1", "frame2", "trainer"]
    with pytest.raises(RuntimeError, match="not held"):
        lock.release()
