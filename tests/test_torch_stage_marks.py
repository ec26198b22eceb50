"""The port's stage marks and run-wide counters (omnigs_torch/utils/
profiling.py `mark`, `stage_totals`, `set_marks`, `counters`) on the CPU,
where a mark writes the host clock into the host's table: the marks of an
eager render, step, window and event iteration arrive in the stage
table's order, the stages' host-clock sum is the step's wall time, marks
off record nothing and change no bit, the counters count bank builds,
host waits and captures with their reasons, and the log line prints them.
The card's side (the marks inside a captured graph, `%globaltimer` against
the trace) is tests/test_torch_kernels_gpu.py's."""

import dataclasses
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import omnigs_torch.config as tconfig
from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.scene.keyframe import Keyframe
from omnigs_torch.scene.scene import Scene
from omnigs_torch.train import trainer as ttrainer
from omnigs_torch.train.renderer import render_model
from omnigs_torch.utils import profiling

from torch_helpers import PROD_KW, random_model_np, window_key

W, H = 64, 32
# an eager step's marks: the render's, closed by its end, then the step's
STEP = ["preprocess", "bin", "relay", "composite_fwd", "end", "loss", "composite_bwd",
        "preprocess_bwd", "adam"]
STEP_STAGES = set(STEP) - {"end"}


def _scene(seed=0, n_views=3):
    rng = np.random.default_rng(seed)
    f = random_model_np(seed + 60, 128, 96)
    truth = GaussianModel.from_numpy(f, device="cpu")
    cam = Camera(CameraType.LONLAT, W, H)
    scene = Scene()
    for i in range(n_views):
        a = rng.normal() * 0.2
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        t = (rng.normal(size=3) * 0.1).astype(np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = R, t
        with torch.inference_mode():
            img = render_model(truth, cam, torch.from_numpy(vm), torch.from_numpy(-R.T @ t),
                               torch.zeros(3), 3,
                               RasterConfig(max_instances=1 << 13, **PROD_KW)).image
        scene.add_keyframe(Keyframe(i, cam, R, t, image=img.permute(1, 2, 0).numpy().copy()))
    scene.points = (f["xyz"][:96] + rng.normal(size=(96, 3)) * 0.05).astype(np.float32)
    scene.colors = np.clip(f["features_dc"][:96, 0] * 0.28209479177387814 + 0.5, 0, 1)
    return scene, truth, cam


def _trainer(**opt):
    scene, _, _ = _scene()
    cfg = tconfig.Config()
    cfg.tpu = dataclasses.replace(cfg.tpu, capacity=256, max_instances=1 << 13)
    cfg.opt = dataclasses.replace(
        cfg.opt, **{"densify_from_iter": 100, "densification_interval": 100,
                    "densify_until_iter": 500, "opacity_reset_interval": 0, **opt})
    tr = ttrainer.Trainer(scene, cfg, seed=7, device="cpu")
    tr.init_from_sfm()
    return tr


@pytest.fixture
def marks(monkeypatch):
    """The marks called, in order, as they run."""
    seen = []
    real = profiling.mark

    def spy(stage, where):
        seen.append(stage)
        real(stage, where)

    monkeypatch.setattr(profiling, "mark", spy)
    profiling.set_marks(True)
    return seen


def test_stage_table_matches_the_cuda_source():
    """csrc/stage_marks.cu launches one kernel per stage of `STAGES`, in
    the same order (its table's slots are the Python table's)."""
    src = (Path(profiling.__file__).parents[1] / "csrc" / "stage_marks.cu").read_text()
    body = re.search(r"#define OMNIGS_STAGES\(X\)(.*?)\n\n", src, re.S).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", body)) == profiling.STAGES
    assert profiling.TABLE_LEN == 2 + 2 * len(profiling.STAGES)


@pytest.mark.parametrize("path, expected", [
    ("render", ["preprocess", "bin", "relay", "composite_fwd", "end"]),
    ("iteration", STEP + ["end"]),
    ("window", (["window"] + STEP + ["end"]) * 2),
    ("densify", STEP + ["densify", "end"]),
    ("reset", STEP + ["reset", "end"]),
])
def test_marks_arrive_in_table_order(marks, path, expected):
    """An eager render, an eager iteration, a CPU window of two steps, and
    an event iteration that densifies or resets (which skips Adam but
    keeps the statistics' stage): each mark once, in the table's order."""
    if path == "render":
        _, truth, cam = _scene()
        marks.clear()
        with torch.inference_mode():
            render_model(truth, cam, torch.eye(4), torch.zeros(3), torch.zeros(3), 3,
                         RasterConfig(max_instances=1 << 13, **PROD_KW))
    else:
        opt = dict(densify=dict(densify_from_iter=0, densification_interval=1),
                   reset=dict(opacity_reset_interval=1)).get(path, {})
        tr = _trainer(**opt)
        marks.clear()
        if path == "window":
            assert tr.train_window(2) == 2
        else:
            tr.train_iteration()
    assert marks == expected
    order = [profiling.STAGES.index(s) for s in marks if s != "window"]
    for a, b in zip(order, order[1:]):
        assert b > a or profiling.STAGES[a] == "end"


def test_host_clock_stages_hold_the_step():
    """The stages' host-clock sum over three eager iterations is within 5%
    of their wall time, each stage closed once an iteration."""
    tr = _trainer()
    tr.train_iteration()  # banks, first use
    profiling.reset_marks()
    t0 = time.perf_counter()
    for _ in range(3):
        tr.train_iteration()
    wall_ms = (time.perf_counter() - t0) * 1e3
    totals = profiling.stage_totals("cpu")
    assert {s for s, (_, n) in totals.items() if n} == STEP_STAGES
    assert all(totals[s][1] == 3 for s in STEP_STAGES)
    assert sum(ms for ms, _ in totals.values()) == pytest.approx(wall_ms, rel=0.05)


def test_marks_off_record_nothing_and_change_no_bit():
    """With `set_marks(False)` a window and an iteration leave the tables
    as they were, and their losses and state equal those with marks on
    bit for bit; the capture key holds the switch."""
    out = []
    for on in (True, False):
        profiling.set_marks(on)
        try:
            tr = _trainer()
            profiling.reset_marks()
            assert tr.train_window(2) == 2
            tr.train_iteration()
            totals = profiling.stage_totals()
            key = window_key(tr)
        finally:
            profiling.set_marks(True)
        losses = torch.cat([x.reshape(-1) for x, _, _ in tr._pending_losses])
        out.append((totals, key, losses, [getattr(tr.model, k) for k in ("xyz", "opacity")]))
    (on_t, on_key, on_l, on_s), (off_t, off_key, off_l, off_s) = out
    assert all(n == 0 for _, n in off_t.values()) and on_t["adam"][1] == 3
    assert torch.equal(on_l, off_l) and all(torch.equal(a, b) for a, b in zip(on_s, off_s))
    assert ttrainer.capture_reason(on_key, off_key) == "addresses+marks"
    assert ttrainer.capture_reason(on_key, on_key._replace(static=())) == "static"
    assert ttrainer.capture_reason(None, on_key) == "first"


def test_counters_count_bank_builds_waits_and_the_log():
    """A bank build (once per keyframe set), the drain's and the live
    count's host waits, and the log line's stages and counters."""
    profiling.reset_counters()
    tr = _trainer()
    tr._bank_rows([])
    tr._bank_rows([])
    assert profiling.counters()["bank_builds"] == 1
    tr.train_window(2)
    tr.train_iteration()
    tr.drain_losses()
    tr.drain_losses()  # nothing queued: no wait
    assert tr.live_gaussians() == 96
    got = profiling.counters()
    assert got["host_waits"] == {"drain": 1, "live_gaussians": 1}
    assert set(got["host_wait_ms"]) == {"drain", "live_gaussians"}
    assert got["captures"] == got["replays"] == 0
    line = tr.trace_line()
    assert re.search(r"ms/step window=\S+ preprocess=\S+ .*adam=\S+", line), line
    assert "captures=0 warmup_steps=0 replays=0 bank_builds=1 | replay_queue=0 | " in line
    assert re.search(r"\| syncs drain=1/\S+ms live_gaussians=1/\S+ms$", line), line
    assert "preprocess=" not in tr.trace_line()  # nothing since the last line
    profiling.count_capture("static")
    assert profiling.counters()["capture_reasons"] == {"static": 1}
    with pytest.raises(KeyError):
        profiling.count("no_such_counter")
    profiling.reset_counters()
    assert profiling.counters()["captures"] == 0


def test_trace_line_prints_each_counter_and_wait_site_since_the_last():
    """The log line's counters since its last call: captures with their
    reasons, warm-up steps, replays, bank builds; the replay queue's waits
    apart from the sync points', each site's count and host ms."""
    profiling.reset_counters()
    tr = _trainer()
    tr.trace_line()
    profiling.count_capture("first")
    profiling.count_capture("static")
    profiling.count_capture("static")
    profiling.count("warmup_steps", 2)
    profiling.count("replays", 24)
    for site, n, s in (("replay_queue", 3, 0.0), ("densify", 1, 0.02), ("any_rank", 2, 0.0)):
        for _ in range(n):
            with profiling.host_wait(site):
                time.sleep(s)
    line = tr.trace_line()
    assert line.startswith("ms/step - | captures=3 (first,staticx2) warmup_steps=2 "
                           "replays=24 bank_builds=0 | replay_queue=3/"), line
    syncs = re.search(r"\| syncs any_rank=2/(\S+)ms densify=1/(\S+)ms$", line)
    assert syncs and float(syncs.group(2)) >= 20.0, line
    assert tr.trace_line() == ("ms/step - | captures=0 warmup_steps=0 replays=0 bank_builds=0"
                               " | replay_queue=0 | syncs -")
    profiling.reset_counters()


def test_trace_line_prints_the_step_kernels_launches():
    """The launches since the last line of each kernel wrapper that
    launched follow the counters (on the CPU none launches, and the line is
    the one of before)."""
    profiling.reset_counters()
    tr = _trainer()
    tr.trace_line()
    tr.train_window(2)
    tr.train_iteration()
    assert " launches " not in tr.trace_line()
    for name, n in (("precull", 3), ("ssim_fwd", 2)):
        for _ in range(n):
            profiling.count_launch(name)
    line = tr.trace_line()
    assert " bank_builds=0 launches precull=3 ssim_fwd=2 | replay_queue=" in line, line
    assert profiling.counters()["launches"] == {"precull": 3, "ssim_fwd": 2}
    profiling.reset_counters()


def test_held_counts_are_taken_back_and_added_each_replay():
    """What a block counts under `held_counts` (launches and collectives
    alike) leaves the totals, and each `add_counts` adds it again, as a
    captured graph's capture and replays count."""
    profiling.reset_counters()
    profiling.count_launch("precull")
    with profiling.held_counts() as held:
        for name in ("precull", "ssim_fwd"):
            profiling.count_launch(name)
        profiling.count("collectives", 2)
        profiling.count("allreduce_bytes", 64)
    got = profiling.counters()
    assert got["launches"] == {"precull": 1}
    assert got["collectives"] == got["allreduce_bytes"] == 0
    assert dict(held) == {("launch", "precull"): 1, ("launch", "ssim_fwd"): 1,
                          ("count", "collectives"): 2, ("count", "allreduce_bytes"): 64}
    for _ in range(3):
        profiling.add_counts(held)
    got = profiling.counters()
    assert got["launches"] == {"precull": 4, "ssim_fwd": 3}
    assert (got["collectives"], got["allreduce_bytes"]) == (6, 192)
    profiling.reset_counters()


def test_collectives_count_on_a_mesh_only():
    """A single-device Trainer's window and event iteration run no
    collective: the counters stay 0 and the log line is the one of before;
    counted collectives print their count and MB a step by kind."""
    profiling.reset_counters()
    tr = _trainer()
    tr.trace_line()
    tr.train_window(2)
    tr.train_iteration()
    assert profiling.collective_counts() == dict.fromkeys(profiling.COLLECTIVE_NAMES, 0)
    assert "collectives" not in tr.trace_line()
    profiling.count("collectives", 22)
    profiling.count("allreduce_bytes", 3_000_000)
    tr.iteration += 2
    line = tr.trace_line()
    assert " bank_builds=0 collectives=22 allreduce=1.5MB/step | replay_queue=" in line, line
    profiling.reset_counters()


@pytest.mark.parametrize("field", ttrainer.CaptureKey._fields)
def test_capture_reason_names_the_changed_field(field):
    """Each field of the capture key that changes is the reason of the
    capture; no change and a key kept across `StepGraph.reserve`'s new
    buffers read as ``buffers``."""
    tr = _trainer()
    key = window_key(tr)
    changed = key._replace(**{field: ("changed",)})
    assert ttrainer.capture_reason(key, changed) == field
    assert ttrainer.capture_reason(None, changed) == "first"
    g = ttrainer.StepGraph()
    g.reserve("cpu", 2, 3)
    g.graph, g.key = object(), key
    g.reserve("cpu", 4, 3)  # a longer window: new buffers, no graph
    assert g.graph is None and g.key == key
    assert (ttrainer.capture_reason(g.key, key) or "buffers") == "buffers"


def test_counters_lose_no_update_across_threads():
    """Eight threads counting replays and host waits at once, switching
    every microsecond: the totals are exact."""
    import sys
    import threading

    profiling.reset_counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                profiling.count("replays")
                with profiling.host_wait("stress"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.counters()
    assert got["replays"] == 4000 and got["host_waits"] == {"stress": 4000}
    profiling.reset_counters()
