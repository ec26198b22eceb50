"""The benchmark's stage readers (omnibench/metrics/_stages.py and the
``*_busy_ms.*``, ``*_idle_ms.*``, ``densify_ms.train`` and
``graph_captures.train`` readers) on hand-made traces, and the two that
read the port's own mark table and counters after a run."""

import time

import pytest

from omnibench import harness
from omnibench.metrics import _stages
from omnigs_torch.utils import profiling


def _k(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _mark(stage, ts):
    return _k(f"stage_mark_{stage}", ts, 1)


def _read(name, trace):
    return harness.metric_reader(name)(trace)


TRAIN = [  # two steps: window 0..10, preprocess 10..40, bin 40..50, relay 50..60, ...
    *(m for it in (0, 1000) for m in (
        _mark("window", it), _mark("preprocess", it + 10), _mark("bin", it + 40),
        _mark("relay", it + 50), _mark("composite_fwd", it + 60), _mark("end", it + 65),
        _mark("loss", it + 70),
        _mark("composite_bwd", it + 80), _mark("preprocess_bwd", it + 90),
        _mark("adam", it + 200), _mark("window", it + 300), _mark("end", it + 310))),
    # preprocess: two overlapping ops (12..22 ∪ 15..30 = 18 us) of 30 us
    _k("a", 12, 10), _k("b", 15, 15), _k("a", 1012, 10), _k("b", 1015, 15),
    # an op across the bin / relay boundary counts in both, clipped
    _k("c", 45, 10), _k("c", 1045, 10),
    _k("d", 95, 100), _k("d", 1095, 100),  # preprocess_bwd
    _k("e", 210, 50), _k("e", 1210, 50),  # adam
    _k("f", 500, 100),  # between iterations: no stage
    _k("g", 66, 2),  # after the render's end, before the loss: no stage
]


@pytest.mark.parametrize("name, expected", [
    ("preprocess_busy_ms.train", 18e-3),
    ("bin_busy_ms.train", 10e-3),
    ("backward_busy_ms.train", 100e-3),
    ("adam_busy_ms.train", 50e-3),
    ("loss_busy_ms.train", 0.0),
])
def test_train_stage_readers_take_the_busy_union_in_each_interval(name, expected):
    trace = {"kind": "train", "events": TRAIN, "slice_iters": 2}
    assert _read(name, trace) == pytest.approx(expected)


def test_stage_readers_read_intervals_idle_and_none_without_marks():
    got = _stages.stage_us(TRAIN)
    assert got["preprocess"] == (pytest.approx(60.0), pytest.approx(36.0))
    assert got["window"][0] == pytest.approx(40.0)  # 0..10 and 300..310, twice
    assert "end" not in got
    # the render's end closes composite_fwd; the op before the loss is no stage's
    assert got["composite_fwd"] == (pytest.approx(10.0), pytest.approx(0.0))
    render = {"kind": "render", "slice_requests": 2, "events": TRAIN}
    assert _read("preprocess_busy_ms.render", render) == pytest.approx(18e-3)
    assert _read("bin_busy_ms.render", render) == pytest.approx(5e-3)
    assert _read("preprocess_idle_ms.render", render) == pytest.approx(12e-3)
    bare = [e for e in TRAIN if not e["name"].startswith("stage_mark_")]
    for name in ("preprocess_busy_ms.train", "bin_busy_ms.train", "preprocess_idle_ms.render"):
        kind = "render" if name.endswith("render") else "train"
        assert _read(name, {"kind": kind, "events": bare, "slice_iters": 2,
                            "slice_requests": 2}) is None
        assert _read(name, {"kind": "other", "events": TRAIN}) is None
        assert _read(name, None) is None


def test_program_readers_read_the_mark_table_and_counters():
    """densify_ms.train: the host table's densify ms over its entries;
    graph_captures.train: the run-wide capture count."""
    profiling.reset_marks()
    profiling.reset_counters()
    t = {"kind": "train"}
    assert _read("densify_ms.train", t) is None  # no densify entry
    for _ in range(2):
        profiling.mark("densify", "cpu")
        time.sleep(0.01)
        profiling.mark("end", "cpu")
    ms, n = profiling.stage_totals()["densify"]
    assert n == 2 and ms >= 20.0
    assert _read("densify_ms.train", t) == pytest.approx(ms / 2)
    profiling.count_capture("first")
    assert _read("graph_captures.train", t) == 1
    assert _read("graph_captures.train", {"kind": "render"}) is None
    profiling.reset_marks()
