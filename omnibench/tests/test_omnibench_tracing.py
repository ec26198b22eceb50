"""The union of device spans, the longest ops and gaps, and the roofline
arithmetic, on hand-made traces and counts."""

import pytest

from omnibench import harness, tracing
from omnibench.reference import counts


def k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    k("a", 0, 10), k("b", 5, 10),  # overlapping: 15 us of union
    k("copy", 30, 5, "gpu_memcpy"), k("a", 40, 10),
    k("host_op", 14, 20, "cpu_op"), k("launch", 36, 2, "cuda_runtime"),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
]


def test_busy_is_the_union_of_device_spans():
    assert tracing.busy_us(EVENTS) == 15 + 5 + 10
    assert tracing.busy_us([]) == 0.0


def test_op_seconds_and_top_ops():
    assert tracing.op_seconds(EVENTS) == pytest.approx({"a": 20e-6, "b": 10e-6, "copy": 5e-6})
    assert tracing.op_seconds(EVENTS, ("co",)) == pytest.approx({"copy": 5e-6})
    assert [n for n, _ in tracing.top_ops(EVENTS, 2)] == ["a", "b"]


def test_idle_gaps_are_named_by_the_host():
    gaps = tracing.idle_gaps(EVENTS)
    assert gaps[0] == ["host_op", pytest.approx(15e-6)]  # 15..30
    assert gaps[1] == ["launch", pytest.approx(5e-6)]  # 35..40


COUNTS = dict(instances=1.0e6, pairs=5.0e7, pixels=1920 * 960.0)


def test_floors_follow_the_arithmetic():
    ops = COUNTS["pairs"] * (30 + 56) / 67e12
    mem = COUNTS["instances"] * 224 / 3.35e12
    assert counts.step_floor_s(COUNTS) == pytest.approx(ops + mem)
    assert counts.forward_floor_s(COUNTS) == pytest.approx(
        max(COUNTS["pairs"] * 30 / 67e12, (36e6 + 16 * COUNTS["pixels"]) / 3.35e12))


@pytest.mark.parametrize("scale, expected_ok", [(1.0, True), (0.5, False)])
def test_composite_roofline_reads_at_most_100_when_the_time_is_whole(scale, expected_ok):
    """A kernel time no shorter than its floor reads <= 100%; half the
    floor (a count too high, or a time that leaves out work) reads 200%."""
    floor = counts.forward_floor_s(COUNTS) + counts.backward_floor_s(COUNTS)
    t_us = floor * scale * 1e6
    trace = {"kind": "train", "slice_iters": 1, "counts": COUNTS,
             "events": [k("composite_seg_fwd_kernel", 0, t_us / 2),
                        k("composite_seg_bwd_kernel", t_us, t_us / 2),
                        k("other_kernel", 0, 1e6)]}
    share = harness.metric_reader("composite_roofline.train")(trace)
    assert share == pytest.approx(100.0 / scale)
    assert (share <= 100.0 + 1e-9) is expected_ok


def test_mfu_and_idle_and_event_readers():
    floor = counts.step_floor_s(COUNTS)
    trace = {"kind": "train", "counts": COUNTS, "ms_per_iter_clean": floor * 1e3 * 50,
             "events": [k("x", 0, 250_000)], "slice_s": 1.0, "event_s": 0.2, "window_iters": 400}
    assert harness.metric_reader("train_mfu")(trace) == pytest.approx(2.0)
    assert harness.metric_reader("idle_share.train")(trace) == pytest.approx(75.0)
    assert harness.metric_reader("event_ms_per_iter.train")(trace) == pytest.approx(0.5)
    render = {"kind": "render", "span_ms": {"bin_instances_packed": [1.0, 3.0]}}
    assert harness.metric_reader("bin_ms.render")(render) == 2.0
    assert harness.metric_reader("preprocess_ms.render")(render) is None


def test_render_mfu_reads_the_request_floor_over_its_time():
    floor = counts.request_floor_s(COUNTS)
    trace = {"kind": "render", "counts": COUNTS, "ms_per_request": floor * 1e3 * 20}
    assert harness.metric_reader("render_mfu")(trace) == pytest.approx(5.0)
    assert counts.request_floor_s(COUNTS) == pytest.approx(
        COUNTS["pairs"] * 30 / 67e12 + COUNTS["instances"] * 112 / 3.35e12)
