"""Stage marks, run-wide counters, step timing and device memory accounting.

Counterpart of the first half of `omnigs_tpu/utils/profiling.py`, with the
port's own tracing:

* `mark` — a stage mark inside the work. ``mark(stage, t)`` opens
  ``stage`` (one of `STAGES`) and closes the stage open before it; the
  mark of ``"end"`` closes the last one and opens none. On a CUDA device
  it launches the one-thread kernel ``stage_mark_<stage>``
  (`csrc/stage_marks.cu`) on the current stream, so the mark also runs
  inside a captured CUDA graph, where it is part of every replay: a
  profiler's device trace finds each boundary by the kernel's name, on
  the trace's clock, and the kernel adds the card's ``%globaltimer``
  nanoseconds since the previous mark into the closed stage's slot of the
  device's mark table, with one entry. The table is allocated once per
  device (`mark_table`, never inside a capture) and never moves. On a CPU
  tensor the mark writes ``time.perf_counter_ns()`` into the host's
  table of the same layout. Under a profiler that records host activity
  each mark also opens a host range of the kernel's name (closed by the
  next mark), so host and device traces carry the same names on one
  clock. `set_marks` (on by default) turns every mark off; a captured
  step's key (`train.trainer.capture_key`) holds the switch, so turning
  it over captures the step again. `stage_totals` reads a table (a CUDA
  table's read waits for its stream: the trainer reads it only where it
  already synchronises, `Trainer.drain_losses`); `reset_marks` zeroes
  them. Measured on an H100 (PERF.md): a mark kernel holds the card
  ~1.6 µs (19 µs a captured training step of 12 marks, 8 µs a render of
  5) and an eager mark ~15 µs of host time. With the marks on against
  off, two graphs of one process in turns: +0.07% ms an iteration;
  render requests in turns: +0.5% to +1.1% ms a request. The first mark
  of a process loads the marks' library (4–9 ms); the first process of a
  checkout builds it first (~3.2 s of nvcc).
* `counters` — run-wide totals since `reset_counters`: graph captures,
  each with its reason (the field of the capture key that changed),
  warm-up steps and replays of the captured steps, ground-truth bank
  builds, the mesh's collectives and the bytes each kind hands them
  (`parallel/mesh.py`), each hand-written kernel's launches by wrapper
  (`count_launch`), and the host's waits at the known sync points (count
  and host ms by site, each wait timed by `host_wait`). A captured graph
  counts nothing at its capture and, at each replay, what its capture
  counted (`held_counts`, `add_counts`).
* `mean_ms` — the mean time of repeated calls: CUDA events on a card
  (device time of back-to-back calls), the host clock on the CPU;
  `stage_ms` adds what the events measured: the card's time, or the
  host's launch gaps or waits too, and then `device_busy_ms`, the card's
  busy time from a profiler that records CUDA activity only.
* `device_peak_memory_mb` / `PeakMemoryTracker` — peak and current device
  memory from `torch.cuda`'s allocator statistics. A CPU device has none:
  the dict is empty.
* `write_peak_memory` — those statistics as `DevicePeakUsageMB.txt`, the
  file of the JAX package's training CLI (the reference's
  `GpuPeakUsageMB.txt`).
* `trace` — a `torch.profiler` capture of a block (host and, on a card,
  device activity) written as a Chrome trace.
* `roofline_report` — pixels/s of a full forward + backward step against
  the floor of an H100 for the same work (the JAX function with the card's
  peaks and the port's per-pair operation and per-instance byte counts,
  which the kernel bounds of `chip_smoke.py` share).
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

# the stage table, in a training step's order; csrc/stage_marks.cu lists
# the same names in the same order (one kernel each)
STAGES = (
    "window",  # a captured step's row gather and output writes
    "preprocess",  # the activations and ops/preprocess
    "bin",  # ops/binning (bin_instances_packed and the other layouts)
    "relay",  # segment_relay and the slab build
    "composite_fwd",  # the forward kernel and _tiles_to_image
    "loss",  # L1 + SSIM, forward and, in autograd's order, backward
    "composite_bwd",  # the compositor's backward and the row reduction
    "preprocess_bwd",  # the rest of autograd: back through preprocess
    "allreduce",  # a sharded step's loss, gradient and statistics all-reduces
    "adam",  # densification statistics, group_lrs, adam_step
    "densify",  # densify_and_prune
    "reset",  # reset_opacity
    "end",  # closes the open stage, opens none
)
_INDEX = {s: i for i, s in enumerate(STAGES)}
_END = _INDEX["end"]
# a mark table (int64): the last mark's clock (ns), the open stage + 1 (0:
# none), each stage's nanoseconds, each stage's closed entries
_CLOCK, _OPEN, _NS = 0, 1, 2
_ENTRIES = _NS + len(STAGES)
TABLE_LEN = _ENTRIES + len(STAGES)


class _Marks:
    """The marks' process-wide state: the switch, each CUDA device's table,
    the host's table, the open host range and the kernel's launcher."""

    def __init__(self):
        self.on = True
        self.tables: Dict[torch.device, torch.Tensor] = {}
        self.host = [0] * TABLE_LEN
        self.host_range = None
        self.launch = None
        self.lock = threading.Lock()


_MARKS = _Marks()


def set_marks(on: bool) -> None:
    """Turn every stage mark on (the default) or off."""
    _MARKS.on = bool(on)


def marks_on() -> bool:
    return _MARKS.on


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def mark_table(device) -> torch.Tensor:
    """The (TABLE_LEN,) int64 mark table of a CUDA ``device``, allocated
    zeroed at its first use, which must not be inside a graph capture (a
    captured graph bakes in the table's address)."""
    device = _cuda_device(device)
    table = _MARKS.tables.get(device)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the mark table of {device} is allocated inside a graph capture: "
                "mark once before capturing"
            )
        table = _MARKS.tables[device] = torch.zeros(TABLE_LEN, dtype=torch.int64, device=device)
    return table


def _host_range(stage: int) -> None:
    """Close the open host range and open the stage's (none at ``end``)."""
    from torch.autograd.profiler import record_function

    with _MARKS.lock:
        prev, _MARKS.host_range = _MARKS.host_range, None
        if stage != _END:
            _MARKS.host_range = record_function(f"stage_mark_{STAGES[stage]}")
    if prev is not None:
        prev.__exit__(None, None, None)
    if _MARKS.host_range is not None:
        _MARKS.host_range.__enter__()


def mark(stage: str, where) -> None:
    """Open ``stage`` and close the stage open before it (``"end"``: close
    it and open none) on the device of ``where`` (a tensor or a device): a
    ``stage_mark_<stage>`` kernel on the current stream of a CUDA device,
    the host clock into the host's table otherwise. Nothing while the
    marks are off."""
    if not _MARKS.on:
        return
    i = _INDEX[stage]
    device = where.device if torch.is_tensor(where) else torch.device(where)
    if torch.autograd._profiler_enabled():
        _host_range(i)
    if device.type != "cuda":
        now = time.perf_counter_ns()
        with _MARKS.lock:  # the kernel's update, on the host's table
            t = _MARKS.host
            if t[_OPEN]:
                t[_NS + t[_OPEN] - 1] += now - t[_CLOCK]
                t[_ENTRIES + t[_OPEN] - 1] += 1
            t[_CLOCK] = now
            t[_OPEN] = 0 if i == _END else i + 1
        return
    device = _cuda_device(device)
    table = mark_table(device)
    if _MARKS.launch is None:
        import ctypes

        from omnigs_torch import cuda_build

        _MARKS.launch = cuda_build.launcher(
            "stage_marks", "stage_mark",
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
        )
    lib, fn = _MARKS.launch
    err = fn(i, table.data_ptr(), device.index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        from omnigs_torch import cuda_build

        cuda_build.check(lib, err, f"stage mark {stage}")


def stage_totals(device=None) -> Dict[str, Tuple[float, int]]:
    """stage → (milliseconds, closed entries) of the marks since the last
    `reset_marks`, from ``device``'s table (a CUDA table's read waits for
    its stream), or summed over every table (the host's and each card's)
    without one."""
    if device is not None and torch.device(device).type == "cuda":
        table = _MARKS.tables.get(_cuda_device(device))
        rows = [] if table is None else [table.tolist()]
    elif device is not None:
        with _MARKS.lock:
            rows = [list(_MARKS.host)]
    else:
        with _MARKS.lock:
            rows = [list(_MARKS.host)]
        rows += [t.tolist() for t in _MARKS.tables.values()]
    summed = [sum(r[j] for r in rows) for j in range(TABLE_LEN)]
    return {s: (summed[_NS + i] * 1e-6, int(summed[_ENTRIES + i]))
            for i, s in enumerate(STAGES) if s != "end"}


def reset_marks() -> None:
    """Zero every mark table (none may be capturing)."""
    with _MARKS.lock:
        _MARKS.host[:] = [0] * TABLE_LEN
    for t in _MARKS.tables.values():
        t.zero_()


class _Counters:
    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.totals = collections.Counter()
        self.by_kernel = collections.Counter()
        self.capture_reasons = collections.Counter()
        self.waits = collections.Counter()
        self.wait_s = collections.Counter()


_COUNTERS = _Counters()
# the run-wide totals `counters` reports, all 0 after `reset_counters`
COUNTER_NAMES = ("captures", "warmup_steps", "replays", "bank_builds")
# the mesh's collectives that ran (a dim of one rank runs none) and the
# bytes of the tensors each kind was handed on this rank
COLLECTIVE_NAMES = ("collectives", "allreduce_bytes", "gather_bytes", "scatter_bytes")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the run-wide counter ``name`` (one of COUNTER_NAMES or
    COLLECTIVE_NAMES)."""
    if name not in COUNTER_NAMES and name not in COLLECTIVE_NAMES:
        raise KeyError(name)
    with _COUNTERS.lock:
        _COUNTERS.totals[name] += n


def count_launch(wrapper: str) -> None:
    """One launch of the hand-written kernel behind ``wrapper`` (the
    wrapper's name), counted where the wrapper launches it."""
    with _COUNTERS.lock:
        _COUNTERS.by_kernel[wrapper] += 1


def _table() -> collections.Counter:
    """Every total of `count` and `count_launch`, by (kind, name)."""
    table = collections.Counter({("count", k): v for k, v in _COUNTERS.totals.items()})
    table.update({("launch", k): v for k, v in _COUNTERS.by_kernel.items()})
    return table


def add_counts(counts) -> None:
    """Add ``counts`` ((kind, name) → n, as `held_counts` yields them) to
    the totals: a captured graph's replay counts what its capture held."""
    with _COUNTERS.lock:
        for (kind, name), n in counts.items():
            (_COUNTERS.totals if kind == "count" else _COUNTERS.by_kernel)[name] += n


@contextlib.contextmanager
def held_counts():
    """Count nothing of the enclosed block (a graph's capture, which runs
    no work): yields a Counter that, after the block, holds what the block
    counted with `count` and `count_launch`, by (kind, name), and takes it
    back out of the totals, for `add_counts` to add at each replay."""
    with _COUNTERS.lock:
        before = _table()
    held = collections.Counter()
    try:
        yield held
    finally:
        with _COUNTERS.lock:
            held.update(_table() - before)
        add_counts({k: -n for k, n in held.items()})


def count_capture(reason: str) -> None:
    """One graph capture, for ``reason``: the fields of the capture key
    that changed ("first" without an earlier key)."""
    with _COUNTERS.lock:
        _COUNTERS.totals["captures"] += 1
        _COUNTERS.capture_reasons[reason] += 1


@contextlib.contextmanager
def host_wait(site: str):
    """Count the enclosed block as one host wait at ``site``, with its host
    time (under a profiler recording host activity, a ``host_wait.<site>``
    range)."""
    rf = None
    if torch.autograd._profiler_enabled():
        from torch.autograd.profiler import record_function

        rf = record_function(f"host_wait.{site}")
        rf.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        with _COUNTERS.lock:
            _COUNTERS.waits[site] += 1
            _COUNTERS.wait_s[site] += dt


def collective_counts() -> Dict[str, int]:
    """The run-wide totals of COLLECTIVE_NAMES."""
    with _COUNTERS.lock:
        return {k: _COUNTERS.totals[k] for k in COLLECTIVE_NAMES}


def counters() -> dict:
    """Run-wide totals since `reset_counters`: each of COUNTER_NAMES and
    COLLECTIVE_NAMES, ``capture_reasons`` (reason → captures),
    ``launches`` (kernel wrapper → launches), ``host_waits`` (site →
    waits) and ``host_wait_ms`` (site → host ms)."""
    with _COUNTERS.lock:
        out = {k: _COUNTERS.totals[k] for k in COUNTER_NAMES + COLLECTIVE_NAMES}
        out["capture_reasons"] = dict(_COUNTERS.capture_reasons)
        out["launches"] = {k: v for k, v in _COUNTERS.by_kernel.items() if v}
        out["host_waits"] = dict(_COUNTERS.waits)
        out["host_wait_ms"] = {k: v * 1e3 for k, v in _COUNTERS.wait_s.items()}
    return out


def reset_counters() -> None:
    with _COUNTERS.lock:
        _COUNTERS.reset()


# cycles the card sleeps before a timed run (~5 ms): the host enqueues the
# warm-up and timed calls meanwhile, so that calls shorter than their own
# launch overhead still run back to back on the device
QUEUE_AHEAD_CYCLES = 10_000_000
# the host clock's milliseconds that QUEUE_AHEAD_CYCLES hold the card for,
# at the H100's ~2 GHz; `stage_ms` scales its second hold from it
QUEUE_AHEAD_MS = 5.0
# the largest multiple of QUEUE_AHEAD_CYCLES that `stage_ms` holds for (~1 s)
QUEUE_AHEAD_MAX = 200


def _event_ms(fn, device, reps: int, warmup: int, cycles: int):
    """CUDA-event mean milliseconds of ``fn()`` over ``reps`` calls after
    ``warmup``, the stream first held busy for ``cycles`` → (ms, host ms
    to enqueue the warm-up and timed calls, queued): ``queued`` when the
    card had not reached the timed calls once the host had enqueued them
    all, so that the card never waited for the host between the events."""
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps, host_ms, queued


def mean_ms(fn, device, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after ``warmup``:
    CUDA events around the calls on a CUDA ``device``, the host clock
    otherwise. On a card the stream is first held busy (``torch.cuda._sleep``)
    while the host enqueues every call, so the events measure the calls'
    device time without the host's launch gaps, as long as the host
    enqueues them within that time (`stage_ms` checks that it did)."""
    if torch.device(device).type != "cuda":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    return _event_ms(fn, device, reps, warmup, QUEUE_AHEAD_CYCLES)[0]


def stage_ms(fn, device, reps: int = 20, warmup: int = 2):
    """(mean milliseconds of ``fn()`` over ``reps`` calls after ``warmup``,
    what they measure, the card's busy milliseconds a call or None) on a
    CUDA ``device``, as `mean_ms` times them:

    * ``"device"``: the card had not reached the timed calls when the host
      had enqueued them all, so the events read the card's time alone;
    * ``"launch"``: the card reached them earlier, so the events may hold
      the host's launch gaps, even after a second, longer hold of the
      stream sized from the first run's enqueue time; the third value is
      then `device_busy_ms` of the same calls, which holds none;
    * ``"host"``: a call makes the host wait for the card (PyTorch's sync
      debug mode warns at every such wait): the calls cannot queue ahead
      and the events hold the host's gaps. Always so on any other device,
      where the host clock times the calls."""
    if torch.device(device).type != "cuda":
        return mean_ms(fn, device, reps=reps, warmup=warmup), "host", None
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if any("synchroniz" in str(w.message) for w in caught):
        return mean_ms(fn, device, reps=reps, warmup=warmup), "host", None
    ms, host_ms, queued = _event_ms(fn, device, reps, warmup, QUEUE_AHEAD_CYCLES)
    if not queued:
        scale = min(QUEUE_AHEAD_MAX, math.ceil(2.0 * host_ms / QUEUE_AHEAD_MS))
        ms, _, queued = _event_ms(fn, device, reps, warmup, QUEUE_AHEAD_CYCLES * scale)
    if queued:
        return ms, "device", None
    return ms, "launch", device_busy_ms(fn, device, reps=reps, warmup=warmup)


def device_busy_ms(fn, device, reps: int = 20, warmup: int = 2) -> float:
    """Milliseconds a call of ``fn()`` keeps a CUDA ``device`` busy: the
    union of the device ops' spans (kernels, copies, fills) in a Chrome
    trace of ``reps`` calls after ``warmup`` under a profiler that records
    CUDA activity only, over ``reps``. The host's gaps between the ops do
    not count. The trace is written to `TRACE_DIR`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "device_busy.json"
    prof.export_chrome_trace(str(path))
    return device_busy_us(json.loads(path.read_text())["traceEvents"]) / 1e3 / reps


def device_busy_us(events) -> float:
    """Microseconds of the union of the device ops' spans (kernels, copies,
    fills) among the events of a Chrome trace."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, reached = 0.0, float("-inf")
    for a, b in spans:
        if b > reached:
            busy_us += b - max(a, reached)
            reached = b
    return busy_us


def device_peak_memory_mb(device: Optional[torch.device] = None) -> Dict[str, float]:
    """Peak / current / limit device memory in MB of a CUDA device
    (``torch.cuda.max_memory_allocated``, ``memory_allocated``,
    ``mem_get_info``); ``{}`` for any other device."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    scale = 1.0 / (1024 * 1024)
    return {
        "peak_mb": torch.cuda.max_memory_allocated(device) * scale,
        "current_mb": torch.cuda.memory_allocated(device) * scale,
        "limit_mb": torch.cuda.mem_get_info(device)[1] * scale,
    }


class PeakMemoryTracker:
    """Running maximum of the device-memory statistics across explicit
    sample points (the trainer samples at every densify and opacity reset,
    where the densification temporaries peak)."""

    def __init__(self, device=None):
        self.device = device
        self.peak: Dict[str, float] = {}
        self.samples = 0

    def sample(self) -> Dict[str, float]:
        stats = device_peak_memory_mb(self.device)
        for k, v in stats.items():
            self.peak[k] = max(self.peak.get(k, 0.0), v)
        self.samples += 1
        return stats


def write_peak_memory(result_dir: Path, tracker: Optional[PeakMemoryTracker] = None) -> None:
    """Write ``DevicePeakUsageMB.txt`` into ``result_dir``: one ``<stat>
    <MB>`` line per statistic of the final snapshot of the tracker's device
    (the current CUDA device without one) and, with a ``tracker``, one
    ``<stat>_peak`` line per across-run maximum (the final snapshot folded
    in). A device without allocator statistics gets one ``unavailable``
    line naming it, never an empty file."""
    device = tracker.device if tracker is not None else None
    stats = device_peak_memory_mb(device)
    lines = [f"{k} {v:.1f}" for k, v in stats.items()]
    if tracker is not None and tracker.samples:
        for k, v in stats.items():
            tracker.peak[k] = max(tracker.peak.get(k, 0.0), v)
        lines += [
            f"{k}_peak {v:.1f}  (max of {tracker.samples} samples at "
            "densify/reset boundaries + final)"
            for k, v in tracker.peak.items()
        ]
    if not lines:
        lines = [f"unavailable: no memory stats on backend {torch.device(device or 'cpu')}"]
    (Path(result_dir) / "DevicePeakUsageMB.txt").write_text("\n".join(lines) + "\n")


# the checkout's directory for traces
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "omnigs_trace"


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the enclosed block with `torch.profiler` (CPU activity, and
    CUDA activity when a card is present) and write it as a Chrome trace,
    ``log_dir/trace.json`` (``build/omnigs_trace`` of the checkout by
    default; open it in chrome://tracing or Perfetto: device kernels are
    the events of category ``kernel``). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if log_dir is None:
        log_dir = TRACE_DIR
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(out / "trace.json"))


# NVIDIA H100 SXM published peaks (dense): float32 outside the tensor cores,
# HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per pixel-instance pair in the forward kernel: every
# visited pair (dx, dy, quadratic form, clamp, exp, opacity, clamp, two
# tests) and every live pair on top (log1p, exp of the log-T, test, weight,
# 3 color multiply-adds, 2 log sums); a transcendental counts as one
OPS_PER_VISITED_PAIR = 17
OPS_PER_LIVE_PAIR = 13
# the backward kernel: the forward's 17 per visited pair; per live
# (contributing) pair log1p, exp, the stop test (3), weight, u (5), the w·u
# prefix (2), dL·B, dL/dα (3, one division), V, the nine partials (10) and
# the log-T sum = 30, plus ~9 adds of the nine pixel reductions = 39; per
# instance the eight warp partials of nine rows (63 adds) and the row
# combination (9)
BWD_OPS_PER_LIVE_PAIR = 39
BWD_OPS_PER_INSTANCE = 72
# the tile-major forward: one integer move per composited pair for n_contrib
TILE_NC_OPS_PER_LIVE_PAIR = 1
# the fused backward: nine atomic adds per instance
FUSED_OPS_PER_INSTANCE = 9

# The roofline charges every pair of a tile's instances and pixels as
# visited and live (the kernel bounds count both from the data; a pair
# that is visited but not live, or never visited, makes the floor lower
# there): forward 17 + 13, backward 17 + 39 per pair.
INTRINSIC_OPS_PER_PAIR_FWD = OPS_PER_VISITED_PAIR + OPS_PER_LIVE_PAIR
INTRINSIC_OPS_PER_PAIR_BWD = OPS_PER_VISITED_PAIR + BWD_OPS_PER_LIVE_PAIR
INTRINSIC_OPS_PER_PAIR_FWDBWD = INTRINSIC_OPS_PER_PAIR_FWD + INTRINSIC_OPS_PER_PAIR_BWD
# Device memory traffic per composited instance across one forward +
# backward step, each byte counted once where it must move: the slab build
# reads the instance's id and writes its nine f32 rows (x, y, A, B, C,
# opacity, r, g, b: 4 + 36); the forward reads the nine rows (36); the
# backward reads them and writes nine f32 gradient rows (36 + 36); the
# reduction reads the gradient rows and the id (36 + 4); binning writes the
# packed int64 sort key, the sort reads it and writes it sorted, the relay
# reads it and writes the slab's int32 id (8 + 8 + 8 + 8 + 4):
# 40 + 36 + 72 + 40 + 36 = 224 B.
BYTES_PER_INSTANCE_FWDBWD = 224.0
PIXELS_PER_TILE = 256


def roofline_report(
    pixels: int,
    seconds: float,
    mean_instances_per_tile: float,
    num_instances: Optional[int] = None,
) -> Dict[str, float]:
    """Measured pixels/s of a full forward + backward step of ``seconds``
    against the floor of the card for its work, summed over the two limits
    (the stages are serial), as `omnigs_tpu.utils.profiling.roofline_report`
    does with a TPU's:

      ops_s = pixels · depth · INTRINSIC_OPS_PER_PAIR_FWDBWD / PEAK_F32_FLOPS
      mem_s = num_instances · BYTES_PER_INSTANCE_FWDBWD / PEAK_BYTES_PER_S

    ``depth`` = mean composited instances per tile = pairs per pixel;
    ``num_instances`` defaults to pixels · depth / 256 (pixels per tile).
    Returns ``achieved_px_s``, ``roofline_px_s`` and
    ``fraction_of_roofline`` (≤ 1 unless the counts are wrong)."""
    depth = mean_instances_per_tile
    ops_s = pixels * depth * INTRINSIC_OPS_PER_PAIR_FWDBWD / PEAK_F32_FLOPS
    if num_instances is None:
        num_instances = pixels * depth / PIXELS_PER_TILE
    mem_s = num_instances * BYTES_PER_INSTANCE_FWDBWD / PEAK_BYTES_PER_S
    achieved = pixels / seconds
    bound = pixels / (ops_s + mem_s)
    return {
        "achieved_px_s": achieved,
        "roofline_px_s": bound,
        "fraction_of_roofline": achieved / bound,
    }
