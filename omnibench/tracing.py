"""Reading a slice of a run under `torch.profiler`: the device's busy time
(the union of its ops' spans), the longest device ops, the longest idle
gaps by what the host was doing, and CUDA-event spans around a call."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from omnibench.harness import BUILD

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_DIR = BUILD / "trace"


def device_ops(events) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(events) -> float:
    """Microseconds of the union of the device ops' spans."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device_ops(events))
    busy, reached = 0.0, float("-inf")
    for a, b in spans:
        if b > reached:
            busy += b - max(a, reached)
            reached = b
    return busy


def op_seconds(events, patterns=None) -> Dict[str, float]:
    """Device seconds by op name; with ``patterns``, only the ops whose name
    contains one of them."""
    out: Dict[str, float] = defaultdict(float)
    for e in device_ops(events):
        if patterns is None or any(p in e["name"] for p in patterns):
            out[e["name"]] += float(e["dur"]) * 1e-6
    return dict(out)


def top_ops(events, n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(op_seconds(events).items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, n: int = 10) -> List[list]:
    """The ``n`` longest gaps between device ops, each named by the
    innermost host event (an op, a runtime call or an annotation) under
    way when the gap began, or else by the first one that began in it."""
    ops = sorted(device_ops(events), key=lambda e: float(e["ts"]))
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in
            ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")]
    gaps, reached = [], None
    for e in ops:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if reached is not None and a > reached:
            gaps.append((a - reached, reached))
        reached = b if reached is None else max(reached, b)
    gaps.sort(reverse=True)
    out = []
    for dur, at in gaps[:n]:
        under = [h for h in host if float(h["ts"]) <= at <= float(h["ts"]) + float(h["dur"])]
        later = [h for h in host if at < float(h["ts"]) < at + dur]
        if under:
            name = min(under, key=lambda h: float(h["dur"]))["name"]
        elif later:
            name = min(later, key=lambda h: float(h["ts"]))["name"]
        else:
            name = "host (no event)"
        out.append([name, dur * 1e-6])
    return out


def profile(fn: Callable[[], None], name: str, cpu: bool = False):
    """Run ``fn`` under a profiler recording CUDA activity (and host
    activity with ``cpu``); return (events, host seconds of the slice).
    The slice starts and ends with the card idle."""
    import torch
    from torch.profiler import ProfilerActivity

    card = torch.cuda.is_available()  # without one (a CPU rehearsal) host activity only
    acts = ([ProfilerActivity.CUDA] if card else []) + ([ProfilerActivity.CPU] if cpu or not card else [])

    def sync():
        if card:
            torch.cuda.synchronize()

    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        host_s = time.perf_counter() - t0
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return events, host_s


@contextlib.contextmanager
def event_spans(module, names, spans: Dict[str, list]):
    """Wrap ``module.<name>`` for each name so that each call records CUDA
    events at entry and exit; ``spans[name]`` gets the event pairs."""
    import torch

    if not torch.cuda.is_available():  # a CPU rehearsal records nothing
        yield spans
        return
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def inner(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans.setdefault(n, []).append((a, b))
            return out
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield spans
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def span_ms(spans: Dict[str, list]) -> Dict[str, List[float]]:
    import torch

    if not torch.cuda.is_available():
        return {}
    torch.cuda.synchronize()
    return {n: [a.elapsed_time(b) for a, b in pairs] for n, pairs in spans.items()}


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None

