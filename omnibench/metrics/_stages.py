"""The port's stage marks in a CUDA-only trace: each ``stage_mark_<stage>``
kernel opens its stage and closes the one before; ``stage_mark_end``
closes the last and opens none. A stage's interval runs from its mark to
the next mark; its busy time is the union of the other device ops' spans
inside the interval. Shared by the ``*_busy_ms`` and ``*_idle_ms``
readers; a trace without marks (a program without them) reads None."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from omnibench import tracing

MARK = "stage_mark_"


def intervals(events) -> List[Tuple[str, float, float]]:
    """(stage, start us, end us) of every marked interval, in trace order
    (the intervals after an ``end`` mark belong to no stage)."""
    marks = sorted((float(e["ts"]), e["name"][len(MARK):]) for e in tracing.device_ops(events)
                   if e["name"].startswith(MARK))
    return [(s, a, b) for (a, s), (b, _) in zip(marks, marks[1:]) if s != "end"]


def _union(events) -> Tuple[List[float], List[float], List[float]]:
    """The union of the non-mark device ops' spans as sorted disjoint
    segments (starts, ends) and the running busy time before each."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in tracing.device_ops(events) if not e["name"].startswith(MARK))
    starts: List[float] = []
    ends: List[float] = []
    for a, b in spans:
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    before = [0.0]
    for a, b in zip(starts, ends):
        before.append(before[-1] + b - a)
    return starts, ends, before


def _busy_before(t: float, starts, ends, before) -> float:
    """Busy microseconds of the union before time ``t``."""
    i = bisect.bisect_right(starts, t)  # segments starting at or before t
    if i == 0:
        return 0.0
    return before[i - 1] + min(ends[i - 1], t) - starts[i - 1]


def stage_us(events) -> Optional[Dict[str, Tuple[float, float]]]:
    """stage → (interval us, busy us), summed over the trace's intervals of
    that stage; None without marks."""
    spans = intervals(events)
    if not spans:
        return None
    union = _union(events)
    out: Dict[str, Tuple[float, float]] = {}
    for s, a, b in spans:
        busy = _busy_before(b, *union) - _busy_before(a, *union)
        span0, busy0 = out.get(s, (0.0, 0.0))
        out[s] = (span0 + b - a, busy0 + busy)
    return out


def busy_ms(trace, kind: str, stages, per: str) -> Optional[float]:
    """The busy ms of ``stages`` summed, per ``trace[per]`` (iterations or
    requests of the slice), in a ``kind`` trace; None without marks."""
    if not trace or trace.get("kind") != kind:
        return None
    got = stage_us(trace["events"])
    if got is None:
        return None
    return sum(got.get(s, (0.0, 0.0))[1] for s in stages) * 1e-3 / trace[per]


def idle_ms(trace, kind: str, stage: str, per: str) -> Optional[float]:
    """``stage``'s interval less its busy time, in ms per ``trace[per]``."""
    if not trace or trace.get("kind") != kind:
        return None
    got = stage_us(trace["events"])
    if got is None or stage not in got:
        return None
    span, busy = got[stage]
    return (span - busy) * 1e-3 / trace[per]


def program_totals() -> Optional[Dict[str, Tuple[float, int]]]:
    """The program's own stage totals (stage → (ms, entries)) after the
    run, or None where the program has no marks."""
    from omnigs_torch.utils import profiling

    totals = getattr(profiling, "stage_totals", None)
    return None if totals is None else totals()


def program_counters() -> Optional[dict]:
    """The program's run-wide counters, or None where it has none."""
    from omnigs_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    return None if counters is None else counters()
