"""Step timing and device memory accounting.

Counterpart of the first half of `omnigs_tpu/utils/profiling.py`:

* `step_timer` — host wall-clock spans, bracketed by a device synchronise
  when the device is a CUDA card (PyTorch returns before the card
  finishes, so an unsynchronised span measures the enqueue).
* `mean_ms` — the mean time of repeated calls: CUDA events on a card
  (device time of back-to-back calls), the host clock on the CPU.
* `device_peak_memory_mb` / `PeakMemoryTracker` — peak and current device
  memory from `torch.cuda`'s allocator statistics. A CPU device has none:
  the dict is empty.
* `write_peak_memory` — those statistics as `DevicePeakUsageMB.txt`, the
  file of the JAX package's training CLI (the reference's
  `GpuPeakUsageMB.txt`).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def step_timer(results: Dict[str, float], key: str, device=None):
    """``with step_timer(d, "render", device): ...`` stores the span's
    milliseconds in ``d["render"]``."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    results[key] = (time.perf_counter() - t0) * 1000.0


# cycles the card sleeps before a timed run (~5 ms): the host enqueues the
# warm-up and timed calls meanwhile, so that calls shorter than their own
# launch overhead still run back to back on the device
QUEUE_AHEAD_CYCLES = 10_000_000


def mean_ms(fn, device, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after ``warmup``:
    CUDA events around the calls on a CUDA ``device``, the host clock
    otherwise. On a card the stream is first held busy (``torch.cuda._sleep``)
    while the host enqueues every call, so the events measure the calls'
    device time without the host's launch gaps, as long as the host
    enqueues them within that time."""
    if torch.device(device).type != "cuda":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


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
