"""Step timing and device memory accounting.

Counterpart of the first half of `omnigs_tpu/utils/profiling.py`:

* `step_timer` — host wall-clock spans, bracketed by a device synchronise
  when the device is a CUDA card (PyTorch returns before the card
  finishes, so an unsynchronised span measures the enqueue).
* `device_peak_memory_mb` / `PeakMemoryTracker` — peak and current device
  memory from `torch.cuda`'s allocator statistics. A CPU device has none:
  the dict is empty.
"""

from __future__ import annotations

import contextlib
import time
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
