"""CUDA-graph captures of the training step over the whole run, set-up's
included: the program's run-wide counter (`profiling.counters`)."""

from omnibench.metrics import _stages


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    counters = _stages.program_counters()
    return None if counters is None else counters["captures"]
