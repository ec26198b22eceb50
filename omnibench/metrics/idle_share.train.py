"""Share of the profiled slice of training iterations (graph windows) in
which the card ran no op: 1 - (union of the device ops' spans) / the
slice's host span, from a CUDA-only `torch.profiler` trace."""

from omnibench import tracing


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    return 100.0 * (1.0 - tracing.busy_us(trace["events"]) * 1e-6 / trace["slice_s"])
