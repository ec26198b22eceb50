"""Device ms of `ops/binning.bin_instances_packed` a render request: CUDA
events recorded at the entry and exit of each call (the benchmark wraps
the function where `ops/rasterize` calls it), mean over the span slice."""

from omnibench import tracing


def read(trace):
    if not trace or trace.get("kind") != "render":
        return None
    return tracing.mean(trace["span_ms"].get("bin_instances_packed", []))
