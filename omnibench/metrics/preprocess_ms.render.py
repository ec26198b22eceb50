"""Device ms of `ops/preprocess.preprocess` a render request: CUDA events
at the entry and exit of each call (wrapped where `ops/rasterize` calls
it), mean over the span slice."""

from omnibench import tracing


def read(trace):
    if not trace or trace.get("kind") != "render":
        return None
    return tracing.mean(trace["span_ms"].get("preprocess", []))
