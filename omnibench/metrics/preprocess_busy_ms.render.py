"""Device busy ms of a render request's ``preprocess`` stage (the
activations and `ops/preprocess`): the union of the device ops between
the port's ``stage_mark_preprocess`` and the next mark in the profiled
slice, over its requests."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "render", ("preprocess",), "slice_requests")
