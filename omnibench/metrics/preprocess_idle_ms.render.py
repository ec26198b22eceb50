"""Ms a render request's ``preprocess`` stage leaves the card idle: the
interval from the port's ``stage_mark_preprocess`` to the next mark, less
the device ops' busy time inside it (the host's lag inside the stage),
over the profiled slice's requests."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.idle_ms(trace, "render", "preprocess", "slice_requests")
