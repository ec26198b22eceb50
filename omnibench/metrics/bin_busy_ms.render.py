"""Device busy ms of a render request's ``bin`` stage
(`bin_instances_packed`, the call that `bin_ms.render` brackets from
outside), from the port's stage marks in the profiled slice."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "render", ("bin",), "slice_requests")
