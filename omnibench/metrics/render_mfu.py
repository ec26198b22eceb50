"""The whole render request's share of the card's float32 and memory
peaks: the least time of its compositing work (the reference's counts of
contributing pairs and culled instances at the profiled slice's poses, at
30 float32 operations a pair and 112 bytes an instance, summed) over the
host-clock time a request takes in the window (window seconds over
requests)."""

from omnibench.reference import counts


def read(trace):
    if not trace or trace.get("kind") != "render" or not trace.get("ms_per_request"):
        return None
    return 100.0 * counts.request_floor_s(trace["counts"]) / (trace["ms_per_request"] * 1e-3)
