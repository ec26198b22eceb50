"""Kernel #1 (the segmented forward compositing kernel) against its floor:
its device time a request over the profiled slice, by kernel name, against
the larger of its operations at the float32 peak and its bytes at the
memory peak, for the contributing pairs and culled instances the
reference counts at the slice's own poses."""

from omnibench import tracing
from omnibench.reference import counts

KERNELS = ("composite_seg_fwd_kernel",)


def read(trace):
    if not trace or trace.get("kind") != "render":
        return None
    s = sum(tracing.op_seconds(trace["events"], KERNELS).values()) / trace["slice_requests"]
    if s <= 0:
        return None
    return 100.0 * counts.forward_floor_s(trace["counts"]) / s
