"""Kernels #1 and #2 (the segmented forward and backward compositing
kernels) against their floor: their device time an iteration, summed over
the profiled slice by kernel name, against the larger of each kernel's
operations at the float32 peak and its bytes at the memory peak, for the
contributing pairs and culled instances the reference counts over the
cell's keyframes for the Gaussians live at the slice's start (the slice is
three whole rounds of the keyframes, before the window's first densify,
so the live set does not change inside it)."""

from omnibench import tracing
from omnibench.reference import counts

KERNELS = ("composite_seg_fwd_kernel", "composite_seg_bwd_kernel")


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    s = sum(tracing.op_seconds(trace["events"], KERNELS).values()) / trace["slice_iters"]
    if s <= 0:
        return None
    c = trace["counts"]
    return 100.0 * (counts.forward_floor_s(c) + counts.backward_floor_s(c)) / s
