"""The step's all-reduce against its floor: the bytes the Gaussians live
at the slice's start need (59 gradient and 3 statistic floats a row), as a
ring moves them over the ranks, at NVLink 4's 450 GB/s a direction
(`reference/counts_dp.py`), divided by rank 0's NCCL all-reduce kernels'
device time an iteration in the profiled slice (by kernel name). A
kernel's time holds its wait for the slowest rank, so lock-step lag reads
as a lower share."""

from omnibench import tracing
from omnibench.reference import counts_dp

KERNELS = ("AllReduce",)


def read(trace):
    if not trace or trace.get("kind") != "train_dp":
        return None
    s = sum(tracing.op_seconds(trace["events"], KERNELS).values()) / trace["slice_iters"]
    if s <= 0:
        return None
    return 100.0 * counts_dp.allreduce_floor_s(trace["live"], trace["world"]) / s
