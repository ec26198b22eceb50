"""Share of rank 0's profiled slice of data-parallel training iterations
(graph windows of the sharded step) in which its card ran no op: 1 -
(union of the device ops' spans) / the slice's host span, from a
CUDA-only `torch.profiler` trace. The NCCL kernels count as busy, their
wait for the slowest rank included."""

from omnibench import tracing


def read(trace):
    if not trace or trace.get("kind") != "train_dp":
        return None
    return 100.0 * (1.0 - tracing.busy_us(trace["events"]) * 1e-6 / trace["slice_s"])
