"""MB an iteration that rank 0 hands the mesh's all-reduces over the
profiled slice: the program's run-wide ``allreduce_bytes`` counter
(`profiling.counters`, counted at each replay of the captured step) before
and after the slice; None where the program has no such counter."""


def read(trace):
    if not trace or trace.get("kind") != "train_dp" or trace.get("allreduce_bytes") is None:
        return None
    return trace["allreduce_bytes"] / trace["slice_iters"] / 1e6
