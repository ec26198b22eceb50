"""The whole training step's share of the card's float32 and memory peaks:
the least time of the step's compositing work (the reference's counts of
contributing pairs and culled instances over the cell's keyframes for the
Gaussians live at the profiled slice's start, at 86 float32 operations a
pair and 224 bytes an instance, summed) over the host-clock time an
iteration takes in the graph windows that follow the slice, before the
window's first event iteration."""

from omnibench.reference import counts


def read(trace):
    if not trace or trace.get("kind") != "train" or not trace.get("ms_per_iter_clean"):
        return None
    return 100.0 * counts.step_floor_s(trace["counts"]) / (trace["ms_per_iter_clean"] * 1e-3)
