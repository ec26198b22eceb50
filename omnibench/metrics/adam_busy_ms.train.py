"""Device busy ms of the training step's ``adam`` stage an iteration (the
densification statistics, `group_lrs`, `adam_step`), from the port's
stage marks in the profiled slice's replayed graphs."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "train", ("adam",), "slice_iters")
