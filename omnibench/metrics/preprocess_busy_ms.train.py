"""Device busy ms of the training step's ``preprocess`` stage an iteration
(the activations and `ops/preprocess`): the union of the device ops
between the port's ``stage_mark_preprocess`` and the next mark, inside
the replayed graphs of the profiled slice, over its iterations."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "train", ("preprocess",), "slice_iters")
