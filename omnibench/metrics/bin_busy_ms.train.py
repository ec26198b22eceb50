"""Device busy ms of the training step's ``bin`` and ``relay`` stages an
iteration (packed binning, `segment_relay` and the slab build), from the
port's stage marks in the profiled slice's replayed graphs."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "train", ("bin", "relay"), "slice_iters")
