"""Device busy ms of the training step's ``loss`` stage an iteration: the
L1 + SSIM forward and, in autograd's order, their backward up to the
compositor's backward, from the port's stage marks in the profiled
slice's replayed graphs."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "train", ("loss",), "slice_iters")
