"""Device busy ms of the training step's ``preprocess_bwd`` stage an
iteration: autograd from the compositor's backward to the end of
`torch.autograd.grad` (back through `preprocess` and the activations),
from the port's stage marks in the profiled slice's replayed graphs."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "train", ("preprocess_bwd",), "slice_iters")
