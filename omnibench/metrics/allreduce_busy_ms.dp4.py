"""Rank 0's device busy ms an iteration in the sharded step's ``allreduce``
stage (the loss, counter, gradient and statistics all-reduces with the
gradient's averaging), from the port's stage marks in the profiled
slice's replayed graphs. An all-reduce kernel's time holds its wait for
the slowest rank."""

from omnibench.metrics import _stages


def read(trace):
    return _stages.busy_ms(trace, "train_dp", ("allreduce",), "slice_iters")
