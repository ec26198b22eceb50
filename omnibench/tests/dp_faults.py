"""Faults planted in the ranks of a data-parallel run: `drivers/train_dp`
calls ``fault(rank, patch)`` on every rank before it trains, where
``patch(obj, name, value)`` sets an attribute of the port for the run."""

import torch.distributed as dist


def skip_grad_allreduce(rank, patch):
    """Rank 1 steps Adam on its own gradient: it takes part in the
    gradient's all-reduce, so the ranks stay in step, and drops the sum."""
    if rank != 1:
        return
    from omnigs_torch.parallel import shard

    real = shard.all_reduce

    def own(x, mesh, axis, op=dist.ReduceOp.SUM):
        out = real(x, mesh, axis, op)
        return x.clone() if x.dim() >= 2 else out  # the gradient leaves are 2-D and more

    patch(shard, "all_reduce", own)


def sum_without_divide(rank, patch):
    """Every rank's gradient comes out as the ranks' sum: the all-reduce
    gives n_data times it, which the step's ÷ n_data takes back to the sum."""
    from omnigs_torch.parallel import shard

    real = shard.all_reduce

    def summed(x, mesh, axis, op=dist.ReduceOp.SUM):
        out = real(x, mesh, axis, op)
        return out * shard.axis_size(mesh, axis) if x.dim() >= 2 else out

    patch(shard, "all_reduce", summed)


def rank_0s_view(rank, patch):
    """Rank 2 trains on data row 0's view, drawn as every rank draws it."""
    if rank != 2:
        return
    from omnigs_torch.train import trainer_parallel

    cls = trainer_parallel.ParallelTrainer
    real = cls.__post_init__

    def post(self):
        real(self)
        self.local_rows = [0]

    patch(cls, "__post_init__", post)


def other_densify_seed(rank, patch):
    """Rank 3 draws its densify's split noise from another seed."""
    if rank != 3:
        return
    from omnigs_torch.train import trainer_parallel

    real = trainer_parallel.shard_generator
    patch(trainer_parallel, "shard_generator",
          lambda seed, mesh, device: real(seed + 1, mesh, device))


def raise_in_rank_2(rank, patch):
    if rank == 2:
        raise RuntimeError("a fault planted in rank 2")
