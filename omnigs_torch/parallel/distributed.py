"""Multi-process execution: joining the process group, and data rows that
each rank loads for itself.

Counterpart of `omnigs_tpu/parallel/distributed.py`. Design:

* `initialize()` follows PyTorch's environment contract (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``, as `torchrun` sets
  them) or takes an ``init_method``; with one process and no
  ``init_method`` it does nothing. The backend is the caller's choice and
  is never switched: ``nccl`` when every rank owns its own card (the rank's
  card is ``LOCAL_RANK``), ``gloo`` for CPU tensors or for ranks that share
  one card.
* A rank loads only the ground truths of its own data row
  (`local_data_rows`); no image crosses ranks, gradients do. Its tensors
  are that row's batch as they stand: there is no global array to
  assemble, so the JAX package's `data_row_owner` / `data_batch` /
  `data_batch_seq` have no counterpart.
* The keyframe sampler runs identically on every rank (same seed, same
  sequence), which keeps the ranks in lock-step without a control channel.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from omnigs_torch.parallel.mesh import DATA_AXIS, axis_index


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    store: Optional[dist.Store] = None,
) -> None:
    """Join the process group (once; a no-op for one process without an
    ``init_method`` or ``store``). Arguments left out come from ``RANK`` and
    ``WORLD_SIZE``; the rendezvous is ``store`` (a `torch.distributed.Store`
    the caller opened, e.g. a `TCPStore` whose master bound port 0, so no
    port is picked and then lost), else ``init_method``, else ``env://``.
    Under NCCL the rank's card becomes ``LOCAL_RANK`` (default: the
    rank)."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and store is None and world_size <= 1:
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"name the backend, 'nccl' or 'gloo' (got {backend!r})")
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kwargs)


def local_data_rows(mesh: DeviceMesh) -> List[int]:
    """The data rows whose ground truths this rank loads: its own."""
    return [axis_index(mesh, DATA_AXIS)]
