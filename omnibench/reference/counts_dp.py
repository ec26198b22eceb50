"""The all-reduce's floor in a data-parallel step: the bytes the live rows
need, as a ring all-reduce moves them, over the link's peak.

A step all-reduces each live row's 59 gradient floats (xyz 3, dc 3, the
45 higher SH coefficients, opacity 1, scaling 3, rotation 4) and its 3
densification statistics (the screen-space gradient's sum, the view count,
the largest radius); a ring all-reduce over n ranks sends and receives
2(n - 1)/n of the buffer on each rank's link. Whatever the program
reduces (every capacity row, in several calls), these are the bytes the
live set needs.
"""

from __future__ import annotations

GRAD_FLOATS = 3 + 3 + 45 + 1 + 3 + 4
STAT_FLOATS = 3
BYTES_PER_FLOAT = 4
# NVIDIA H100 SXM, NVLink 4 with 18 links (NV18 in `nvidia-smi topo -m`):
# 900 GB/s both directions together, 450 GB/s each way
LINK_BYTES_PER_S = 450e9


def allreduce_bytes(live: int) -> float:
    """The bytes of one step's all-reduced buffer for ``live`` rows."""
    return live * (GRAD_FLOATS + STAT_FLOATS) * BYTES_PER_FLOAT


def allreduce_floor_s(live: int, n: int) -> float:
    """The least seconds a ring all-reduce of `allreduce_bytes` over ``n``
    ranks takes at the link's peak each way."""
    return allreduce_bytes(live) * 2.0 * (n - 1) / n / LINK_BYTES_PER_S
