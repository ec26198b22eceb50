"""Mean squared 3-NN distance for scale initialization.

Counterpart of `omnigs_tpu/ops/knn.py`: chunked dense distance blocks —
O(N²) work, one (chunk, N) matrix product per block — masked for padded
and inactive points. A one-shot set-up cost (131,072 points are 128 blocks
of (1024, 131,072) distances).
"""

from __future__ import annotations

from typing import Optional

import torch


def mean_sq_knn_dist(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 1024,
    k: int = 3,
) -> torch.Tensor:
    """(N, 3) points → (N,) mean of squared distances to the k nearest others.

    Args:
      mask: optional (N,) bool; masked-out points are excluded as neighbors
        and get result 0.
    """
    n = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    pts = torch.nn.functional.pad(points, (0, 0, 0, n_pad - n))
    msk = torch.nn.functional.pad(mask, (0, n_pad - n))
    sq = torch.sum(pts * pts, dim=-1)
    cols = torch.arange(n_pad, device=dev)
    out = []
    for start in range(0, n_pad, chunk):
        p = pts[start:start + chunk]
        # ‖a − b‖² = ‖a‖² + ‖b‖² − 2a·b
        d2 = sq[start:start + chunk, None] + sq[None, :] - 2.0 * torch.matmul(p, pts.T)
        d2 = torch.clamp_min(d2, 0.0)
        # exclude self and masked-out neighbors
        rows = start + torch.arange(chunk, device=dev)
        excluded = (rows[:, None] == cols[None, :]) | ~msk[None, :]
        d2 = torch.where(excluded, torch.full_like(d2, float("inf")), d2)
        top = torch.topk(d2, k, dim=-1, largest=False).values
        top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
        out.append(torch.mean(top, dim=-1))
    res = torch.cat(out)[:n]
    return torch.where(mask, res, torch.zeros_like(res))
