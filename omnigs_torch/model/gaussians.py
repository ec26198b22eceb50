"""Gaussian radiance-field parameters as a fixed-capacity `nn.Module`.

Counterpart of `omnigs_tpu/model/gaussians.py`: a static capacity P_max
with a boolean ``active`` mask. Learnable fields are `nn.Parameter`s,
bookkeeping fields are buffers:

  * ``xyz``            (P, 3)    world positions
  * ``features_dc``    (P, 1, 3) SH degree-0 coefficients
  * ``features_rest``  (P, 15, 3) SH degree-1..3 coefficients
  * ``scaling``        (P, 3)    log-scales (activation: exp)
  * ``rotation``       (P, 4)    unnormalized quaternions (w, x, y, z)
                                 (activation: normalize)
  * ``opacity``        (P, 1)    logits (activation: sigmoid)

`from_numpy` / `to_numpy` carry the eleven fields over from and to the JAX
model (``{k: np.asarray(getattr(m, k))}``); `shard_numpy` cuts such arrays
into one gauss rank's rows.
Training updates the fields in place (`model/optimizer.py`,
`model/densify.py`), where the JAX package returns new arrays; the
capacity never changes, so nothing is reallocated.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from omnigs_torch.ops import sh as sh_ops

MAX_SH_DEGREE = 3
SH_REST = (MAX_SH_DEGREE + 1) ** 2 - 1  # 15

PARAM_NAMES = (
    "xyz",
    "features_dc",
    "features_rest",
    "scaling",
    "rotation",
    "opacity",
)
BUFFER_NAMES = (
    "active",
    "max_radii2d",
    "xyz_gradient_accum",
    "denom",
    "exist_since_iter",
)
FIELD_NAMES = PARAM_NAMES + BUFFER_NAMES


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


class GaussianModel(nn.Module):
    def __init__(self, fields: Mapping[str, torch.Tensor]):
        super().__init__()
        missing = set(FIELD_NAMES) - set(fields)
        if missing:
            raise ValueError(f"GaussianModel: missing fields {sorted(missing)}")
        for k in PARAM_NAMES:
            setattr(self, k, nn.Parameter(fields[k]))
        for k in BUFFER_NAMES:
            self.register_buffer(k, fields[k])

    # ---- construction ----

    @classmethod
    def empty(
        cls, capacity: int, device="cuda", dtype=torch.float32
    ) -> "GaussianModel":
        def full(shape, v, dt=dtype):
            return torch.full(shape, v, dtype=dt, device=device)

        rotation = full((capacity, 4), 0.0)
        rotation[:, 0] = 1.0
        return cls(
            dict(
                xyz=full((capacity, 3), 0.0),
                features_dc=full((capacity, 1, 3), 0.0),
                features_rest=full((capacity, SH_REST, 3), 0.0),
                scaling=full((capacity, 3), -10.0),
                rotation=rotation,
                opacity=full((capacity, 1), -10.0),
                active=full((capacity,), False, torch.bool),
                max_radii2d=full((capacity,), 0.0),
                xyz_gradient_accum=full((capacity,), 0.0),
                denom=full((capacity,), 0.0),
                exist_since_iter=full((capacity,), 0, torch.int32),
            )
        )

    @classmethod
    def from_numpy(
        cls, arrays: Mapping[str, np.ndarray], device="cuda"
    ) -> "GaussianModel":
        """The eleven fields of a JAX `GaussianModel` as numpy arrays →
        model on ``device`` (dtypes kept: float32, bool, int32)."""
        return cls(
            {k: torch.from_numpy(np.array(arrays[k])).to(device) for k in FIELD_NAMES}
        )

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELD_NAMES}

    # ---- views ----

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_active(self) -> torch.Tensor:
        """() int64 count of live slots (a tensor: reading it syncs)."""
        return torch.sum(self.active)

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / (norm + 1e-12)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity[:, 0])

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def params(self) -> Dict[str, torch.Tensor]:
        """The learnable fields handed to the optimizer."""
        return {k: getattr(self, k) for k in PARAM_NAMES}


def shard_numpy(arrays: Mapping[str, np.ndarray], index: int, count: int) -> Dict[str, np.ndarray]:
    """Rows [index·P/count, (index+1)·P/count) of every array with a leading
    capacity dimension P (a model's eleven fields, an Adam state's
    ``mu/…`` and ``nu/…``): gauss rank ``index`` of ``count``'s shard.
    0-d entries (the Adam ``count``) are kept whole."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.ndim == 0:
            out[k] = v
            continue
        if v.shape[0] % count:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split into {count} shards")
        n = v.shape[0] // count
        out[k] = v[index * n : (index + 1) * n]
    return out


def from_pcd(
    points: torch.Tensor,
    colors: torch.Tensor,
    capacity: int,
    mean_sq_nn_dist: torch.Tensor,
) -> GaussianModel:
    """SfM points → model on the points' device (`createFromPcd`).

    Args:
      points: (N, 3) positions (N ≤ capacity).
      colors: (N, 3) RGB in [0, 1].
      mean_sq_nn_dist: (N,) mean squared 3-NN distance (`ops/knn.py`),
        clamped ≥ 1e-7 before the log-sqrt.
    """
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed the capacity {capacity}")
    m = GaussianModel.empty(capacity, device=points.device, dtype=points.dtype)
    scale = torch.log(torch.sqrt(torch.clamp_min(mean_sq_nn_dist, 1e-7)))
    logit = inverse_sigmoid(torch.tensor(0.1, dtype=points.dtype))
    with torch.no_grad():
        m.xyz[:n] = points
        m.features_dc[:n, 0] = sh_ops.rgb2sh(colors)
        m.scaling[:n] = scale[:, None]
        m.rotation[:n] = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=points.dtype)
        m.opacity[:n] = logit
    m.active[:n] = True
    return m
