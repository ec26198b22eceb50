"""Grouped Adam with per-group LRs, the xyz log-lerp schedule, and
shape-stable state surgery for densification.

Counterpart of `omnigs_tpu/model/optimizer.py`: six Adam groups with
eps = 1e-15, lrs {xyz: init·spatial_scale (scheduled), features_dc:
feature_lr, features_rest: feature_lr/20, opacity, scaling, rotation}, one
step count shared by all groups. The capacity is static, so optimizer
surgery is masked writes: new or replaced slots get zeroed moments.

`adam_step` and `zero_moments` update the parameters and the moments in
place (the JAX functions return new arrays). `AdamState.to_numpy` /
`from_numpy` carry the state over from and to the JAX `AdamState`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
import torch

from omnigs_torch.model.gaussians import PARAM_NAMES

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class LRConfig:
    """The learning-rate subset of the optimization parameters."""

    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    position_lr_delay_steps: int = 0
    feature_lr: float = 2.5e-3
    opacity_lr: float = 5.0e-2
    scaling_lr: float = 5.0e-3
    rotation_lr: float = 1.0e-3


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor  # () int32, shared across groups

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """``{"mu/<name>", "nu/<name>", "count"}`` → numpy arrays."""
        out = {f"mu/{k}": v.detach().cpu().numpy() for k, v in self.mu.items()}
        out.update({f"nu/{k}": v.detach().cpu().numpy() for k, v in self.nu.items()})
        out["count"] = self.count.cpu().numpy()
        return out

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], device="cuda") -> "AdamState":
        """Inverse of `to_numpy` (a JAX state as ``{"mu/xyz": np.asarray(
        state.mu["xyz"]), ..., "count": np.asarray(state.count)}``)."""

        def t(a):
            return torch.from_numpy(np.array(a)).to(device)

        return cls(
            mu={k: t(arrays[f"mu/{k}"]) for k in PARAM_NAMES},
            nu={k: t(arrays[f"nu/{k}"]) for k in PARAM_NAMES},
            count=t(np.asarray(arrays["count"], np.int32)),
        )


def init_adam(params: Mapping[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v, requires_grad=False) for k, v in params.items()},
        nu={k: torch.zeros_like(v, requires_grad=False) for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device),
    )


def expon_lr(
    step: torch.Tensor,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> torch.Tensor:
    """Exponential log-lerp from ``lr_init`` to ``lr_final`` over
    ``max_steps`` with an optional sine delay, in float32 on the step's
    device (no host sync)."""
    step = step.to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
        )
    else:
        delay = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
    return delay * log_lerp


def group_lrs(cfg: LRConfig, spatial_lr_scale: float, step: torch.Tensor) -> Dict:
    """Per-group LRs at ``step``: a () float32 tensor for xyz, floats for
    the fixed groups."""
    xyz_lr = expon_lr(
        step,
        cfg.position_lr_init * spatial_lr_scale,
        cfg.position_lr_final * spatial_lr_scale,
        cfg.position_lr_delay_steps,
        cfg.position_lr_delay_mult,
        cfg.position_lr_max_steps,
    )
    return {
        "xyz": xyz_lr,
        "features_dc": cfg.feature_lr,
        "features_rest": cfg.feature_lr / 20.0,
        "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr,
        "rotation": cfg.rotation_lr,
    }


def _gate(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


@torch.no_grad()
def adam_step(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamState,
    lrs: Mapping,
    active: torch.Tensor,
) -> None:
    """One torch-semantics Adam step over all six groups, gated by
    ``active``, in place: inactive slots keep their parameters, and their
    moments still decay (a zero gradient)."""
    state.count += 1
    c = state.count.to(torch.float32)
    bc1 = 1.0 - BETA1**c
    bc2 = 1.0 - BETA2**c
    for name in PARAM_NAMES:
        p, mu, nu = params[name], state.mu[name], state.nu[name]
        gate = _gate(active, p)
        g = torch.where(gate, grads[name], torch.zeros_like(p))
        mu.copy_(BETA1 * mu + (1.0 - BETA1) * g)
        nu.copy_(BETA2 * nu + (1.0 - BETA2) * (g * g))
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p.sub_(lrs[name] * torch.where(gate, update, torch.zeros_like(update)))


@torch.no_grad()
def zero_moments(state: AdamState, slot_mask: torch.Tensor, names=PARAM_NAMES) -> None:
    """Zero first and second moments at the given slots, in place."""
    for name in names:
        gate = _gate(slot_mask, state.mu[name])
        state.mu[name].masked_fill_(gate, 0.0)
        state.nu[name].masked_fill_(gate, 0.0)
