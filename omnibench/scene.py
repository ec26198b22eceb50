"""The benchmark's inputs, made from the seed: a truth model, the starting
state of training, keyframe poses and request poses.

The cloud follows the repository's bench model: unit directions at radius
1-5, log-scales N(-3.5, 0.3), opacity logits N(0, 1), dc N(0, 0.5) and small
degree-1..3 coefficients N(0, 0.05), so SH degree 3 does real work. The
Gaussians are drawn on the card from a `torch.Generator` in two calls; the
poses on the host from numpy. Yaws are stratified (one per equal sector,
in a seeded order), so every seed sees the same spread of views.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

WIDTHS = dict(xyz=3, features_dc=3, features_rest=45, scaling=3, rotation=4, opacity=1)
SHAPES = dict(features_dc=(1, 3), features_rest=(15, 3))
# a partly trained state: the truth plus this much noise in each field
START_NOISE = dict(xyz=0.02, features_dc=0.1, features_rest=0.02, scaling=0.1,
                   rotation=0.1, opacity=0.3)


def _split(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, c = {}, 0
    for k, w in WIDTHS.items():
        v = flat[:, c:c + w]
        out[k] = v.reshape((flat.shape[0],) + SHAPES[k]) if k in SHAPES else v
        c += w
    return out


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def truth_model(n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The raw parameters (log-scales, quaternions, logits, SH) of ``n``
    Gaussians, contiguous float32 on ``device``."""
    gen = generator(seed, 1, device)
    z = torch.randn(n, sum(WIDTHS.values()), generator=gen, device=device)
    u = torch.rand(n, 1, generator=gen, device=device)
    f = _split(z)
    d = f["xyz"] / (torch.linalg.vector_norm(f["xyz"], dim=-1, keepdim=True) + 1e-9)
    return dict(
        xyz=(d * (1.0 + 4.0 * u)).contiguous(),
        features_dc=(f["features_dc"] * 0.5).contiguous(),
        features_rest=(f["features_rest"] * 0.05).contiguous(),
        scaling=(f["scaling"] * 0.3 - 3.5).contiguous(),
        rotation=f["rotation"].contiguous(),
        opacity=f["opacity"].contiguous(),
    )


def start_state(truth: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
    """The model training starts from: the truth, perturbed (the SfM cloud
    is the truth's means plus noise; colours, shapes and opacities are
    part way to the truth)."""
    n = truth["xyz"].shape[0]
    dev = truth["xyz"].device
    z = _split(torch.randn(n, sum(WIDTHS.values()), generator=generator(seed, 2, dev), device=dev))
    return {k: (v + START_NOISE[k] * z[k]).contiguous() for k, v in truth.items()}


def pose(yaw: float, pitch: float, center) -> Tuple[np.ndarray, np.ndarray]:
    """(R_cw, t_cw) float32 of a camera at ``center`` looking along yaw,
    then pitch."""
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot = rx @ ry
    center = np.asarray(center, np.float64)
    return rot.astype(np.float32), (-rot @ center).astype(np.float32)


def poses(n: int, seed: int, stream: int, pitch_sigma: float, offset: float
          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` poses: yaw stratified over [0, 2 pi), pitch N(0, pitch_sigma),
    centre U(-offset, offset) on each axis."""
    rng = np.random.default_rng([seed, stream])
    sector = rng.permutation(n)
    yaw = 2.0 * math.pi * (sector + rng.uniform(size=n)) / n
    pitch = rng.normal(size=n) * pitch_sigma
    centers = rng.uniform(-offset, offset, size=(n, 3))
    return [pose(yaw[i], pitch[i], centers[i]) for i in range(n)]


def viewmatrix(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3], m[:3, 3] = rot, trans
    return m


def campos(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    return (-rot.T @ trans).astype(np.float32)
