"""The work the rooflines charge, as the plain reference counts it, and the
card's peaks.

Pairs are the contributing pixel-instance pairs (alpha >= 1/255, power
<= 0, before the transmittance stop); instances are the (Gaussian, tile)
pairs that survive tight culling. Whatever implements a step, these
counts are of its inputs, not of the work its layout chooses to visit.
The arithmetic of a pair and the bytes of an instance are the ones the
repository's roofline uses (frozen here), charged once each.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from omnibench.reference import render as R

# NVIDIA H100 SXM, published dense peaks at its 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per contributing pair: the forward kernel's 17 per
# visited pair (offsets, quadratic form, clamp, exp, opacity, clamp, two
# tests) and 13 per composited pair (log1p, exp of the log-T, the stop
# test, the weight, three colour multiply-adds, two log sums); the
# backward's 17 and 39 (log1p, exp, stop test, weight, the running sums,
# dL/dalpha with one division, the nine partials, the pixel reductions)
OPS_FWD = 17 + 13
OPS_BWD = 17 + 39
# device bytes a composited instance moves once in a whole step (slab
# build 40, forward 36, backward 72, reduction 40, binning's sort keys 36)
BYTES_PER_INSTANCE_STEP = 224.0
# device bytes a composited instance moves once in a render request: the
# slab build (40), the forward (36), binning's sort keys (36)
BYTES_PER_INSTANCE_RENDER = 112.0
# the forward kernel reads an instance's nine float32 rows and writes a
# pixel's colour and transmittance; the backward reads the nine rows and
# the pixel's colour gradient and transmittance, and writes nine rows
BYTES_FWD_INSTANCE, BYTES_FWD_PIXEL = 36.0, 16.0
BYTES_BWD_INSTANCE, BYTES_BWD_PIXEL = 72.0, 16.0


@torch.no_grad()
def mean_counts(raw: Dict[str, torch.Tensor], width: int, height: int,
                views: Sequence, sh_degree: int, bg: torch.Tensor) -> Dict[str, float]:
    """Mean instances and contributing pairs a view of the Gaussians
    ``raw`` takes over ``views`` ((viewmatrix, campos) each)."""
    tot = dict(instances=0.0, pairs=0.0)
    for vm, cp in views:
        _, c = R.render(raw, width, height, vm, cp, bg, sh_degree)
        for k in tot:
            tot[k] += getattr(c, k)
    out = {k: v / len(views) for k, v in tot.items()}
    out["pixels"] = float(width * height)
    return out


def step_floor_s(c: Dict[str, float]) -> float:
    """The least seconds of a forward + backward step's compositing work
    (the repository's roofline: operations and bytes summed, the stages
    being serial)."""
    return (c["pairs"] * (OPS_FWD + OPS_BWD) / PEAK_F32_FLOPS
            + c["instances"] * BYTES_PER_INSTANCE_STEP / PEAK_BYTES_PER_S)


def request_floor_s(c: Dict[str, float]) -> float:
    """The least seconds of a render request's compositing work, as
    `step_floor_s` counts a step's: the forward's operations and the
    request's instance bytes, summed."""
    return (c["pairs"] * OPS_FWD / PEAK_F32_FLOPS
            + c["instances"] * BYTES_PER_INSTANCE_RENDER / PEAK_BYTES_PER_S)


def forward_floor_s(c: Dict[str, float]) -> float:
    """The forward compositing kernel's least seconds: the larger of its
    operations at the float32 peak and its bytes at the memory peak."""
    return max(c["pairs"] * OPS_FWD / PEAK_F32_FLOPS,
               (c["instances"] * BYTES_FWD_INSTANCE + c["pixels"] * BYTES_FWD_PIXEL)
               / PEAK_BYTES_PER_S)


def backward_floor_s(c: Dict[str, float]) -> float:
    return max(c["pairs"] * OPS_BWD / PEAK_F32_FLOPS,
               (c["instances"] * BYTES_BWD_INSTANCE + c["pixels"] * BYTES_BWD_PIXEL)
               / PEAK_BYTES_PER_S)
