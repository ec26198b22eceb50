"""Plain float32 reference of the training step of 3D Gaussian splatting.

Loss (1 - lambda) L1 + lambda (1 - SSIM), SSIM with an 11 x 11 Gaussian
window of sigma 1.5 over zero-padded images, the bottom ``skip_px`` rows
of the panorama left out. Adam over six parameter groups with one shared
step count, eps 1e-15, the position learning rate decayed log-linearly
from ``position_lr_init`` to ``position_lr_final`` over
``position_lr_max_steps`` and scaled by the scene extent (1.1 times the
largest camera distance from the cameras' centroid). Nothing here imports
the measured program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from omnibench.reference import render as R

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
PARAMS = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")


def gaussian_window(n: int, size: int = 11, sigma: float = 1.5,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """(n, n) matrix whose product with a length-n signal is its
    zero-padded convolution with the normalised Gaussian of ``size`` taps."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / g.sum()
    band = np.zeros((n, n))
    for k, v in zip(x, g):
        i = np.arange(max(0, -k), min(n, n - k))
        band[i, i + k] = v
    return torch.tensor(band, dtype=dtype, device=device)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images."""
    _, h, w = a.shape
    bv = gaussian_window(h, device=a.device, dtype=a.dtype)
    bh = gaussian_window(w, device=a.device, dtype=a.dtype)

    def blur(x):
        return bv @ x @ bh

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def loss_fn(gt: torch.Tensor, lambda_dssim: float, skip_px: int):
    def f(image):
        pred, ref = image, gt
        if skip_px:
            pred, ref = pred[:, :-skip_px], ref[:, :-skip_px]
        l1 = (pred - ref).abs().mean()
        return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(pred, ref))
    return f


def scene_extent(centers: np.ndarray) -> float:
    c = np.asarray(centers, np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=-1).max() * 1.1)


def learning_rates(opt: dict, extent: float, step: int) -> Dict[str, float]:
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    xyz = math.exp(math.log(opt["position_lr_init"] * extent) * (1 - t)
                   + math.log(opt["position_lr_final"] * extent) * t)
    return dict(xyz=xyz, features_dc=opt["feature_lr"], features_rest=opt["feature_lr"] / 20.0,
                opacity=opt["opacity_lr"], scaling=opt["scaling_lr"], rotation=opt["rotation_lr"])


def adam(params, grads, mu, nu, count: int, lrs) -> None:
    """One Adam step in place; ``count`` is the step count after it."""
    bc1, bc2 = 1.0 - BETA1 ** count, 1.0 - BETA2 ** count
    for k in PARAMS:
        g = grads[k]
        mu[k].mul_(BETA1).add_((1.0 - BETA1) * g)
        nu[k].mul_(BETA2).add_((1.0 - BETA2) * g * g)
        params[k].sub_(lrs[k] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))


def run_steps(params: Dict[str, torch.Tensor], mu, nu, count0: int, views: Sequence,
              steps: Sequence[int], width: int, height: int, sh_degree: int,
              opt: dict, extent: float, skip_px: int, bg: torch.Tensor) -> List[dict]:
    """The training steps ``steps`` (iteration numbers), in place on
    ``params``, ``mu``, ``nu``. Step i takes the views ``views[i]``, a list
    of (viewmatrix, campos, ground truth): its loss and gradient are the
    means over them. Returns each step's loss and gradients."""
    out = []
    for n, (step, batch) in enumerate(zip(steps, views)):
        loss, grads = 0.0, {k: torch.zeros_like(v) for k, v in params.items()}
        for vm, cp, gt in batch:
            l_v, g_v = R.render_loss_grad(
                params, width, height, vm, cp, bg, sh_degree,
                loss_fn(gt, opt["lambda_dssim"], skip_px))
            loss += float(l_v) / len(batch)
            for k in grads:
                grads[k] += g_v[k] / len(batch)
        with torch.no_grad():
            adam(params, grads, mu, nu, count0 + n + 1, learning_rates(opt, extent, step))
        out.append(dict(loss=loss, grads=grads))
    return out
