"""The example model of the JAX package's measurement scripts, shared by
the port's scripts (`kernel_ablate`, `kernel_bench`, `bin_bench`,
`subtile_analysis`, `scaling_bench`).

`example_model` draws `__graft_entry__._example_model(capacity=n, n=n)`'s
distribution from a seeded `torch.Generator`; a generator draws other
streams on the CPU and on a card, so the model (and every count the
scripts print) differs between the two devices, and none equals the JAX
model's. `preprocess_model` is the scripts' preprocess of it: the
activations from the identity pose at SH degree 3 with tight culling.
"""

from __future__ import annotations

import torch

from omnigs_torch.cameras import Camera
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops.preprocess import Preprocessed, preprocess

SH_DEGREE = 3


def example_model(n: int, device, seed: int = 0) -> GaussianModel:
    """``__graft_entry__._example_model(capacity=n, n=n)``'s distribution:
    unit directions at radius 1–5, log-scales N(−3.5, 0.3), rotations and
    opacity logits N(0, 1), dc N(0, 0.5), no higher SH coefficients."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    m = GaussianModel.empty(n, device=device)
    d = normal(n, 3)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-9)
    with torch.no_grad():
        m.xyz.copy_(d * (1.0 + torch.rand(n, 1, generator=gen, device=device) * 4.0))
        m.scaling.copy_(normal(n, 3) * 0.3 - 3.5)
        m.rotation.copy_(normal(n, 4))
        m.opacity.copy_(normal(n, 1))
        m.features_dc.copy_(normal(n, 1, 3) * 0.5)
    m.active.fill_(True)
    return m


def preprocess_model(model: GaussianModel, camera: Camera) -> Preprocessed:
    """`preprocess` of ``model``'s activations from the identity pose at SH
    degree 3 with tight culling, without autograd."""
    dev = model.xyz.device
    with torch.no_grad():
        return preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_opacity(), model.get_features(), camera,
            torch.eye(4, device=dev), torch.zeros(3, device=dev), SH_DEGREE, 1.0,
            tight_culling=True,
        )
