"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port see bit-identical data. JAX stays on the CPU
(conftest) and the port runs with ``device="cpu"``.
"""

import numpy as np
import torch


def random_cloud_np(seed, n, spread=4.0, n_sh=16, min_r=1.0, scale_mu=-1.5):
    """Random valid Gaussians around the origin, activated parameters
    (the numpy analog of helpers.random_cloud)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    r = min_r + rng.uniform(size=(n, 1)) * spread
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 + scale_mu)
    opac = 0.97 / (1.0 + np.exp(-rng.normal(size=(n,)) * 2.0))
    sh = rng.normal(size=(n, n_sh, 3)) * 0.3
    out = dict(means3d=d * r, scales=scales, quats=quats, opacities=opac, shs=sh)
    return {k: v.astype(np.float32) for k, v in out.items()}


def random_model_np(seed, capacity, n, scale_mu=-1.5):
    """The eleven raw fields of a GaussianModel (n active of ``capacity``)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    f = dict(
        xyz=np.zeros((capacity, 3)),
        features_dc=np.zeros((capacity, 1, 3)),
        features_rest=np.zeros((capacity, 15, 3)),
        scaling=np.full((capacity, 3), -10.0),
        rotation=np.zeros((capacity, 4)),
        opacity=np.full((capacity, 1), -10.0),
        max_radii2d=np.zeros(capacity),
        xyz_gradient_accum=np.zeros(capacity),
        denom=np.zeros(capacity),
    )
    f["rotation"][:, 0] = 1.0
    f["xyz"][:n] = d * (1.0 + rng.uniform(size=(n, 1)) * 4.0)
    f["scaling"][:n] = rng.normal(size=(n, 3)) * 0.3 + scale_mu
    f["rotation"][:n] = rng.normal(size=(n, 4))
    f["opacity"][:n] = rng.normal(size=(n, 1))
    f["features_dc"][:n] = rng.normal(size=(n, 1, 3)) * 0.5
    f["features_rest"][:n] = rng.normal(size=(n, 15, 3)) * 0.2
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["active"] = np.arange(capacity) < n
    f["exist_since_iter"] = np.zeros(capacity, np.int32)
    return f


def to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


# the production RasterConfig knobs (config.raster_config_from defaults)
PROD_KW = dict(
    backend="pallas", tight_culling=True, tile_culling=True,
    want_ncontrib=False, depth_presort=True, segmented=True,
    gather_reduce=True,
)
