"""PyTorch port vs JAX reference: per-Gaussian preprocess
(omnigs_torch/ops/preprocess.py). Float fields within rtol/atol 1e-5 (f32
chains in the same order; atan2/asin/log differ by ulps); the integer
layout fields `rect`, `tiles_touched` and `valid` bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.ops import preprocess as tpre
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops import preprocess as jpre

from torch_helpers import random_cloud_np, to_torch

W, H = 256, 128
FLOAT_FIELDS = ("means2d", "depths", "conic", "radii", "rgb", "opacity")
INT_FIELDS = ("rect", "tiles_touched", "valid")


def _viewmatrix():
    c, s = np.cos(0.4), np.sin(0.4)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    vm[:3, 3] = [0.1, -0.2, 0.3]
    return vm


def _campos(vm):
    return (-vm[:3, :3].T @ vm[:3, 3]).astype(np.float32)


def _run_both(cloud, tight, active=None, sh_degree=3):
    vm = _viewmatrix()
    campos = _campos(vm)
    args = [cloud[k] for k in ("means3d", "scales", "quats", "opacities", "shs")]
    pj = jpre.preprocess(
        *[jnp.asarray(a) for a in args], Camera(CameraType.LONLAT, W, H),
        jnp.asarray(vm), jnp.asarray(campos), sh_degree, tight_culling=tight,
        active_mask=None if active is None else jnp.asarray(active),
    )
    pt = tpre.preprocess(
        *[torch.from_numpy(a) for a in args], TCamera(TCameraType.LONLAT, W, H),
        torch.from_numpy(vm), torch.from_numpy(campos), sh_degree,
        tight_culling=tight,
        active_mask=None if active is None else torch.from_numpy(active),
    )
    return pj, pt


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_preprocess_matches_jax(tight, masked):
    cloud = random_cloud_np(11, 400, scale_mu=-2.0)
    # a few culled rows: at the camera center and inside the near sphere
    cloud["means3d"][:3] = _campos(_viewmatrix()) + np.array(
        [[0.0, 0.0, 0.0], [0.05, 0.05, 0.0], [0.1, 0, 0.1]], np.float32
    )
    active = None
    if masked:
        active = np.random.default_rng(12).uniform(size=400) < 0.8
    pj, pt = _run_both(cloud, tight, active)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
            rtol=1e-5, atol=1e-5, err_msg=f,
        )
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), err_msg=f
        )
    assert not bool(pt.valid[:3].any())
    assert pt.rect.dtype == torch.int32 and pt.tiles_touched.dtype == torch.int32


def test_compute_rect_and_tile_grid():
    rng = np.random.default_rng(13)
    m2d = (rng.uniform(size=(500, 2)) * [W + 64, H + 64] - 32).astype(np.float32)
    radii = np.ceil(rng.uniform(size=500) * 40).astype(np.float32)
    gx, gy = jpre.tile_grid(Camera(CameraType.LONLAT, W + 8, H))
    assert tpre.tile_grid(TCamera(TCameraType.LONLAT, W + 8, H)) == (gx, gy)
    np.testing.assert_array_equal(
        tpre.compute_rect(torch.from_numpy(m2d), torch.from_numpy(radii), gx, gy).numpy(),
        np.asarray(jpre.compute_rect(jnp.asarray(m2d), jnp.asarray(radii), gx, gy)),
    )


def test_pinhole_not_ported():
    """Without ``full_proj`` the pinhole branch raises the JAX package's
    ValueError (the pinhole camera itself is ported: test_torch_pinhole.py)."""
    cloud = random_cloud_np(14, 8)
    cam_kw = dict(fx=30.0, fy=30.0)
    with pytest.raises(ValueError, match="pinhole camera requires full_proj"):
        jpre.preprocess(
            *[jnp.asarray(cloud[k]) for k in ("means3d", "scales", "quats", "opacities", "shs")],
            Camera(CameraType.PINHOLE, 64, 32, **cam_kw), jnp.eye(4), jnp.zeros(3), 0,
        )
    cloud = to_torch(cloud)
    with pytest.raises(ValueError, match="pinhole camera requires full_proj"):
        tpre.preprocess(
            cloud["means3d"], cloud["scales"], cloud["quats"],
            cloud["opacities"], cloud["shs"],
            TCamera(TCameraType.PINHOLE, 64, 32, **cam_kw),
            torch.eye(4), torch.zeros(3), 0,
        )
