"""PyTorch port vs JAX reference: `ops/stereo.py` (depth back-projection
and the inactive-geometry keypoint densify) on the inputs and seeds of
tests/test_stereo.py, including the lowest-index tie. Bars: points rtol
1e-6, atol 1e-6; validity masks and colors bitwise (a gather)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import stereo as tst
from omnigs_tpu.ops import stereo as jst

from test_stereo import INTR, WIDTH


def test_reproject_matches_jax():
    rng = np.random.default_rng(0)
    p = WIDTH * 48
    depth = rng.uniform(0.5, 5.0, p).astype(np.float32)
    mask = rng.random(p) < 0.7
    want = np.asarray(jst.reproject_depth_pinhole(jnp.asarray(depth), jnp.asarray(mask), INTR, WIDTH))
    got = tst.reproject_depth_pinhole(torch.from_numpy(depth), torch.from_numpy(mask), INTR, WIDTH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _check(args, max_dist):
    want = jst.inactive_geo_densify(*(jnp.asarray(a) for a in args), max_dist, INTR, WIDTH)
    got = tst.inactive_geo_densify(*(torch.from_numpy(np.asarray(a)) for a in args),
                                   max_dist, INTR, WIDTH)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got


@pytest.mark.parametrize("max_dist", [25.0, 400.0])
def test_densify_matches_jax(max_dist):
    rng = np.random.default_rng(1)
    n, h = 64, 48
    pix = np.stack([rng.integers(0, WIDTH, n), rng.integers(0, h, n)], axis=-1).astype(np.float32)
    has3d = rng.random(n) < 0.5
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.2, 4.0, n)
    pts[rng.random(n) < 0.1, 2] = -0.5
    colors = rng.random((WIDTH * h, 3)).astype(np.float32)
    _, _, valid = _check((pix, has3d, pts, colors), max_dist)
    assert 0 < int(valid.sum()) < n


def test_densify_tie_breaks_to_lowest_index():
    pix = np.array([[10.0, 10.0], [8.0, 10.0], [12.0, 10.0]], np.float32)
    has3d = np.array([False, True, True])
    pts = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 2.0], [0.0, 0.0, 3.0]], np.float32)
    colors = np.ones((WIDTH * 32, 3), np.float32)
    got_pt, _, valid = _check((pix, has3d, pts, colors), 100.0)
    assert bool(valid[0]) and float(got_pt[0, 2]) == 2.0
