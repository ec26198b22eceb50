"""PyTorch port vs JAX reference: losses and image metrics
(omnigs_torch/ops/loss.py), values and gradients with respect to the
prediction, on (3, 64, 128) and an odd size. Bars: rtol 1e-5, atol 1e-6
(float32 rounding of the banded matrix products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import loss as tloss
from omnigs_tpu.ops import loss as jloss

SHAPES = {"64x128": (3, 64, 128), "odd": (3, 37, 53)}
FUNCS = ("l1_loss", "psnr", "psnr_gaussian_splatting", "ssim", "training_loss")


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(size=shape) * 0.1, 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", FUNCS)
def test_loss_value_and_grad_match_jax(name, shape):
    pred, gt = _images(SHAPES[shape], seed=len(name) + len(shape))
    jf, tf = getattr(jloss, name), getattr(tloss, name)
    v_ref, g_ref = jax.value_and_grad(lambda p: jf(p, jnp.asarray(gt)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    v = tf(p, torch.from_numpy(gt))
    (g,) = torch.autograd.grad(v, [p])
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)


def test_ssim_map_matches_jax():
    pred, gt = _images(SHAPES["odd"], seed=3)
    ref = jloss.ssim(jnp.asarray(pred), jnp.asarray(gt), size_average=False)
    got = tloss.ssim(torch.from_numpy(pred), torch.from_numpy(gt), size_average=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tloss._band_matrix_np(37), jloss._band_matrix(37))


def test_training_loss_float64_matches_jax():
    """Float64 images get the window in float64 (the float64 reference step
    of the XLA backend): the loss and its gradient agree with JAX's float32
    ones to float32 rounding."""
    pred, gt = _images(SHAPES["64x128"], seed=5)
    v_ref, g_ref = jax.value_and_grad(
        lambda p: jloss.training_loss(p, jnp.asarray(gt)))(jnp.asarray(pred))
    p = torch.from_numpy(pred.astype(np.float64)).requires_grad_(True)
    v = tloss.training_loss(p, torch.from_numpy(gt.astype(np.float64)))
    (g,) = torch.autograd.grad(v, [p])
    assert v.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)
