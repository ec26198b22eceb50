"""PyTorch port vs JAX reference: losses and image metrics
(omnigs_torch/ops/loss.py), values and gradients with respect to the
prediction, on (3, 64, 128) and an odd size. Bars: rtol 1e-5, atol 1e-6
(float32 rounding: JAX's banded matrix products against the port's
stencil). The port's plain SSIM (`ssim_plain`, the kernels' operation
order) against the banded formulation it replaced, map and gradient: 1e-6
(2.5e-6 for float32's map and gradients, whose σ² cancels); its
row blocks (`ssim_rows`) bit for bit the whole map's rows, and their
gradients the whole map's."""

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
    # the port's window: JAX's taps, the band its matrix holds
    taps = np.asarray(tloss._taps(11), np.float32)
    np.testing.assert_array_equal(taps, jloss._gaussian_1d(11))
    np.testing.assert_array_equal(jloss._band_matrix(37)[18, 13:24], taps)


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


def _band(n, dtype):
    """(n, n) B with B[i, j] = g(j − i): B @ x is the SAME zero-padded conv."""
    g = tloss._gaussian_1d(11)
    b = np.zeros((n, n), np.float32)
    for d in range(-5, 6):
        i = np.arange(max(0, -d), min(n, n - d))
        b[i, i + d] = g[d + 5]
    return torch.from_numpy(b).to(dtype)


def _banded_ssim(img1, img2, size_average=True):
    """The banded formulation the stencil replaced: B_v · img · B_h."""
    _, h, w = img1.shape
    bv, bh = _band(h, img1.dtype), _band(w, img1.dtype)

    def conv(x):
        return torch.matmul(torch.matmul(bv, x), bh)

    mu1, mu2 = conv(img1), conv(img2)
    s1 = conv(img1 * img1) - mu1 * mu1
    s2 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    s = ((2 * mu1 * mu2 + 0.01**2) * (2 * s12 + 0.03**2)) / (
        (mu1 * mu1 + mu2 * mu2 + 0.01**2) * (s1 + s2 + 0.03**2))
    return s.mean() if size_average else s


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", ["mean", "map"])
def test_ssim_plain_matches_banded(mode, shape, dtype):
    """`ssim_plain` (value, and gradient in the prediction relative to its
    largest entry; the map's with a seeded upstream gradient) against the
    banded matrix products in float64. Bar 1e-6, but for float32's map and
    gradients: there σ² = E[x²] − μ² cancels, so any float32 order lies
    ~1–2e-6 from the exact values (the float32 banded products too, up to
    1.8e-6 on these inputs) and two orders up to ~3e-6 apart; those are held
    at 2.5e-6."""
    pred, gt = _images(SHAPES[shape], seed=11 + len(shape))
    cot = np.random.default_rng(4).normal(size=pred.shape)
    out = []
    for f, dt in ((tloss.ssim_plain, dtype), (_banded_ssim, torch.float64)):
        p = torch.from_numpy(pred).to(dt).requires_grad_(True)
        v = f(p, torch.from_numpy(gt).to(dt), size_average=mode == "mean")
        c = torch.from_numpy(cot).to(dt)
        (g,) = torch.autograd.grad(v if mode == "mean" else (v * c).sum(), [p])
        assert v.dtype == g.dtype == dt
        out += [v.detach().double().numpy(), g.double().numpy()]
    f32 = dtype == torch.float32
    bar = 2.5e-6 if f32 and mode == "map" else 1e-6
    np.testing.assert_allclose(out[0], out[2], rtol=0, atol=bar)
    bar = 2.5e-6 if f32 else 1e-6
    np.testing.assert_allclose(out[1], out[3], rtol=0, atol=bar * np.abs(out[3]).max())


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 70, 97), (1, 5, 300)],
                         ids=["odd", "tiles", "one_row"])
def test_ssim_plain_mean_is_the_fixed_tree(shape):
    """The mean of `ssim_plain` is its map's sum in the kernels' tree over
    the pixel count (bit for bit), within float32 rounding of a float64
    sum; the map path and `ssim` on the CPU are `ssim_plain`."""
    pred, gt = (torch.from_numpy(a) for a in _images(shape, seed=shape[1]))
    m = tloss.ssim_plain(pred, gt, size_average=False)
    mean = tloss.ssim_plain(pred, gt)
    assert torch.equal(mean, tloss._map_sum(m) / float(m.numel()))
    assert torch.equal(tloss.ssim(pred, gt), mean)
    assert torch.equal(tloss.ssim(pred, gt, size_average=False), m)
    np.testing.assert_allclose(float(mean), float(m.double().mean()), rtol=2e-7)


@pytest.mark.parametrize("row0,nrows", [(0, 9), (5, 11), (20, 12), (24, 12)])
def test_ssim_rows_blocks_equal_the_map_bitwise(row0, nrows):
    """A row block of `ssim_rows` (the plain versions from the block's rows
    and halo) equals the rows of the whole map bit for bit, and so does its
    gradient the whole map's under a cotangent that is zero off the block;
    the gradient is zero on the rows the block's window does not reach."""
    a, b = (torch.from_numpy(x) for x in _images((3, 32, 64), seed=row0 + nrows))
    cot = torch.from_numpy(np.random.default_rng(row0).normal(size=(3, nrows, 64)))
    cot = cot.to(torch.float32)
    valid = min(nrows, 32 - row0)
    p = a.clone().requires_grad_(True)
    blk = tloss.ssim_rows(p, b, row0, nrows, 32)
    (g,) = torch.autograd.grad((blk[:, :valid] * cot[:, :valid]).sum(), [p])
    full = tloss.ssim(p, b, size_average=False)
    assert torch.equal(blk[:, :valid].detach(), full[:, row0 : row0 + valid].detach())
    cot_full = torch.zeros(3, 32, 64)
    cot_full[:, row0 : row0 + valid] = cot[:, :valid]
    (g_full,) = torch.autograd.grad((full * cot_full).sum(), [p])
    assert torch.equal(g, g_full)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    reach = torch.zeros(32, dtype=torch.bool)
    reach[max(row0 - 5, 0) : row0 + valid + 5] = True
    assert int(torch.count_nonzero(g[:, ~reach])) == 0


def test_ssim_is_differentiable_in_the_prediction_only():
    """A ground truth that needs a gradient is refused; without autograd
    it is taken (the partials are not computed)."""
    pred, gt = (torch.from_numpy(x) for x in _images((3, 16, 24), seed=1))
    with pytest.raises(ValueError, match="first image"):
        tloss.ssim(pred, gt.clone().requires_grad_(True))
    with torch.no_grad():
        v = tloss.ssim(pred.clone().requires_grad_(True), gt.clone().requires_grad_(True))
    assert torch.equal(v, tloss.ssim(pred, gt))
