"""PyTorch port vs JAX reference: camera projection, SH and covariance math
(omnigs_torch/cameras.py, ops/sh.py, ops/covariance.py). Same numpy inputs
through both; rtol 1e-5, atol 1e-6 (f32 elementwise chains in the same
operation order, transcendental implementations differ by ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch import cameras as tcam
from omnigs_torch.ops import covariance as tcov
from omnigs_torch.ops import sh as tsh
from omnigs_tpu import cameras as jcam
from omnigs_tpu.ops import covariance as jcov
from omnigs_tpu.ops import sh as jsh

from torch_helpers import random_cloud_np

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(t, j, **kw):
    np.testing.assert_allclose(
        t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
        **(kw or TOL),
    )


def _points(seed=0, n=512):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * 3.0
    # include the poles and the seam (x = 0, z < 0)
    p[:4] = [[0.0, 2.0, 0.0], [0.0, -2.0, 0.0], [0.0, 0.5, -2.0], [1e-4, 0, -1]]
    return p.astype(np.float32)


def _viewmatrix(seed=1):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    vm = np.eye(4)
    vm[:3, :3] = q * np.sign(np.linalg.det(q))
    vm[:3, 3] = rng.normal(size=3)
    return vm.astype(np.float32)


def test_world_to_cam():
    p, vm = _points(), _viewmatrix()
    _close(
        tcam.world_to_cam(torch.from_numpy(p), torch.from_numpy(vm)),
        jcam.world_to_cam(jnp.asarray(p), jnp.asarray(vm)),
        rtol=1e-5, atol=1e-5,
    )


def test_lonlat_project():
    p = _points()
    pix_t, r_t, v_t = tcam.lonlat_project(torch.from_numpy(p), 256, 128)
    pix_j, r_j, v_j = jcam.lonlat_project(jnp.asarray(p), 256, 128)
    _close(pix_t, pix_j, rtol=1e-5, atol=1e-4)
    _close(r_t, r_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    _close(tcam.ndc2pix(torch.tensor([-1.0, 0.0, 1.0]), 256),
           jcam.ndc2pix(jnp.asarray([-1.0, 0.0, 1.0]), 256))


def test_lonlat_gradient_is_finite_at_the_pole():
    """Near the camera's pole axis asin's argument y / (r + ε) rounds to ±1;
    the projection's gradient stays finite there (autograd's asin gives inf
    and inf − inf = NaN) and equals the one off the pole elsewhere."""
    t = torch.tensor([[1e-5, 2.0, 1e-5], [1e-5, -3.0, 2e-5], [0.3, 1.0, 0.5]],
                     requires_grad=True)
    pix, r, _ = tcam.lonlat_project(t, 1920, 960)
    assert (t[:2, 1] / (r[:2] + tcam._EPS)).abs().tolist() == [1.0, 1.0]
    (g,) = torch.autograd.grad(pix.sum() + r.sum(), [t])
    assert bool(torch.isfinite(g).all()), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_guarded_asin_is_autograds_below_one(dtype):
    """The latitude's asin: forward and derivative bit for bit autograd's for
    every |x| < 1 (the nearest values to ±1 included); at ±1 the derivative
    of the nearest value below."""
    rng = np.random.default_rng(31)
    below = 1 - torch.finfo(dtype).eps / 2
    x = torch.from_numpy(rng.uniform(-1, 1, 100_000)).to(dtype)
    x[:4] = torch.tensor([below, -below, 0.0, 1e-30], dtype=dtype)
    x.requires_grad_(True)
    up = torch.from_numpy(rng.normal(size=x.shape)).to(dtype)
    (want,) = torch.autograd.grad(torch.asin(x), [x], up)
    (got,) = torch.autograd.grad(tcam._Asin.apply(x), [x], up)
    assert torch.equal(got, want) and torch.equal(tcam._Asin.apply(x), torch.asin(x))
    e = torch.tensor([1.0, -1.0, below], dtype=dtype, requires_grad=True)
    (d,) = torch.autograd.grad(tcam._Asin.apply(e).sum(), [e])
    assert d[0] == d[1] == d[2] and bool(torch.isfinite(d).all())


def test_lonlat_jacobian_rows():
    p = _points(seed=3)
    rows_t = tcam.lonlat_jacobian_rows(torch.from_numpy(p), 256, 128)
    rows_j = jcam.lonlat_jacobian_rows(jnp.asarray(p), 256, 128)
    for rt, rj in zip(rows_t, rows_j):
        for ct, cj in zip(rt, rj):
            _close(ct, cj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    _close(
        tsh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(d)),
        jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)),
    )


def test_sh_to_rgb_and_conversions():
    c = random_cloud_np(4, 300)
    campos = np.array([0.3, -0.2, 0.1], np.float32)
    _close(
        tsh.sh_to_rgb(3, torch.from_numpy(c["shs"]), torch.from_numpy(c["means3d"]),
                      torch.from_numpy(campos)),
        jsh.sh_to_rgb(3, jnp.asarray(c["shs"]), jnp.asarray(c["means3d"]),
                      jnp.asarray(campos)),
    )
    rgb = np.random.default_rng(5).uniform(size=(50, 3)).astype(np.float32)
    _close(tsh.rgb2sh(torch.from_numpy(rgb)), jsh.rgb2sh(jnp.asarray(rgb)))
    _close(tsh.sh2rgb(torch.from_numpy(rgb)), jsh.sh2rgb(jnp.asarray(rgb)))


def test_build_cov3d():
    c = random_cloud_np(6, 300)
    s, q = torch.from_numpy(c["scales"]), torch.from_numpy(c["quats"])
    comp_t = tcov.build_cov3d_components(s, q, 1.3)
    comp_j = jcov.build_cov3d_components(
        jnp.asarray(c["scales"]), jnp.asarray(c["quats"]), 1.3
    )
    for a, b in zip(comp_t, comp_j):
        _close(a, b)
    _close(
        tcov.build_cov3d(s, q, 1.3),
        jcov.build_cov3d(jnp.asarray(c["scales"]), jnp.asarray(c["quats"]), 1.3),
    )


@pytest.mark.parametrize("tight", [False, True])
def test_project_invert_extent(tight):
    c = random_cloud_np(7, 300)
    vm = _viewmatrix(8)
    t_t = tcam.world_to_cam(torch.from_numpy(c["means3d"]), torch.from_numpy(vm))
    # identical camera-space points on both sides: isolate the covariance math
    t_np = t_t.numpy()
    cov_t = tcov.build_cov3d_components(
        torch.from_numpy(c["scales"]), torch.from_numpy(c["quats"])
    )
    cov_j = tuple(jnp.asarray(x.numpy()) for x in cov_t)
    jr_t = tcam.lonlat_jacobian_rows(torch.from_numpy(t_np), 256, 128)
    jr_j = tuple(tuple(jnp.asarray(x.numpy()) for x in r) for r in jr_t)
    abc_t = tcov.project_cov3d_components(cov_t, jr_t, torch.from_numpy(vm)[:3, :3])
    abc_j = jcov.project_cov3d_components(cov_j, jr_j, jnp.asarray(vm)[:3, :3])
    for a, b in zip(abc_t, abc_j):
        _close(a, b, rtol=1e-5, atol=1e-5)
    abc = [jnp.asarray(x.numpy()) for x in abc_t]
    (cA, cB, cC), det_t = tcov.invert_cov2d_components(*abc_t)
    conic_j, det_j = jcov.invert_cov2d_components(*abc)
    for a, b in zip((cA, cB, cC), conic_j):
        _close(a, b)
    _close(det_t, det_j)
    op = c["opacities"]
    rad_t = tcov.cov2d_extent_components(
        abc_t[0], abc_t[2], det_t, torch.from_numpy(op) if tight else None
    )
    rad_j = jcov.cov2d_extent_components(
        abc[0], abc[2], jnp.asarray(det_t.numpy()),
        jnp.asarray(op) if tight else None,
    )
    np.testing.assert_array_equal(rad_t.numpy(), np.asarray(rad_j))
