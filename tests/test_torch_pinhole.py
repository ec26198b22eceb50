"""PyTorch port vs JAX reference: the pinhole camera (omnigs_torch/cameras.py
pinhole math, the PINHOLE branch of ops/preprocess.py, `full_proj`
through `rasterize` / `render_model`, `Keyframe.full_proj`).

Bars: the camera math and `full_proj` at 1e-6 relative; preprocess cull
masks, radii and rects equal, float fields at 1e-5; renders at image and
final_T atol 1e-5 and gradients at rtol 2e-3, atol 1e-4·max|ref| (the JAX
suite's bars between its own backends, tests/test_pallas_seg.py), the JAX
side on the segmented path in Pallas interpret mode. 64×40 has a half
tile row: the padded pixels must carry no weight and no gradient."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnigs_torch.cameras as tcams
import omnigs_tpu.cameras as jcams
from omnigs_torch.ops import preprocess as tpre
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig
from omnigs_torch.ops.rasterize import rasterize as trasterize
from omnigs_torch.scene.keyframe import Keyframe as TKeyframe
from omnigs_tpu.ops import preprocess as jpre
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.ops.rasterize import rasterize as jrasterize
from omnigs_tpu.scene.keyframe import Keyframe as JKeyframe

from torch_helpers import PROD_KW, random_cloud_np

KEYS = ("means3d", "scales", "quats", "opacities", "shs")


def _cams(w=64, h=48, f=40.0):
    kw = dict(fx=f, fy=f * 1.1, cx=w / 2, cy=h / 2)
    return (jcams.Camera(jcams.CameraType.PINHOLE, w, h, **kw),
            tcams.Camera(tcams.CameraType.PINHOLE, w, h, **kw))


def _pose(seed=0):
    rng = np.random.default_rng(seed)
    a = 0.3 * rng.normal()
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = (rng.normal(size=3) * 0.1).astype(np.float32)
    return R, t


def _keyframes(w=64, h=48, seed=0):
    jc, tc = _cams(w, h)
    R, t = _pose(seed)
    return (JKeyframe(0, jc, R, t, znear=0.01, zfar=100.0),
            TKeyframe(0, tc, R, t, znear=0.01, zfar=100.0))


def _front_cloud(seed, n, behind=0):
    """Gaussians in front of the camera (z in [0.5, 4]); the last ``behind``
    sit at z ≤ 0.2 (near-culled, some behind the camera)."""
    c = random_cloud_np(seed, n, scale_mu=-2.5)
    rng = np.random.default_rng(seed + 1)
    z = rng.uniform(0.5, 4.0, n)
    z[n - behind:] = rng.uniform(-1.0, 0.2, behind)
    xy = rng.normal(size=(n, 2)) * 0.45 * np.abs(z)[:, None]
    c["means3d"] = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    return c


def test_camera_math_matches_jax():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    t[:, 2] = np.abs(t[:, 2]) + 0.3
    jc, tc = _cams()
    assert (tc.tan_fovx, tc.tan_fovy) == (jc.tan_fovx, jc.tan_fovy)
    jr = jcams.pinhole_jacobian(jnp.asarray(t), jc.fx, jc.fy, jc.tan_fovx, jc.tan_fovy)
    tr = tcams.pinhole_jacobian(torch.from_numpy(t), tc.fx, tc.fy, tc.tan_fovx, tc.tan_fovy)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
    for f, px in ((40.0, 64), (1200.0, 1920), (900.5, 1080)):
        assert tcams.focal2fov(f, px) == pytest.approx(jcams.focal2fov(f, px), rel=1e-6)
        fov = jcams.focal2fov(f, px)
        assert tcams.fov2focal(fov, px) == pytest.approx(jcams.fov2focal(fov, px), rel=1e-6)
    for args in ((0.01, 100.0, 1.2, 0.9), (0.1, 50.0, math.pi / 2, math.pi / 3)):
        np.testing.assert_allclose(tcams.getProjectionMatrix(*args).numpy(),
                                   np.asarray(jcams.getProjectionMatrix(*args)), rtol=1e-6)
    jk, tk = _keyframes()
    assert tk.full_proj.dtype == np.float32
    np.testing.assert_allclose(tk.full_proj, jk.full_proj, rtol=1e-6)
    fp = tk.full_proj
    means = _front_cloud(1, 32)["means3d"]
    vm = tk.viewmatrix
    jp = jcams.pinhole_project(jnp.asarray(means @ vm[:3, :3].T + vm[:3, 3]), 64, 48,
                               jnp.asarray(fp), jnp.asarray(means))
    tp = tcams.pinhole_project(torch.from_numpy(means @ vm[:3, :3].T + vm[:3, 3]), 64, 48,
                               torch.from_numpy(fp), torch.from_numpy(means))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)
    # a lonlat keyframe has no full_proj
    R, t = _pose()
    assert TKeyframe(1, tcams.Camera(tcams.CameraType.LONLAT, 64, 32), R, t).full_proj is None


def test_preprocess_near_cull_matches_jax():
    """Rows at z ≤ 0.2 are culled in both packages, and their gradients are
    finite (the safe-point substitutions of t and of the world point)."""
    c = _front_cloud(2, 48, behind=12)
    jk, tk = _keyframes(seed=2)
    jp = jpre.preprocess(*[jnp.asarray(c[k]) for k in KEYS], jk.camera,
                         jnp.asarray(jk.viewmatrix), jnp.asarray(jk.campos), 2,
                         full_proj=jnp.asarray(jk.full_proj), tight_culling=True)
    leaves = [torch.from_numpy(c[k]).requires_grad_(True) for k in KEYS]
    tp = tpre.preprocess(*leaves, tk.camera, torch.from_numpy(tk.viewmatrix),
                         torch.from_numpy(tk.campos), 2,
                         full_proj=torch.from_numpy(tk.full_proj), tight_culling=True)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert not tp.valid[-12:].any() and tp.valid[:36].sum() > 20
    for f in ("rect", "tiles_touched"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), f)
    for f in ("means2d", "depths", "conic", "radii", "rgb"):
        np.testing.assert_allclose(getattr(tp, f).detach().numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    loss = (tp.means2d.sum() + tp.conic.sum() + tp.rgb.sum()
            + (tp.radii * tp.valid).sum())
    for g in torch.autograd.grad(loss, leaves, allow_unused=True):
        assert g is None or bool(torch.isfinite(g).all())


def _weights(shape):
    return np.linspace(0.5, 1.5, int(np.prod(shape)), dtype=np.float32).reshape(shape)


@pytest.mark.parametrize("height", [48, 40], ids=["full_tiles", "partial_tile"])
def test_pinhole_render_and_grads_match_jax(height):
    c = _front_cloud(3, 96, behind=8)
    jk, tk = _keyframes(64, height, seed=3)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def jloss(*arrays):
        res = jrasterize(
            *arrays, camera=jk.camera, viewmatrix=jnp.asarray(jk.viewmatrix),
            campos=jnp.asarray(jk.campos), bg=jnp.asarray(bg), sh_degree=2,
            config=JRasterConfig(max_instances=1 << 12, interpret=True, **PROD_KW),
            full_proj=jnp.asarray(jk.full_proj),
        )
        return jnp.sum(res.image * jnp.asarray(_weights(res.image.shape))), res

    (_, jres), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(
        *[jnp.asarray(c[k]) for k in KEYS])
    leaves = [torch.from_numpy(c[k]).requires_grad_(True) for k in KEYS]
    tres = trasterize(
        *leaves, camera=tk.camera, viewmatrix=torch.from_numpy(tk.viewmatrix),
        campos=torch.from_numpy(tk.campos), bg=torch.from_numpy(bg), sh_degree=2,
        config=TRasterConfig(max_instances=1 << 12, **PROD_KW),
        full_proj=torch.from_numpy(tk.full_proj),
    )
    assert tuple(tres.image.shape) == (3, height, 64)
    np.testing.assert_allclose(tres.image.detach().numpy(), np.asarray(jres.image), atol=1e-5)
    np.testing.assert_allclose(tres.final_T.numpy(), np.asarray(jres.final_T), atol=1e-5)
    np.testing.assert_array_equal(tres.radii.detach().numpy(), np.asarray(jres.radii))
    assert int(tres.truncated) == int(jres.truncated) == 0
    assert float(tres.final_T.min()) < 0.9
    loss = torch.sum(tres.image * torch.from_numpy(_weights(tuple(tres.image.shape))))
    got = torch.autograd.grad(loss, leaves)
    for g, r, name in zip(got, jgrads, KEYS):
        r = np.asarray(r)
        assert bool(torch.isfinite(g).all()), name
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-3, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


def test_pinhole_requires_full_proj():
    c = _front_cloud(4, 8)
    jc, tc = _cams()
    with pytest.raises(ValueError, match="pinhole camera requires full_proj"):
        jpre.preprocess(*[jnp.asarray(c[k]) for k in KEYS], jc, jnp.eye(4), jnp.zeros(3), 0)
    with pytest.raises(ValueError, match="pinhole camera requires full_proj"):
        trasterize(*[torch.from_numpy(c[k]) for k in KEYS], camera=tc,
                   viewmatrix=torch.eye(4), campos=torch.zeros(3), bg=torch.zeros(3),
                   sh_degree=0, config=TRasterConfig(max_instances=1 << 10, **PROD_KW))
