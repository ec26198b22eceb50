"""PyTorch port vs JAX reference: the point ops of `model/transform.py`
(mark_visible, quat_multiply, rotmat_to_quat, apply_scaled_transformation,
scaled_transform_visible_points, increase_pcd) on the inputs of
tests/test_transform_ckpt.py (its orbax checkpoint case aside: the port's
checkpoint is tests/test_torch_trainer_window.py's).

Both packages start from the same state: `from_pcd` of the four points of
`_model`, and the same Adam moments. Bars: positions, scales, rotations
rtol 1e-6, atol 1e-6; masks, slot layouts and counts bitwise; the Adam
moments bitwise (zeroed or untouched).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.model import optimizer as topt
from omnigs_torch.model import transform as tT
from omnigs_torch.model.gaussians import GaussianModel as TModel
from omnigs_tpu.cameras import CameraType
from omnigs_tpu.model import optimizer as O
from omnigs_tpu.model import transform as T
from omnigs_tpu.ops.covariance import quat_to_rotmat
from omnigs_tpu.ops.knn import mean_sq_knn_dist

from test_transform_ckpt import _model

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
          "active", "max_radii2d", "xyz_gradient_accum", "denom", "exist_since_iter")


def _pair(exist=None):
    """The JAX model of `_model` (optionally with exist_since_iter), its Adam
    state with non-zero moments, and the port's copies."""
    m = _model()
    if exist is not None:
        m = m.replace(exist_since_iter=m.exist_since_iter.at[:4].set(exist))
    st = O.init_adam(m.params())
    rng = np.random.default_rng(0)
    st = st.replace(
        mu={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in st.mu.items()},
        nu={k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32)) for k, v in st.nu.items()},
    )
    tm = TModel.from_numpy({k: np.asarray(getattr(m, k)) for k in FIELDS}, device="cpu")
    ts = topt.AdamState.from_numpy(
        {**{f"mu/{k}": np.asarray(v) for k, v in st.mu.items()},
         **{f"nu/{k}": np.asarray(v) for k, v in st.nu.items()}, "count": np.asarray(st.count)},
        device="cpu",
    )
    return m, st, tm, ts


def _check(jm, jst, tm, ts):
    got = tm.to_numpy()
    for k in FIELDS:
        want = np.asarray(getattr(jm, k))
        if want.dtype.kind in "bi":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-6, err_msg=k)
    tst = ts.to_numpy()
    for k, v in jst.mu.items():
        np.testing.assert_array_equal(tst[f"mu/{k}"], np.asarray(v), err_msg=f"mu/{k}")
        np.testing.assert_array_equal(tst[f"nu/{k}"], np.asarray(jst.nu[k]), err_msg=f"nu/{k}")


@pytest.mark.parametrize("ctype", [CameraType.LONLAT, CameraType.PINHOLE])
def test_mark_visible_matches_jax(ctype):
    m, _, tm, _ = _pair()
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 0.5
    want = np.asarray(T.mark_visible(m.xyz, jnp.asarray(vm), ctype))
    got = tT.mark_visible(tm.xyz.detach(), torch.from_numpy(vm), TCameraType(int(ctype)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quaternions_match_jax():
    rng = np.random.default_rng(1)
    q1, q2 = rng.normal(size=(2, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tT.quat_multiply(torch.from_numpy(q1), torch.from_numpy(q2)).numpy(),
        np.asarray(T.quat_multiply(jnp.asarray(q1), jnp.asarray(q2))), rtol=1e-6, atol=1e-6,
    )
    # every Shepperd branch: rotations about x, y, z by ~π, and the identity
    for k in range(8):
        q = np.asarray(jax.random.normal(jax.random.PRNGKey(k), (4,)))
        if k >= 4:
            q = np.eye(4, dtype=np.float32)[k - 4] + 0.01 * q
        q = (q / np.linalg.norm(q)).astype(np.float32)
        R = np.asarray(quat_to_rotmat(jnp.asarray(q)))
        np.testing.assert_allclose(
            tT.rotmat_to_quat(torch.from_numpy(R.copy())).numpy(),
            np.asarray(T.rotmat_to_quat(jnp.asarray(R))), rtol=1e-6, atol=1e-6,
        )


def test_apply_scaled_transformation_matches_jax():
    m, st, tm, ts = _pair()
    c, si = np.cos(0.5), np.sin(0.5)
    Tm = np.array([[c, -si, 0, 1.0], [si, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    jm, jst = T.apply_scaled_transformation(m, st, 2.0, jnp.asarray(Tm))
    tT.apply_scaled_transformation(tm, ts, 2.0, torch.from_numpy(Tm))
    _check(jm, jst, tm, ts)


def test_scaled_transform_visible_points_matches_jax():
    m, st, tm, ts = _pair(exist=100)
    not_t = np.ones(16, bool)
    not_t[1] = False
    c, si = np.cos(0.3), np.sin(0.3)
    diff = np.array([[1, 0, 0, 1.0], [0, c, -si, 0], [0, si, c, 0.5], [0, 0, 0, 1]], np.float32)
    jm, jst, jnot, jn = T.scaled_transform_visible_points(
        m, st, jnp.asarray(not_t), jnp.asarray(diff), jnp.eye(4), 100, 50,
        CameraType.LONLAT, scale=1.5,
    )
    tnot, tn = tT.scaled_transform_visible_points(
        tm, ts, torch.from_numpy(not_t), torch.from_numpy(diff), torch.eye(4), 100, 50,
        TCameraType.LONLAT, scale=1.5,
    )
    assert int(tn) == int(jn) == 3
    np.testing.assert_array_equal(tnot.numpy(), np.asarray(jnot))
    _check(jm, jst, tm, ts)


@pytest.mark.parametrize("n_new", [2, 14])
def test_increase_pcd_matches_jax(n_new):
    """Two new points, and more than the twelve free slots (two dropped)."""
    m, st, tm, ts = _pair()
    rng = np.random.default_rng(n_new)
    pts = rng.normal(size=(n_new, 3)).astype(np.float32) * 5
    cols = rng.uniform(size=(n_new, 3)).astype(np.float32)
    d2 = np.asarray(mean_sq_knn_dist(jnp.concatenate([m.xyz[:4], jnp.asarray(pts)])))[4:]
    jm, jst, jdrop = T.increase_pcd(m, st, jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(d2), 42)
    tdrop = tT.increase_pcd(tm, ts, torch.from_numpy(pts), torch.from_numpy(cols),
                            torch.from_numpy(d2), 42)
    assert int(tdrop) == int(jdrop) == max(n_new - 12, 0)
    _check(jm, jst, tm, ts)
