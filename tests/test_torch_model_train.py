"""PyTorch port vs JAX reference: the model layer of training —
`ops/knn.py`, `model/gaussians.py::from_pcd`, `model/optimizer.py` and
`model/densify.py` — on identical numpy inputs.

Bars: knn atol 1e-6; Adam atol 1e-7 on identical gradients; densify with
the JAX split noise injected into the port: slot layout (active, written
slots, exist_since_iter) and the DensifyStats counts bitwise equal, floats
atol 1e-6 (the children's rotated offsets are small matrix products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.model import densify as tdens
from omnigs_torch.model import gaussians as tgauss
from omnigs_torch.model import optimizer as topt
from omnigs_torch.ops import knn as tknn
from omnigs_tpu.model import densify as jdens
from omnigs_tpu.model import gaussians as jgauss
from omnigs_tpu.model import optimizer as jopt
from omnigs_tpu.ops import knn as jknn

from torch_helpers import random_model_np

FLOAT_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "max_radii2d", "xyz_gradient_accum", "denom")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_mean_sq_knn_dist_matches_jax(masked):
    rng = np.random.default_rng(11)
    pts = rng.uniform(size=(300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.7 if masked else None
    ref = jknn.mean_sq_knn_dist(
        jnp.asarray(pts), None if mask is None else jnp.asarray(mask), chunk=128
    )
    got = tknn.mean_sq_knn_dist(
        torch.from_numpy(pts), None if mask is None else torch.from_numpy(mask),
        chunk=128,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    if masked:
        assert (got.numpy()[~mask] == 0).all()


def test_from_pcd_matches_jax():
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(size=(40, 3)).astype(np.float32)
    d2 = (rng.uniform(size=40) * 0.01).astype(np.float32)
    d2[3] = 0.0  # clamped to 1e-7 before the log
    jm = jgauss.from_pcd(jnp.asarray(pts), jnp.asarray(cols), 64, jnp.asarray(d2))
    tm = tgauss.from_pcd(torch.from_numpy(pts), torch.from_numpy(cols), 64,
                         torch.from_numpy(d2))
    got = tm.to_numpy()
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(getattr(jm, k)), atol=1e-6, err_msg=k)
    assert int(tm.num_active) == int(jm.num_active) == 40


@pytest.mark.parametrize("delay", [0, 500])
def test_lr_schedule_matches_jax(delay):
    cfg_j = jopt.LRConfig(position_lr_delay_steps=delay)
    cfg_t = topt.LRConfig(position_lr_delay_steps=delay)
    for step in (0, 1, 250, 7000, 30000, 40000):
        ref = jopt.group_lrs(cfg_j, 3.7, jnp.asarray(step))
        got = topt.group_lrs(cfg_t, 3.7, torch.tensor(step))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                       err_msg=f"{k}@{step}")


def _adam_inputs(seed, capacity=32, n=20):
    rng = np.random.default_rng(seed)
    fields = random_model_np(seed, capacity, n)
    names = jgauss.PARAM_NAMES
    grads = {k: rng.normal(size=fields[k].shape).astype(np.float32) * 1e-2 for k in names}
    state = {f"mu/{k}": rng.normal(size=fields[k].shape).astype(np.float32) * 1e-3
             for k in names}
    state.update({f"nu/{k}": (rng.uniform(size=fields[k].shape) * 1e-5).astype(np.float32)
                  for k in names})
    state["count"] = np.int32(3)
    return fields, grads, state


def _jstate(state):
    names = jgauss.PARAM_NAMES
    return jopt.AdamState(
        mu={k: jnp.asarray(state[f"mu/{k}"]) for k in names},
        nu={k: jnp.asarray(state[f"nu/{k}"]) for k in names},
        count=jnp.asarray(state["count"]),
    )


def _jstate_np(s):
    out = {f"mu/{k}": np.asarray(v) for k, v in s.mu.items()}
    out.update({f"nu/{k}": np.asarray(v) for k, v in s.nu.items()})
    out["count"] = np.asarray(s.count)
    return out


def test_adam_step_and_zero_moments_match_jax():
    fields, grads, state = _adam_inputs(13)
    names = jgauss.PARAM_NAMES
    active = fields["active"]
    lrs_j = jopt.group_lrs(jopt.LRConfig(), 2.5, jnp.asarray(100))
    lrs_t = topt.group_lrs(topt.LRConfig(), 2.5, torch.tensor(100))
    new_j, st_j = jopt.adam_step(
        {k: jnp.asarray(fields[k]) for k in names},
        {k: jnp.asarray(v) for k, v in grads.items()}, _jstate(state), lrs_j,
        jnp.asarray(active),
    )
    params_t = {k: torch.from_numpy(fields[k].copy()) for k in names}
    st_t = topt.AdamState.from_numpy(state, device="cpu")
    topt.adam_step(params_t, {k: torch.from_numpy(v) for k, v in grads.items()},
                   st_t, lrs_t, torch.from_numpy(active))
    assert int(st_t.count) == int(st_j.count) == 4
    for k in names:
        np.testing.assert_allclose(params_t[k].numpy(), np.asarray(new_j[k]),
                                   rtol=0, atol=1e-7, err_msg=k)
        # inactive slots keep their parameters; their moments still decay
        np.testing.assert_array_equal(params_t[k].numpy()[~active], fields[k][~active])
    ref = _jstate_np(st_j)
    for k, v in st_t.to_numpy().items():
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-7, err_msg=k)

    slots = np.arange(32) % 3 == 0
    ref = _jstate_np(jopt.zero_moments(st_j, jnp.asarray(slots), names=("xyz", "opacity")))
    topt.zero_moments(st_t, torch.from_numpy(slots), names=("xyz", "opacity"))
    for k, v in st_t.to_numpy().items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def _densify_inputs(seed=14, capacity=48, n=40):
    rng = np.random.default_rng(seed)
    f = random_model_np(seed, capacity, n, scale_mu=-3.0)
    f["scaling"][:n] = rng.normal(size=(n, 3)).astype(np.float32) - 3.0
    f["xyz_gradient_accum"][:n] = rng.uniform(size=n).astype(np.float32) * 1e-3
    f["denom"][:n] = rng.integers(0, 4, size=n).astype(np.float32)
    f["max_radii2d"][:n] = rng.integers(0, 40, size=n).astype(np.float32)
    f["exist_since_iter"][:n] = 7
    _, _, state = _adam_inputs(seed, capacity, n)
    return f, state


def _jmodel(f):
    return jgauss.GaussianModel(**{k: jnp.asarray(v) for k, v in f.items()})


def test_densify_and_prune_matches_jax(monkeypatch):
    f, state = _densify_inputs()
    kw = dict(max_grad=2e-4, min_opacity=0.2, max_screen_size=20,
              percent_dense=0.08, prune_by_extent=True, iteration=321)
    key = jax.random.PRNGKey(5)
    jm, jst, jstats = jdens.densify_and_prune(
        _jmodel(f), _jstate(state), key, extent=1.0, **kw
    )
    noise = np.array(jax.random.normal(key, (tdens.SPLIT_N, 48, 3)))
    monkeypatch.setattr(tdens, "_split_noise", lambda gen, p: torch.from_numpy(noise))
    tm = tgauss.GaussianModel.from_numpy(f, device="cpu")
    tst = topt.AdamState.from_numpy(state, device="cpu")
    tstats = tdens.densify_and_prune(
        tm, tst, torch.Generator().manual_seed(0), extent=1.0, **kw
    )
    for name in tdens.DensifyStats._fields:
        assert int(getattr(tstats, name)) == int(getattr(jstats, name)), name
    # every outcome occurs: clones, splits, prunes and capacity drops
    assert min(int(x) for x in jstats) > 0, jstats
    got = tm.to_numpy()
    for k in ("active", "exist_since_iter"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jm, k)), err_msg=k)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jm, k)), atol=1e-6, err_msg=k)
    ref = _jstate_np(jst)
    for k, v in tst.to_numpy().items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_reset_opacity_and_stats_match_jax():
    f, state = _densify_inputs(15)
    jm, jst = jdens.reset_opacity(_jmodel(f), _jstate(state))
    tm = tgauss.GaussianModel.from_numpy(f, device="cpu")
    tst = topt.AdamState.from_numpy(state, device="cpu")
    tdens.reset_opacity(tm, tst)
    np.testing.assert_allclose(tm.opacity.detach().numpy(), np.asarray(jm.opacity),
                               atol=1e-6)
    assert (tst.mu["opacity"] == 0).all() and (tst.nu["opacity"] == 0).all()
    np.testing.assert_array_equal(tst.mu["xyz"].numpy(), state["mu/xyz"])

    rng = np.random.default_rng(16)
    ndc = rng.normal(size=(48, 2)).astype(np.float32)
    radii = np.where(rng.uniform(size=48) < 0.5, 0, rng.integers(1, 50, 48)).astype(np.float32)
    jm = jdens.add_densification_stats(_jmodel(f), jnp.asarray(ndc), jnp.asarray(radii))
    tm = tgauss.GaussianModel.from_numpy(f, device="cpu")
    tdens.add_densification_stats(tm, torch.from_numpy(ndc), torch.from_numpy(radii))
    got = tm.to_numpy()
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jm, k)), atol=1e-6, err_msg=k)
