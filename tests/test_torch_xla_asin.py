"""The lonlat projection's asin: where the port's float32 training step and
the JAX package's op-by-op one part (ROADMAP queue 3, reference-side
behaviours; `tests/xla_gap_stages.py` localises it).

`torch.asin` is within 1 ulp of the correctly rounded asin on every
float32 input; XLA's float32 asin on a CPU (JAX op by op) is within 2 ulp
and off the correctly rounded value on many more inputs. Near the poles
(|y/r| → 1) the asin multiplies that ulp: Gaussian 17272 of the 480×240,
P = 32,768, seed-2 case gets a pixel y 1.4e-5 apart in the two packages,
and its gradients read 1.20× the JAX bar in the port, 0.009× in JAX. The
port keeps `torch.asin`; the test holds both facts."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import omnigs_torch.cameras as tcams
import omnigs_tpu.cameras as jcams


def _ulps(got, ref):
    return np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))


def test_asin_ulps_port_vs_xla():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 4096),
                        np.sign(rng.normal(size=4096)) * (1 - rng.uniform(0, 0.02, 4096))])
    x = x.astype(np.float32)
    exact = np.arcsin(x.astype(np.float64)).astype(np.float32)
    port = torch.asin(torch.from_numpy(x)).numpy()
    with jax.disable_jit():
        xla = np.asarray(jnp.arcsin(jnp.asarray(x)))
    assert _ulps(port, exact).max() <= 1
    assert _ulps(xla, exact).max() == 2
    assert (xla != exact).sum() > 3 * (port != exact).sum()


def _gaussian_17272_in_camera():
    """`xla_gap_step.render_model_np(32768, 2)`'s mean 17272 in the frame of
    its pose 0 (camera at the origin, yaw 0, pitch −0.15)."""
    rng = np.random.default_rng(2)
    d = rng.normal(size=(32768, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    xyz = (d * (1.0 + rng.uniform(size=(32768, 1)) * 4.0)).astype(np.float32)
    p = -0.15
    rx = np.array([[1, 0, 0], [0, np.cos(p), -np.sin(p)], [0, np.sin(p), np.cos(p)]],
                  np.float32)
    return torch.from_numpy(xyz[17272:17273]) @ torch.from_numpy(rx).T


def test_near_pole_gaussian_parts_at_the_asin():
    t = _gaussian_17272_in_camera()
    arg = (t[:, 1] / (torch.sqrt(torch.sum(t * t, dim=-1)) + 1e-7)).numpy()
    assert abs(float(arg[0])) > 0.99  # 6.2° from the pole
    port_y = tcams.lonlat_project(t, 480, 240)[0][0, 1].item()
    with jax.disable_jit():
        xla_y = float(jcams.lonlat_project(jnp.asarray(t.numpy()), 480, 240)[0][0, 1])
    assert 1e-5 < abs(port_y - xla_y) < 3e-5
    exact = np.arcsin(arg.astype(np.float64)).astype(np.float32)
    assert torch.asin(torch.from_numpy(arg)).numpy()[0] == exact[0]
    with jax.disable_jit():
        assert np.asarray(jnp.arcsin(jnp.asarray(arg)))[0] != exact[0]
