"""One training step of a seeded render model through the XLA backend in
three versions: the port in float32 and in float64, and the JAX package in
float32. Prints, per parameter group, how the two float32 steps' Adam first
moments (0.1·gradient after one step) sit against the float64 step's at
the JAX package's Pallas-vs-XLA bar (rtol 1e-3, atol 1e-4·max|ref|): the
Gaussians each misses, those only the port misses and those only the JAX
package misses, and how far apart the two float32 steps lie.

``--ndc2pix-once`` runs the port's float32 step with `cameras.ndc2pix`
rounded once (computed in float64), as XLA's compiled arithmetic on a CPU
contracts its two multiply-adds into fused ones. ``--jax-eager`` runs the
JAX step op by op (``jax.disable_jit()``), each operation rounded as
written, as the port rounds them.

    python tests/xla_gap_step.py [--width 960 --height 480 --gaussians 131072]
        [--seed 0] [--ndc2pix-once] [--jax-eager]

CPU only (JAX and PyTorch in one process); at the default size it takes
about 5 minutes and 5 GiB.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import omnigs_torch.cameras as cams  # noqa: E402
from omnigs_torch.cameras import Camera as TCamera  # noqa: E402
from omnigs_torch.cameras import CameraType as TCameraType  # noqa: E402
from omnigs_torch.model import optimizer as topt  # noqa: E402
from omnigs_torch.model.gaussians import PARAM_NAMES  # noqa: E402
from omnigs_torch.model.gaussians import GaussianModel as TModel  # noqa: E402
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig  # noqa: E402
from omnigs_torch.train import trainer as ttrainer  # noqa: E402
from omnigs_torch.train.renderer import render_model as trender  # noqa: E402
from omnigs_tpu.cameras import Camera, CameraType  # noqa: E402
from omnigs_tpu.model import optimizer as jopt  # noqa: E402
from omnigs_tpu.model.gaussians import GaussianModel as JModel  # noqa: E402
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig  # noqa: E402
from omnigs_tpu.train import trainer as jtrainer  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4
STEP = 3001
SH_DEGREE = 3
MAX_INSTANCES = 1 << 22
XLA_KW = dict(backend="xla", tile_cap=1024, chunk=32, tight_culling=True)


def render_model_np(p, seed=0):
    """The render model of chip_smoke.py (`synthetic_model`) at P = ``p``."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(p, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    f = dict(
        xyz=d * (1.0 + rng.uniform(size=(p, 1)) * 4.0),
        features_dc=rng.normal(size=(p, 1, 3)) * 0.5,
        features_rest=rng.normal(size=(p, 15, 3)) * 0.05,
        scaling=rng.normal(size=(p, 3)) * 0.3 - 3.5,
        rotation=rng.normal(size=(p, 4)),
        opacity=rng.normal(size=(p, 1)),
        max_radii2d=np.zeros(p),
        xyz_gradient_accum=np.zeros(p),
        denom=np.zeros(p),
    )
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["active"] = np.ones(p, bool)
    f["exist_since_iter"] = np.zeros(p, np.int32)
    return f


def pose_np(k):
    """chip_smoke.py's request pose k: yaw k·90°, a small pitch and offset."""
    yaw, pitch = k * math.pi / 2, 0.1 * (k - 1.5)
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    rot = rx @ ry
    campos = np.array([0.05 * k, -0.03 * k, 0.02 * k], np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = rot
    vm[:3, 3] = -rot @ campos
    return vm, campos


def port_step(fields, dtype, camera, vm, campos, gt):
    wide = {k: v.astype(np.float64) if v.dtype == np.float32 and dtype == torch.float64
            else v for k, v in fields.items()}
    m = TModel.from_numpy(wide, device="cpu")
    st = topt.init_adam(m.params())
    aux = ttrainer.train_step(
        m, st, torch.from_numpy(vm).to(dtype)[None], torch.from_numpy(campos).to(dtype)[None],
        torch.from_numpy(gt).to(dtype)[None], STEP, camera=camera, sh_degree=SH_DEGREE,
        raster_cfg=TRasterConfig(max_instances=MAX_INSTANCES, **XLA_KW),
        lr_cfg=topt.LRConfig(), spatial_lr_scale=1.0, bg=torch.zeros(3, dtype=dtype),
    )
    return float(aux["loss"]), {k: st.mu[k].numpy().astype(np.float64) for k in PARAM_NAMES}


def jax_step(fields, camera, vm, campos, gt):
    model = JModel(**{k: jnp.asarray(v) for k, v in fields.items()})
    state = jopt.init_adam(model.params())
    _, state, aux = jtrainer.train_step(
        model, state, jnp.asarray(vm), jnp.asarray(campos), jnp.asarray(gt),
        jnp.asarray(STEP), camera=camera, sh_degree=SH_DEGREE,
        raster_cfg=JRasterConfig(max_instances=MAX_INSTANCES, **XLA_KW),
        lr_cfg=jopt.LRConfig(), spatial_lr_scale=1.0, bg=jnp.zeros(3),
    )
    return float(aux["loss"]), {k: np.asarray(state.mu[k], np.float64) for k in PARAM_NAMES}


def ndc2pix_once(v, size):
    """`cameras.ndc2pix` with one rounding of ((v + 1)·size − 1)/2."""
    if v.dtype == torch.float32:
        return ((v.double() + 1.0) * size - 1.0).float() * 0.5
    return ((v + 1.0) * size - 1.0) * 0.5


def bar_ratio(got, ref):
    """Per Gaussian: max |got − ref| / (ATOL·max|ref| + RTOL·|ref|)."""
    ref = ref.reshape(ref.shape[0], -1)
    err = np.abs(got.reshape(ref.shape) - ref)
    tol = ATOL * np.abs(ref).max() + RTOL * np.abs(ref)
    return np.where(err == 0, 0.0, err / tol).max(axis=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ndc2pix-once", action="store_true")
    ap.add_argument("--jax-eager", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    fields = render_model_np(args.gaussians, args.seed)
    w, h = args.width, args.height
    tcam, jcam = TCamera(TCameraType.LONLAT, w, h), Camera(CameraType.LONLAT, w, h)
    vm1, campos1 = pose_np(1)
    with torch.no_grad():
        gt = trender(TModel.from_numpy(fields, device="cpu"), tcam, torch.from_numpy(vm1),
                     torch.from_numpy(campos1), torch.zeros(3), SH_DEGREE,
                     TRasterConfig(max_instances=MAX_INSTANCES, **XLA_KW)).image.numpy()
    vm, campos = pose_np(0)
    losses, mus = {}, {}
    plain = cams.ndc2pix
    if args.ndc2pix_once:
        cams.ndc2pix = ndc2pix_once
    losses["port32"], mus["port32"] = port_step(fields, torch.float32, tcam, vm, campos, gt)
    cams.ndc2pix = plain
    losses["port64"], mus["port64"] = port_step(fields, torch.float64, tcam, vm, campos, gt)
    with jax.disable_jit(args.jax_eager):
        losses["jax32"], mus["jax32"] = jax_step(fields, jcam, vm, campos, gt)
    out = {"size": [w, h, args.gaussians], "seed": args.seed,
           "ndc2pix_once": args.ndc2pix_once, "jax_eager": args.jax_eager, "bar": [RTOL, ATOL], "losses": losses,
           "params": {}}
    for k in PARAM_NAMES:
        exact = mus["port64"][k]
        port = bar_ratio(mus["port32"][k], exact)
        ref = bar_ratio(mus["jax32"][k], exact)
        apart = bar_ratio(mus["port32"][k], mus["jax32"][k])
        only_port = np.nonzero((port > 1.0) & (ref <= 1.0))[0]
        only_jax = np.nonzero((ref > 1.0) & (port <= 1.0))[0]
        out["params"][k] = {
            "port32_max_ratio": float(port.max()),
            "jax32_max_ratio": float(ref.max()),
            "port32_misses": int((port > 1.0).sum()),
            "jax32_misses": int((ref > 1.0).sum()),
            "port_only_misses": only_port[:20].tolist(),
            "port_only_ratios": [[float(port[i]), float(ref[i])] for i in only_port[:20]],
            "jax_only_misses": only_jax[:20].tolist(),
            "port32_vs_jax32_max_ratio": float(apart.max()),
        }
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
