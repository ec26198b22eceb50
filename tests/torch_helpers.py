"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port see bit-identical data. JAX stays on the CPU
(conftest) and the port runs with ``device="cpu"``.
"""

import runpy
import sys
from pathlib import Path

import numpy as np
import torch

from omnigs_torch.utils import profiling


def launches(*wrappers):
    """The launches so far of the kernel behind each of ``wrappers`` (the
    wrappers' names, `utils.profiling.counters`): a count, or a tuple of
    them."""
    got = profiling.counters()["launches"]
    counts = tuple(got.get(w, 0) for w in wrappers)
    return counts[0] if len(wrappers) == 1 else counts


def window_key(tr, k=1, **changes):
    """The `capture_key` of a window of ``k`` steps from the trainer's state,
    as `train_steps_fused` builds it for `Trainer.train_window` (``changes``:
    keywords of `capture_key` to replace)."""
    from omnigs_torch.train.trainer import capture_key

    _, vms, cps = tr._pose_bank()
    tr._bank_rows([])
    kw = dict(tr._step_kwargs(tr.camera, tr._schedule(tr.iteration + k)[0]), mesh=tr.mesh)
    kw.update(changes)
    return capture_key(tr.model, tr.opt_state, vms, cps, tr._gt_bank[1], tr._mask(tr.camera),
                       **kw)


def random_cloud_np(seed, n, spread=4.0, n_sh=16, min_r=1.0, scale_mu=-1.5):
    """Random valid Gaussians around the origin, activated parameters
    (the numpy analog of helpers.random_cloud)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    r = min_r + rng.uniform(size=(n, 1)) * spread
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 + scale_mu)
    opac = 0.97 / (1.0 + np.exp(-rng.normal(size=(n,)) * 2.0))
    sh = rng.normal(size=(n, n_sh, 3)) * 0.3
    out = dict(means3d=d * r, scales=scales, quats=quats, opacities=opac, shs=sh)
    return {k: v.astype(np.float32) for k, v in out.items()}


def random_model_np(seed, capacity, n, scale_mu=-1.5):
    """The eleven raw fields of a GaussianModel (n active of ``capacity``)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    f = dict(
        xyz=np.zeros((capacity, 3)),
        features_dc=np.zeros((capacity, 1, 3)),
        features_rest=np.zeros((capacity, 15, 3)),
        scaling=np.full((capacity, 3), -10.0),
        rotation=np.zeros((capacity, 4)),
        opacity=np.full((capacity, 1), -10.0),
        max_radii2d=np.zeros(capacity),
        xyz_gradient_accum=np.zeros(capacity),
        denom=np.zeros(capacity),
    )
    f["rotation"][:, 0] = 1.0
    f["xyz"][:n] = d * (1.0 + rng.uniform(size=(n, 1)) * 4.0)
    f["scaling"][:n] = rng.normal(size=(n, 3)) * 0.3 + scale_mu
    f["rotation"][:n] = rng.normal(size=(n, 4))
    f["opacity"][:n] = rng.normal(size=(n, 1))
    f["features_dc"][:n] = rng.normal(size=(n, 1, 3)) * 0.5
    f["features_rest"][:n] = rng.normal(size=(n, 15, 3)) * 0.2
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["active"] = np.arange(capacity) < n
    f["exist_since_iter"] = np.zeros(capacity, np.int32)
    return f


def to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


# the production RasterConfig knobs (config.raster_config_from defaults)
PROD_KW = dict(
    backend="pallas", tight_culling=True, tile_culling=True,
    want_ncontrib=False, depth_presort=True, segmented=True,
    gather_reduce=True,
)


def ablate_slab_np(seed, counts=(0, 5, 128, 200, 300, 77, 260, 129), gx=4, gaps=None):
    """A (16, L) f32 slab for the ablation kernel (#8) and its (T,) int32
    starts, counts, x0, y0: every tile's segment padded to 128 lanes (pad
    lanes hold random rows too, as ghost lanes hold Gaussian 0's), or, with
    ``gaps`` (T,) given, each segment starting ``gaps`` lanes after the
    previous one's last lane (unaligned starts; a tile's chunks then reach
    into the next tile's lanes); splats around their tile with conics of
    1.5–6 px, opacities up to 0.99 (so dense tiles stop early) and colors
    in [0, 1]."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    padded = -(-counts // 128) * 128
    step = padded if gaps is None else counts + np.asarray(gaps, np.int32)
    starts = (np.cumsum(step) - step).astype(np.int32)
    t = np.arange(len(counts))
    x0 = ((t % gx) * 16).astype(np.int32)
    y0 = ((t // gx) * 16).astype(np.int32)
    lanes = int(starts[-1] + padded[-1]) + 128
    owner = np.clip(np.searchsorted(starts, np.arange(lanes), side="right") - 1, 0, None)
    slab = np.zeros((16, lanes), np.float32)
    slab[0] = x0[owner] + rng.uniform(-4.0, 20.0, lanes)
    slab[1] = y0[owner] + rng.uniform(-4.0, 20.0, lanes)
    sx, sy = rng.uniform(1.5, 6.0, (2, lanes))
    slab[2], slab[4] = 1.0 / sx**2, 1.0 / sy**2
    slab[3] = rng.uniform(-0.2, 0.2, lanes) * np.sqrt(slab[2] * slab[4])
    slab[5] = rng.uniform(0.05, 0.99, lanes)
    slab[6:9] = rng.uniform(0.0, 1.0, (3, lanes))
    return slab, starts, counts, x0, y0


REPO = Path(__file__).resolve().parent.parent
# the small synthetic scene the CLI-path tests share (64×32 lonlat)
SCENE_ARGS = ("--width", "64", "--height", "32", "--gaussians", "96",
              "--train-views", "3", "--test-views", "1", "--seed", "5")


def run_jax_script(rel_path, argv):
    """Run a script of the JAX package's tree (``scripts/…``,
    ``examples/…``) as ``__main__`` in this process, JAX on the CPU."""
    old = sys.argv
    sys.argv = [str(REPO / rel_path), *map(str, argv)]
    try:
        runpy.run_path(str(REPO / rel_path), run_name="__main__")
    finally:
        sys.argv = old


def tiny_yaml(path, **keys):
    """cfg/lonlat/synthetic_medium.yaml with small capacities and the given
    ``Section.key`` overrides (``Tpu__fuse_steps=4``), written to ``path``."""
    keys = {"Tpu.capacity": 256, "Tpu.max_instances": 16384,
            **{k.replace("__", "."): v for k, v in keys.items()}}
    lines = []
    for line in (REPO / "cfg" / "lonlat" / "synthetic_medium.yaml").read_text().splitlines():
        key = line.split(":", 1)[0].strip()
        if key in keys:
            line = f"{key}: {keys.pop(key)}"
        lines.append(line)
    lines += [f"{k}: {v}" for k, v in keys.items()]
    Path(path).write_text("\n".join(lines) + "\n")
    return Path(path)
