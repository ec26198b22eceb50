"""PyTorch port vs the TPU kernels of the benchmark scripts: the plain
versions of kernels #6 (`reduce_accum`), #7 (`bucket_emit`) and #8
(`kernel_ablate`, all six modes) in `omnigs_torch/scripts/` against the
Pallas kernels of `scripts/reduce_bench.py`, `scripts/bucket_emit_bench.py`
and `scripts/kernel_ablate.py`, run in interpret mode on the CPU (each
`pl.pallas_call` is rebuilt here with ``interpret=True``: the scripts'
own launchers take no interpret flag or pick it from the environment).
Then the scripts' `main`s at small sizes on the CPU, and a subprocess that
imports every new module of the port and renders through every layout with
JAX blocked.

Bars: #7 bitwise (a copy); #6 atol 1e-5 (sums of a few N(0, 1) rows in
another order); #8 atol 1e-5 of max(1, max|ref|) per mode (dma sums raw
pixel coordinates into the thousands, where 1e-5 relative is a few ulps),
lowprec included: both sides round the same f32 values to bf16 with
round-to-nearest-even, so only a prefix sum that differs in its last bit
can flip a rounding (2^-8 relative of one weight), which these inputs do
not (measured: lowprec 2.4e-7 of its 0.55 max)."""

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omnigs_torch.scripts import bucket_emit_bench as tbe
from omnigs_torch.scripts import kernel_ablate as tka
from omnigs_torch.scripts import reduce_bench as trb

from torch_helpers import ablate_slab_np, launches

REPO = Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jscripts():
    return {n: _load_script(n) for n in ("reduce_bench", "bucket_emit_bench", "kernel_ablate")}


def test_reduce_accum_plain_matches_tpu_kernel(jscripts):
    rb = jscripts["reduce_bench"]
    r, p = 512, 64
    rng = np.random.default_rng(61)
    ids = rng.integers(0, p, r).astype(np.int32)
    rows = rng.standard_normal((16, r), dtype=np.float32)
    live = 384
    # pallas_reduce with interpret=True
    ref = pl.pallas_call(
        functools.partial(rb._reduce_kernel, n_chunks=live // rb.CHUNK),
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM), pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rb.NROWS, p), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((2, rb.NROWS, rb.CHUNK), jnp.float32),
            pltpu.SMEM((2, 1, rb.CHUNK), jnp.int32),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )(jnp.asarray(ids[None, :live]), jnp.asarray(rows[:, :live]))
    before = launches("reduce_accum")
    got = trb.reduce_accum(torch.from_numpy(ids[:live]), torch.from_numpy(rows), p)
    assert launches("reduce_accum") == before  # the CPU runs the plain version
    assert got.shape == (16, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    exact = np.zeros((16, p))
    np.add.at(exact.T, ids[:live], rows[:, :live].T.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5)


def _tpu_reduce(rb, ids, rows, p, live):
    """scripts/reduce_bench.py's pallas_reduce with interpret=True."""
    return np.asarray(pl.pallas_call(
        functools.partial(rb._reduce_kernel, n_chunks=live // rb.CHUNK),
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM), pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rb.NROWS, p), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((2, rb.NROWS, rb.CHUNK), jnp.float32),
            pltpu.SMEM((2, 1, rb.CHUNK), jnp.int32),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )(jnp.asarray(ids[None, :live]), jnp.asarray(rows[:, :live])))


@pytest.mark.parametrize("kind", ["skewed", "ragged_p"])
def test_reduce_accum_plain_matches_tpu_kernel_on_hard_ids(jscripts, kind):
    """#6's plain version against the TPU kernel and a float64 sum at the
    reduction bar (rtol 2e-3, atol 1e-4 of the max: sums of up to hundreds
    of N(0, 1) rows in another order) where the card kernel's atomics meet:
    skewed ids (Zipf-like, so ids repeat within each 128-lane window and
    one id takes a large share), and a P that is not a multiple of the
    card kernel's 128-Gaussian transpose tile, with ids up to P − 1."""
    rb = jscripts["reduce_bench"]
    r, live = 1024, 896
    rng = np.random.default_rng(62)
    if kind == "skewed":
        p = 256
        w = np.arange(1, p + 1, dtype=np.float64) ** -1.0
        ids = rng.permutation(p)[rng.choice(p, size=r, p=w / w.sum())].astype(np.int32)
        windows = ids[:live].reshape(-1, rb.CHUNK)
        assert all(len(np.unique(wd)) <= rb.CHUNK * 3 // 4 for wd in windows)
        assert np.bincount(ids[:live]).max() > live // 10
    else:
        p = 4093
        ids = rng.integers(0, p, r).astype(np.int32)
        ids[live - 1] = p - 1
        assert p % 128
    rows = rng.standard_normal((16, r), dtype=np.float32)
    ref = _tpu_reduce(rb, ids, rows, p, live)
    got = trb.reduce_accum(torch.from_numpy(ids[:live]), torch.from_numpy(rows), p).numpy()
    assert got.shape == ref.shape == (16, p)
    exact = np.zeros((16, p))
    np.add.at(exact.T, ids[:live], rows[:, :live].T.astype(np.float64))
    for want in (ref, exact):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4 * np.abs(want).max())
    assert np.abs(got[:, p - 1]).max() > 0


def test_bucket_emit_plain_matches_tpu_kernel(jscripts):
    be = jscripts["bucket_emit_bench"]
    slots, data, keys = tbe.make_inputs(2 * tbe.K)
    assert tbe.K == be.K and slots.shape == (2 * tbe.K, 1) and keys.shape == (2 * tbe.K,)
    ref = pl.pallas_call(
        be._emit_kernel,
        interpret=True,
        grid=(2,),
        in_specs=[
            pl.BlockSpec((be.K, 1), lambda i: (i, 0)),
            pl.BlockSpec((be.K, be.NROWS), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((be.K, be.NROWS), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((2 * be.K, be.NROWS), jnp.float32),
    )(jnp.asarray(slots), jnp.asarray(data))
    got = tbe.bucket_emit(torch.from_numpy(slots), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a permutation inside each block: every row lands once, in its block
    idx = tbe.emit_index(torch.from_numpy(slots)).numpy()
    assert np.array_equal(np.sort(idx), np.arange(2 * tbe.K))
    assert (idx // tbe.K == np.arange(2 * tbe.K) // tbe.K).all()


def _tpu_ablate(ka, mode, slab, starts, counts, x0, y0):
    """scripts/kernel_ablate.py::run with interpret=True → (T, 3, 256)."""
    tpb = ka.TPB
    t = counts.shape[0]
    n_prog = -(-t // tpb)
    pad = n_prog * tpb - t
    scal = [jnp.pad(jnp.asarray(a), (0, pad)) for a in (starts, counts, x0, y0)]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(n_prog,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=[pl.BlockSpec((1, tpb, 3 * ka.PX), lambda i, *_: (i, 0, 0),
                                memory_space=pltpu.VMEM)],
        scratch_shapes=[pltpu.VMEM((2, ka.NROWS, ka.CHUNK), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
    )
    out = pl.pallas_call(
        ka.make_kernel(mode), grid_spec=grid_spec, interpret=True,
        out_shape=[jax.ShapeDtypeStruct((n_prog, tpb, 3 * ka.PX), jnp.float32)],
    )(*scal, jnp.asarray(slab))[0]
    return np.asarray(out).reshape(-1, 3, ka.PX)[:t]


@pytest.mark.parametrize("mode", tka.MODES)
def test_kernel_ablate_plain_matches_tpu_kernel(jscripts, mode):
    slab, starts, counts, x0, y0 = ablate_slab_np(62)
    ref = _tpu_ablate(jscripts["kernel_ablate"], mode, slab, starts, counts, x0, y0)
    args = [torch.from_numpy(a) for a in (slab, starts, counts, x0, y0)]
    got, visited, live, walked = tka.kernel_ablate_plain(mode, *args)
    np.testing.assert_array_equal(tka.kernel_ablate(mode, *args).numpy(), got.numpy())
    bar = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=bar, err_msg=mode)
    n_chunks = -(-counts // 128)
    assert (visited.numpy() <= n_chunks).all() and float(np.abs(ref).max()) > 0
    if mode in ("dma", "alpha"):
        # N never falls below the stop: every chunk is walked
        np.testing.assert_array_equal(visited.numpy(), n_chunks)
    if mode == "full":
        # the dense tiles stop before their last chunk; the empty one is 0
        assert (visited.numpy() < n_chunks).any()
        assert not got[counts == 0].any()
    # the work counts: live pairs lie below the count in the visited chunks,
    # and a warp walks at most those lanes (full: fewer where it stopped)
    below = np.minimum(counts, visited.numpy() * 128)
    walked = walked.numpy()
    assert (walked <= below[:, None]).all() and (live.numpy() <= below * 256).all()
    if mode == "dma":
        assert not live.any()
    else:
        assert (live.numpy()[counts > 0] > 0).all()
        assert (walked == below[:, None]).all() or mode == "full"


def test_script_mains_on_cpu():
    """Each script's `main` at a small size with ``--device cpu``: the
    plain versions run (no launch is counted) and the strategies agree."""
    before = (launches("reduce_accum"), launches("bucket_emit"), launches("kernel_ablate"))
    r = trb.main(["4096", "512", "--device", "cpu", "--reps", "1"])
    assert r["live"] == int(4096 * 0.92) // 128 * 128
    assert r["reduce_accum"]["max_abs_err"] <= 1e-5 and r["sort"]["max_abs_err"] <= 1e-4
    e = tbe.main(["4096", "--device", "cpu", "--reps", "1"])
    assert e["rows"] == 4096 and e["emit_ms"] > 0
    a = tka.main(["--device", "cpu", "--width", "64", "--height", "32", "--gaussians", "128",
                  "--max-instances", "4096", "--cap", "2048", "--reps", "1"])
    assert set(a["ms"]) == set(tka.MODES) and a["instances"] > 0
    assert a["full_vs_tile_fwd_max_abs"] <= 1e-4
    assert (launches("reduce_accum"), launches("bucket_emit"),
            launches("kernel_ablate")) == before


def test_new_modules_import_no_jax():
    """The new modules import and run with ``jax`` and the JAX package
    unimportable: the scripts at tiny sizes and `rasterize` through the
    ghost-aligned, no-presort and XLA layouts."""
    script = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'omnigs_tpu', 'scripts',\n"
        "                                  '__graft_entry__'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from omnigs_torch.scripts import bucket_emit_bench, kernel_ablate, reduce_bench\n"
        "from omnigs_torch.ops import binning, rasterize\n"
        "from omnigs_torch.cameras import Camera, CameraType\n"
        "reduce_bench.main(['2048', '256', '--device', 'cpu', '--reps', '1'])\n"
        "bucket_emit_bench.main(['2048', '--device', 'cpu', '--reps', '1'])\n"
        "kernel_ablate.main(['--device', 'cpu', '--width', '64', '--height', '32',\n"
        "                    '--gaussians', '128', '--max-instances', '4096',\n"
        "                    '--cap', '2048', '--reps', '1'])\n"
        "g = torch.Generator().manual_seed(0)\n"
        "n = 64\n"
        "args = (torch.randn(n, 3, generator=g) * 3, torch.full((n, 3), 0.2),\n"
        "        torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1),\n"
        "        torch.full((n,), 0.8), torch.randn(n, 16, 3, generator=g) * 0.3)\n"
        "kw = dict(camera=Camera(CameraType.LONLAT, 64, 32), viewmatrix=torch.eye(4),\n"
        "          campos=torch.zeros(3), bg=torch.zeros(3), sh_degree=3)\n"
        "base = dict(backend='pallas', tight_culling=True, tile_culling=True,\n"
        "            want_ncontrib=False, max_instances=1 << 12)\n"
        "cfgs = [rasterize.RasterConfig(**base, ghost_align=True),\n"
        "        rasterize.RasterConfig(**base, segmented=True),\n"
        "        rasterize.RasterConfig(max_instances=1 << 12, tile_cap=64, chunk=16)]\n"
        "imgs = []\n"
        "for cfg in cfgs:\n"
        "    leaves = [a.clone().requires_grad_(True) for a in args]\n"
        "    res = rasterize.rasterize(*leaves, config=cfg, **kw)\n"
        "    res.image.sum().backward()\n"
        "    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)\n"
        "    imgs.append(res.image.detach())\n"
        "assert max(float((i - imgs[1]).abs().max()) for i in imgs) <= 1e-5\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'omnigs_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
