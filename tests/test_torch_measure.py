"""PyTorch port vs JAX reference: the measurement layer.

`omnigs_torch/utils/profiling.roofline_report` against the JAX function,
and the port's copies of `scripts/{kernel_bench, bin_bench,
subtile_analysis, converged_bench}.py` on the CPU at small sizes. Each
script is held to the JAX package's functions and expressions on the same
inputs: the roofline's keys at rtol 1e-6 under the JAX constants, the
binning sub-stages, the instance and slab counts, ``n_contrib`` and the
composited instances per tile bitwise (integer layouts), the sub-tile
ratios equal. The JAX scripts themselves run only on a TPU at full size."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera as TCamera
from omnigs_torch.cameras import CameraType as TCameraType
from omnigs_torch.io.ply import load_points_ply, save_gaussian_ply
from omnigs_torch.model.gaussians import from_pcd
from omnigs_torch.ops import preprocess as tpre
from omnigs_torch.ops.knn import mean_sq_knn_dist
from omnigs_torch.scripts import bin_bench as tbb
from omnigs_torch.scripts import converged_bench as tcb
from omnigs_torch.scripts import kernel_bench as tkb
from omnigs_torch.scripts import make_synthetic_scene
from omnigs_torch.scripts import subtile_analysis as tsa
from omnigs_torch.scripts.example import example_model, preprocess_model
from omnigs_torch.utils import profiling as tprof
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.io.openmvg import load_openmvg_scene as jload_scene
from omnigs_tpu.io.ply import load_gaussian_ply as jload_ply
from omnigs_tpu.model.gaussians import GaussianModel as JModel
from omnigs_tpu.ops import binning as jbin
from omnigs_tpu.ops import preprocess as jpre
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from omnigs_tpu.train.renderer import render_model as jrender
from omnigs_tpu.utils import profiling as jprof

REPO = Path(__file__).resolve().parent.parent
W, H = 128, 64
GX, GY = W // 16, H // 16
TILE = 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_prep(prep_t):
    """The port's Preprocessed as the JAX package's."""
    return jpre.Preprocessed(*[jnp.asarray(t.numpy()) for t in prep_t])


def _jax_print_labels(rel_path):
    """Each print of a JAX script up to its first formatted field."""
    return tuple(re.findall(r'print\(\s*f"([^{"]*)', (REPO / rel_path).read_text()))


ROOFLINE_CASES = [
    (1920 * 960, 0.0312, 142.7, 1_020_000),
    (1920 * 960, 0.0521, 226.0, None),
    (128 * 64, 1.7, 3.5, 97),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_roofline_report_matches_jax_under_its_constants(case, monkeypatch):
    """With the port's constants set to the JAX module's (a TPU v5e's peaks
    and 80 ops, 420 B), every key equals the JAX function's."""
    monkeypatch.setattr(tprof, "PEAK_F32_FLOPS", jprof.VPU_ELEM_OPS_PER_S)
    monkeypatch.setattr(tprof, "PEAK_BYTES_PER_S", jprof.V5E_HBM_GBPS * 1e9)
    monkeypatch.setattr(tprof, "INTRINSIC_OPS_PER_PAIR_FWDBWD",
                        jprof.INTRINSIC_OPS_PER_PAIR_FWDBWD)
    monkeypatch.setattr(tprof, "BYTES_PER_INSTANCE_FWDBWD", jprof.BYTES_PER_INSTANCE_FWDBWD)
    got = tprof.roofline_report(*case)
    ref = jprof.roofline_report(*case)
    assert set(got) == set(ref) == {"achieved_px_s", "roofline_px_s", "fraction_of_roofline"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_roofline_floors_are_the_kernel_bounds_terms(case):
    """With the port's own constants the floor is chip_smoke's `_bound`
    operations term of the pairs' fwd + bwd operations plus its bytes term
    of the instances' bytes, and the per-pair counts are the kernel
    bounds' visited + live counts."""
    pixels, seconds, depth, n_inst = case
    assert tprof.INTRINSIC_OPS_PER_PAIR_FWD == (
        tprof.OPS_PER_VISITED_PAIR + tprof.OPS_PER_LIVE_PAIR) == 30
    assert tprof.INTRINSIC_OPS_PER_PAIR_BWD == (
        tprof.OPS_PER_VISITED_PAIR + tprof.BWD_OPS_PER_LIVE_PAIR) == 56
    assert tprof.BYTES_PER_INSTANCE_FWDBWD == 40 + 36 + 72 + 40 + 36
    cs = _chip_smoke()
    if n_inst is None:
        n_inst = pixels * depth / 256
    t_ops, by_ops = cs._bound(pixels * depth * tprof.INTRINSIC_OPS_PER_PAIR_FWDBWD, 0)
    t_bytes, by_bytes = cs._bound(0, n_inst * tprof.BYTES_PER_INSTANCE_FWDBWD)
    assert (by_ops, by_bytes) == ("operations", "bytes")
    got = tprof.roofline_report(*case)
    np.testing.assert_allclose(pixels / got["roofline_px_s"], (t_ops + t_bytes) / 1e3, rtol=1e-12)
    np.testing.assert_allclose(got["achieved_px_s"], pixels / seconds, rtol=1e-12)
    assert got["fraction_of_roofline"] == pytest.approx((t_ops + t_bytes) / 1e3 / seconds)


def _bin_inputs(seed, n, r):
    """(JAX Preprocessed, port Preprocessed) holding the same arrays (the
    port's preprocess of the example model), and the port script's
    sub-stage inputs at ``r`` slots."""
    pt = preprocess_model(example_model(n, "cpu", seed), TCamera(TCameraType.LONLAT, W, H))
    return _jax_prep(pt), pt, tbb.inputs(pt, GX, GY, r)


def _eq(got, ref, name):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype.itemsize == ref.dtype.itemsize, (name, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=name)


def _jax_substages(pj, r, gx, gy):
    """The JAX script's sub-stage expressions (scripts/bin_bench.py:79-163),
    jitted as the script runs them."""
    num_tiles, chunk, n = gx * gy, tbb.CHUNK, pj.depths.shape[0]
    tiles = pj.tiles_touched.astype(jnp.int32)
    offsets = jnp.cumsum(tiles) - tiles
    owner = jbin._owner_of_slot(offsets, r)
    g = jnp.clip(owner, 0, n - 1)
    table = jnp.concatenate(
        [pj.rect.astype(jnp.float32), pj.depths[:, None], pj.means2d, pj.conic,
         pj.opacity[:, None]], axis=-1)
    rows = table[g]
    j = jnp.arange(r, dtype=jnp.int32)
    x0 = rows[:, 0].astype(jnp.int32)
    width = jnp.maximum(rows[:, 2].astype(jnp.int32) - x0, 1)
    local = j - offsets[g]
    raw = (rows[:, 1].astype(jnp.int32) + local // width) * gx + x0 + local % width
    tile_id = jnp.clip(raw, 0, num_tiles)
    tx, ty = tile_id % gx, tile_id // gx
    px0, py0 = (tx * TILE).astype(jnp.float32), (ty * TILE).astype(jnp.float32)
    mx, my = rows[:, 5], rows[:, 6]
    qmin = jbin._min_quad_over_box(rows[:, 7], rows[:, 8], rows[:, 9], px0 - mx,
                                   px0 + (TILE - 1) - mx, py0 - my, py0 + (TILE - 1) - my)
    keep = rows[:, 10] * jnp.exp(-0.5 * qmin) >= 1.0 / 255.0
    counts = jbin.tile_cover_counts(pj.rect, tiles > 0, gx, gy)
    padded = ((counts + chunk - 1) // chunk) * chunk
    n_ghost = num_tiles * chunk
    gc = padded - counts
    gtile = jnp.clip(jbin._owner_of_slot(jnp.cumsum(gc) - gc, n_ghost), 0, num_tiles - 1)
    all_tile = jnp.concatenate(
        [tile_id, jnp.where(jnp.arange(n_ghost) < jnp.sum(padded - counts), gtile, num_tiles)])
    all_depth = jnp.concatenate([rows[:, 4], jnp.full((n_ghost,), jnp.inf)])
    all_g = jnp.concatenate([g, jnp.zeros((n_ghost,), jnp.int32)])
    m = SLICE
    return dict(
        offsets=offsets, owner=owner, g=g, rows=rows, raw=raw, tile_id=tile_id, keep=keep,
        counts=counts, gtile=gtile, all_tile=all_tile, all_depth=all_depth, all_g=all_g,
        sort2=jax.lax.sort((all_tile, all_depth, all_g), num_keys=2, is_stable=True),
        sort2_slice=jax.lax.sort((all_tile[:m], all_depth[:m], all_g[:m]), num_keys=2,
                                 is_stable=True))


def _jax_packed_sort(all_tile, all_depth, all_g):
    """The JAX script's packed key and its sort (bin_bench.py:153-159),
    under 64-bit mode, where the int64 it spells is an int64."""
    db = jax.lax.bitcast_convert_type(all_depth, jnp.int32)
    key = (all_tile.astype(jnp.int64) << 32) | db.astype(jnp.uint32).astype(jnp.int64)
    return (key,) + tuple(jax.lax.sort((key, all_g), num_keys=1, is_stable=True))


SLICE = 300  # entries of the sliced sort: it ends inside the instances


@pytest.mark.parametrize("seed,n,r", [(3, 300, 2048), (4, 200, 256)])
def test_bin_bench_substages_match_jax(seed, n, r):
    """Every sub-stage of the port's bin_bench against the JAX script's
    expressions on the same preprocess output, bitwise: slot owners, the
    row gather, expansion, cull, tile cover counts, ghosts, the 2-key sort
    (two stable sorts), the packed key and its sort, and the sort of a
    slice. The second case runs out of slots (R below the emission)."""
    pj, pt, x = _bin_inputs(seed, n, r)
    ref = jax.jit(_jax_substages, static_argnums=(1, 2, 3))(pj, r, GX, GY)
    for k in ("offsets", "g", "rows", "tile_id", "counts", "all_tile", "all_depth", "all_g"):
        _eq(x[k], ref[k], k)
    _eq(tbb._owner_of_slot(x["offsets"], r), ref["owner"], "owner_of_slot")
    _eq(tbb.expand(x["rows"], x["g"], x["offsets"], GX), ref["raw"], "expansion")
    _eq(tbb.cull(x["rows"], x["tile_id"], GX), ref["keep"], "tile-cull")
    _eq(tbb.ghosts(x["padded"], x["counts"], GX * GY), ref["gtile"], "ghosts")
    sort_in = (x["all_tile"], x["all_depth"], x["all_g"])
    for k, (a, b) in enumerate(zip(tbb.sort2(*sort_in), ref["sort2"])):
        _eq(a, b, f"2-key sort {k}")
    for k, (a, b) in enumerate(zip(tbb.sort2(*(t[:SLICE] for t in sort_in)), ref["sort2_slice"])):
        _eq(a, b, f"sliced sort {k}")
    with jax.enable_x64(True):
        key, skey, sg = jax.jit(_jax_packed_sort)(ref["all_tile"], ref["all_depth"], ref["all_g"])
        _eq(tbb.packed_key(*sort_in[:2]), key, "packed key")
        _eq(tbb.sort_packed(*sort_in)[0], skey, "packed sort keys")
        _eq(tbb.sort_packed(*sort_in)[1], sg, "packed sort payload")
    # the ghosts' +inf depth sorts after every instance of its tile
    keys = tbb.sort_packed(*sort_in)[0]
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = (keys[1:] >> 32) != (keys[:-1] >> 32)
    inf_bits = torch.tensor([np.inf], dtype=torch.float32).view(torch.int32).to(torch.int64)
    is_inf = (keys & 0xFFFFFFFF) == inf_bits
    assert bool(is_inf.any())
    assert not bool((is_inf[:-1] & ~is_inf[1:] & ~last[:-1]).any())


def test_bin_bench_runs_on_cpu(capsys):
    """`run` prints every line of the JAX script on the CPU."""
    assert tbb.STAGE_LINES == _jax_print_labels("scripts/bin_bench.py")
    out = tbb.run("cpu", 64, 32, 64, 1 << 12)
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["lines"] and len(printed) == len(tbb.STAGE_LINES)
    for label, line in zip(tbb.STAGE_LINES, printed):
        assert line.startswith(label) and line.endswith(" host"), line
    assert set(out["measures"].values()) == {"host"}


def test_device_busy_us_is_the_union_of_device_spans():
    """`device_busy_us` counts each µs in which some device op of a Chrome
    trace runs once: overlaps and nested ops merge, host ops and other
    phases are left out."""
    def op(ts, dur, cat="kernel", ph="X"):
        return {"ts": ts, "dur": dur, "cat": cat, "ph": ph}

    events = [op(0, 10), op(5, 10, "gpu_memcpy"), op(6, 2), op(30, 5, "gpu_memset"),
              op(40, 100, "cpu_op"), op(50, 7, ph="i"), op(33, 1)]
    assert tprof.device_busy_us(events) == 20.0
    assert tprof.device_busy_us([]) == 0.0


KB_ARGS = dict(width=64, height=32, gaussians=100, max_instances=1024, cap=128)


def test_kernel_bench_cpu_lines_and_counts_match_jax(capsys):
    """The port's kernel_bench at a tiny size on the CPU prints every line
    of the JAX script; its five reductions sum the backward's rows (the
    repository's reduction bar against a float64 sum); its instance counts
    (the compact binning with the script's trim, here at a cap that drops
    tiles) and the relay's live8 and truncation equal the JAX functions'
    on the same preprocess."""
    assert tkb.STAGE_LINES == _jax_print_labels("scripts/kernel_bench.py")
    argv = ["--device", "cpu"] + [
        a for k, v in KB_ARGS.items() for a in (f"--{k.replace('_', '-')}", str(v))]
    out = tkb.main(argv)
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["lines"]
    for label in tkb.STAGE_LINES:
        assert any(line.startswith(label) for line in printed), label
    assert set(out["measures"].values()) == {"host"}
    # each kernel's first output beside its plain version on the same inputs
    assert set(out["kernels"]) == {"composite_seg_fwd", "composite_seg_bwd",
                                   "composite_tile_fwd", "composite_tile_bwd",
                                   "composite_tile_bwd_fused"}
    for name, (got, plain) in out["kernels"].items():
        got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, plain()))
        assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref)), name
    # each reduction variant sums the backward's rows per Gaussian
    rows, ids = out["reduced_rows"]
    exact = torch.zeros(KB_ARGS["gaussians"], 9, dtype=torch.float64).index_add_(
        0, ids.to(torch.int64), rows.T.double())
    assert set(out["reductions"]) == {"red_scatter9", "red_scatter16", "red_scatter_live",
                                      "red_gather", "red_sortsum"}
    for k, fn in out["reductions"].items():
        got = fn()[:, :9].double()
        tol = 1e-4 * exact.abs().amax(dim=0) + 2e-3 * exact.abs()
        assert bool(((got - exact).abs() <= tol).all()), k

    camera = TCamera(TCameraType.LONLAT, KB_ARGS["width"], KB_ARGS["height"])
    gx, gy = tpre.tile_grid(camera)
    P, R, cap = KB_ARGS["gaussians"], KB_ARGS["max_instances"], KB_ARGS["cap"]
    pj = _jax_prep(preprocess_model(example_model(P, "cpu"), camera))
    # jitted, as the JAX script runs them
    inst = jax.jit(jbin.bin_instances, static_argnums=(1, 2, 3),
                   static_argnames="tile_cull")(pj, gx, gy, R, tile_cull=True)
    fits = inst.starts + inst.counts <= cap
    counts = jnp.where(fits, inst.counts, 0)
    assert not bool(jnp.all(fits)), "the cap should drop a tile"
    assert out["instances"] == {"emitted": int(inst.num_instances),
                                "composited": int(jnp.sum(counts)),
                                "truncated": int(inst.truncated)}
    seg = jax.jit(jbin.segment_relay, static_argnums=(4, 5))(
        inst.sorted_g, None, inst.starts, inst.counts, cap, P)
    assert out["seg"]["live8"] == int(seg.live8)
    assert out["seg"]["truncated"] == int(seg.truncated) > 0
    assert out["seg"]["pad"] == int(seg.live8) - int(jnp.sum(counts))


def _jax_subtile_ratios(nc, gx, gy):
    """The arithmetic of scripts/subtile_analysis.py:56-72."""
    nc = np.asarray(nc).reshape(gy, TILE, gx, TILE).transpose(0, 2, 1, 3)
    CH = 128

    def chunks(maxr):
        return np.ceil(maxr / CH)

    whole = chunks(nc.reshape(gy, gx, -1).max(-1)).sum() * 4
    q = nc.reshape(gy, gx, 2, 8, 2, 8).transpose(0, 1, 2, 4, 3, 5)
    quad = chunks(q.reshape(gy, gx, 4, -1).max(-1)).sum()
    h = nc.reshape(gy, gx, 2, 8, 16)
    half = chunks(h.reshape(gy, gx, 2, -1).max(-1)).sum() * 2
    return quad / whole, half / whole


SW, SH = 64, 32  # the sub-tile test's panorama


def test_subtile_analysis_matches_jax(capsys):
    """n_contrib of the script's render equals the JAX package's through
    the tile-major route on the same model (jitted as the JAX script runs
    it, Pallas in interpret mode), bitwise; the ratios equal the JAX
    script's arithmetic."""
    n, r, cap = 200, 1 << 12, 1 << 11
    out = tsa.run("cpu", SW, SH, n, r, cap)
    assert "quadrant-chunk-work / whole-tile:" in capsys.readouterr().out
    f = example_model(n, "cpu").to_numpy()
    jm = JModel(**{k: jnp.asarray(v) for k, v in f.items()})
    cfg = JRasterConfig(max_instances=r, aligned_cap=cap, backend="pallas",
                        tight_culling=True, tile_culling=True, want_ncontrib=True,
                        interpret=True)
    res = jax.jit(lambda m: jrender(m, Camera(CameraType.LONLAT, SW, SH), jnp.eye(4),
                                    jnp.zeros(3), jnp.zeros(3), sh_degree=3, config=cfg))(jm)
    ref = np.asarray(res.n_contrib)
    assert out["truncated"] == int(res.truncated) == 0
    assert ref.max() > 0
    np.testing.assert_array_equal(out["n_contrib"], ref)
    quad, half = _jax_subtile_ratios(ref, SW // TILE, SH // TILE)
    assert (out["quadrant_ratio"], out["half_ratio"]) == (quad, half)
    assert out["saving_bound"] == 1.0 - quad
    # a handmade field where the quadrants stop apart
    nc = np.zeros((H, W), np.int32)
    nc[:8, :8], nc[40:48, 24:32] = 300, 129
    got = tsa.subtile_chunks(nc, GX, GY)
    assert (got["quadrant_ratio"], got["half_ratio"]) == _jax_subtile_ratios(nc, GX, GY)
    assert got["quadrant_ratio"] < got["half_ratio"] < 1.0


def test_converged_bench_counts_match_jax(tmp_path):
    """The converged leg on a synthetic scene and a Gaussian PLY made from
    its points, on the CPU: finite times, and the composited instances per
    tile equal the JAX script's count on the same PLY and pose."""
    scene = tmp_path / "scene"
    make_synthetic_scene.main([str(scene), "--width", "64", "--height", "32", "--gaussians",
                               "96", "--train-views", "2", "--test-views", "1",
                               "--device", "cpu"])
    pts, cols = load_points_ply(scene / "points.ply")
    p = torch.from_numpy(pts)
    ply = tmp_path / "model.ply"
    save_gaussian_ply(ply, from_pcd(p, torch.from_numpy(cols), 128, mean_sq_knn_dist(p)))
    sj = scene / "sfm_data_train.json"
    r, cap = 1 << 14, 1 << 13
    out = tcb.run(ply, sj, "cpu", W, H, capacity=256, max_instances=r, aligned_cap=cap,
                  iters=1, warmup=1)
    assert np.isfinite(out["px_s"]) and out["ms_per_step"] > 0 and out["device"] == "cpu"
    assert all(bool(torch.isfinite(g).all()) for g in out["grads"].values())
    assert any(bool(g.abs().max() > 0) for g in out["grads"].values())

    model = jload_ply(str(ply), capacity=256)
    sc = jload_scene(str(sj), None, image_root=None)
    kf = sc.keyframes[sorted(sc.keyframes)[0]]

    @jax.jit
    def count(vm, cp):  # scripts/converged_bench.py:88-105, jitted as there
        prep = jpre.preprocess(
            model.xyz, jnp.exp(model.scaling),
            model.rotation / jnp.linalg.norm(model.rotation, axis=-1, keepdims=True),
            jax.nn.sigmoid(model.opacity[:, 0]),
            jnp.concatenate([model.features_dc, model.features_rest], axis=1),
            Camera(CameraType.LONLAT, W, H), vm, cp, 3, tight_culling=True,
            active_mask=model.active,
        )
        return jnp.sum(jbin.bin_instances(prep, GX, GY, r, tile_cull=True).counts)

    ref = int(count(jnp.asarray(kf.viewmatrix), jnp.asarray(kf.campos))) / (GX * GY)
    assert ref > 0
    assert out["instances_per_tile"] == ref
