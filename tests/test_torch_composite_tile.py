"""PyTorch port vs JAX reference: the tile-major compositing path
(omnigs_torch/ops/composite_tile.py) and the survivor-rank payload of the
packed binning, on the same inputs.

The port runs its plain versions (what the wrappers run for CPU tensors);
JAX runs its Pallas kernels in interpret mode. Bars: integer layouts and
the slab bitwise; color and final_T atol 1e-5 and n_contrib bitwise
(tests/test_pallas_raster.py's forward bars); gradient rows and reductions
at the JAX suite's gradient bars (rtol 2e-3, atol 1e-4·max|ref|,
tests/test_gather_reduce.py). The CUDA kernels are held against the plain
versions on the card in tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnigs_torch.ops import binning as tbin
from omnigs_torch.ops import composite_tile as tct
from omnigs_torch.ops import preprocess as tpre
from omnigs_tpu.cameras import Camera, CameraType
from omnigs_tpu.ops import binning as jbin
from omnigs_tpu.ops import pallas_raster as jpr
from omnigs_tpu.ops import preprocess as jpre

from torch_helpers import launches, random_cloud_np

W, H = 64, 32
GX, GY = W // 16, H // 16
T = GX * GY
KEYS = ("means3d", "scales", "quats", "opacities", "shs")
INTS = ("sorted_g", "starts", "counts", "x0", "y0", "perm", "inv_perm",
        "sorted_e", "seg_lo", "seg_hi")


def _prep_pair(seed, n, squeeze=None):
    """(JAX Preprocessed, torch Preprocessed) holding identical arrays."""
    c = random_cloud_np(seed, n)
    if squeeze is not None:
        c["means3d"] = c["means3d"] * np.asarray(squeeze, np.float32)
    pj = jpre.preprocess(
        *[jnp.asarray(c[k]) for k in KEYS], Camera(CameraType.LONLAT, W, H),
        jnp.eye(4), jnp.zeros(3), 2, tight_culling=True,
    )
    arrays = [np.array(x) for x in pj]
    return (jpre.Preprocessed(*[jnp.asarray(a) for a in arrays]),
            tpre.Preprocessed(*[torch.from_numpy(a) for a in arrays]))


def _layout(seed, n, max_instances, squeeze=None, binning="packed"):
    """JAX pipeline → compact slab, layout and per-Gaussian arrays (numpy),
    the forward's color_full over bg and a seeded dL/dcolor. ``binning``:
    the packed key with the survivor-rank payload ("packed"), the 2-key
    binning ("two_key") or the ghost-aligned one ("ghost")."""
    pj, _ = _prep_pair(seed, n, squeeze)
    if binning == "packed":
        inst = jbin.bin_instances_packed(
            pj, GX, GY, max_instances, tile_cull=True, with_emission=True
        )
    elif binning == "two_key":
        inst = jbin.bin_instances(pj, GX, GY, max_instances, tile_cull=True)
    else:
        inst = jbin.bin_instances_aligned(
            pj, GX, GY, max_instances, jpr.CHUNK, tile_cull=True
        )
    g = {k: np.array(getattr(pj, k)) for k in ("means2d", "conic", "rgb", "opacity")}
    slab = jpr._build_inst(
        *[jnp.asarray(g[k]) for k in ("means2d", "conic", "rgb", "opacity")],
        inst.sorted_g, jnp.max(inst.starts + inst.counts), inst.perm,
    )
    t_ids = np.arange(T)
    lay = {k: np.array(getattr(inst, k)) for k in INTS
           if getattr(inst, k, None) is not None}
    lay["x0"] = ((t_ids % GX) * 16).astype(np.int32)
    lay["y0"] = ((t_ids // GX) * 16).astype(np.int32)
    ti = {k: torch.from_numpy(v) for k, v in lay.items()}
    color, final_t, _ = tct.composite_tile_fwd(
        torch.from_numpy(np.array(slab)), ti["starts"], ti["counts"], ti["x0"],
        ti["y0"], T,
    )
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    color_full = (color + final_t[:, None, :] * torch.from_numpy(bg)[None, :, None]).numpy()
    rng = np.random.default_rng(seed + 1000)
    return dict(
        lay=lay, ti=ti, gauss=g, slab=np.array(slab), bg=bg, n=n,
        color_full=color_full,
        dcolor=rng.normal(size=(T, 3, 256)).astype(np.float32),
    )


CASES = {
    # few Gaussians: empty tiles
    "sparse": dict(seed=31, n=12, max_instances=1 << 13),
    # squeezed toward the front: segments of hundreds of instances,
    # unaligned starts across several 128-lane chunks
    "multichunk": dict(seed=33, n=512, squeeze=(0.2, 0.2, 1.0), max_instances=1 << 13),
}
# the other slab layouts on which the rasterizer takes the fused route
# (fused_reduce=True needs no emission payload; RasterConfig allows it with
# or without a depth presort and with ghost alignment)
FUSED_CASES = {
    "multichunk_two_key": dict(CASES["multichunk"], binning="two_key"),
    "multichunk_ghost": dict(CASES["multichunk"], binning="ghost"),
}
_LAYOUTS = {}


def _get(case):
    if case not in _LAYOUTS:
        _LAYOUTS[case] = _layout(**{**CASES, **FUSED_CASES}[case])
    return _LAYOUTS[case]


def _grad_close(got, ref, name):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4 * scale + 1e-8,
                               err_msg=name)


@pytest.mark.parametrize(
    "tile_cull,max_instances,n",
    [(False, 1 << 17, 160), (True, 1 << 17, 160), (True, 100, 160)],
    ids=["nocull_live_bound", "cull_live_bound", "cull_truncated"],
)
def test_bin_packed_with_emission_matches_jax(tile_cull, max_instances, n):
    pj, pt = _prep_pair(21, n)
    ij = jbin.bin_instances_packed(
        pj, GX, GY, max_instances, tile_cull=tile_cull, with_emission=True
    )
    it = tbin.bin_instances_packed(
        pt, GX, GY, max_instances, tile_cull=tile_cull, with_emission=True
    )
    for f in ("sorted_g", "starts", "counts", "perm", "inv_perm", "sorted_key",
              "truncated", "num_instances", "sorted_e", "seg_lo", "seg_hi"):
        np.testing.assert_array_equal(
            getattr(it, f).numpy().astype(np.int64),
            np.asarray(getattr(ij, f)).astype(np.int64), err_msg=f,
        )
    assert it.sorted_e.dtype == it.seg_lo.dtype == torch.int32
    live = it.sorted_e < tbin.E_SENTINEL
    assert int(live.sum()) == int(it.num_instances) > 0
    if max_instances == 100:
        assert int(it.truncated) > 0
    plain = tbin.bin_instances_packed(pt, GX, GY, max_instances, tile_cull=tile_cull)
    assert plain.sorted_e is None and torch.equal(plain.sorted_key, it.sorted_key)


@pytest.mark.parametrize("case", list(CASES))
def test_build_inst_matches_jax(case):
    d = _get(case)
    ti = d["ti"]
    live = torch.amax(ti["starts"] + ti["counts"])
    got = tct._build_inst(
        *[torch.from_numpy(d["gauss"][k]) for k in ("means2d", "conic", "rgb", "opacity")],
        ti["sorted_g"], live, ti["perm"],
    ).numpy()
    assert got.shape == d["slab"].shape == (tct.NROWS, len(d["lay"]["sorted_g"]) + tct.CHUNK)
    lv = int(live)
    np.testing.assert_array_equal(got[:, :lv], d["slab"][:, :lv])
    assert (got[:, lv:] == 0).all() and (got[9:] == 0).all()


@pytest.mark.parametrize("want_ncontrib", [True, False], ids=["ncontrib", "no_ncontrib"])
@pytest.mark.parametrize("case", list(CASES))
def test_fwd_plain_matches_jax(case, want_ncontrib):
    d = _get(case)
    lay, ti = d["lay"], d["ti"]
    rc, rt, rn = (np.asarray(a) for a in jpr.composite_pallas_fwd(
        jnp.asarray(d["slab"]), *[jnp.asarray(lay[k]) for k in ("starts", "counts", "x0", "y0")],
        T, interpret=True, want_ncontrib=want_ncontrib,
    ))
    before = launches("composite_tile_fwd")
    gc, gt, gn = tct.composite_tile_fwd(
        torch.from_numpy(d["slab"]), ti["starts"], ti["counts"], ti["x0"], ti["y0"],
        T, want_ncontrib,
    )
    assert launches("composite_tile_fwd") == before  # plain version on the CPU
    np.testing.assert_allclose(gc.numpy(), rc, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), rt, atol=1e-5)
    assert gn.dtype == torch.int32
    np.testing.assert_array_equal(gn.numpy(), rn)
    if want_ncontrib:
        assert rn.max() > 0
    else:
        assert (rn == 0).all()
    empty = lay["counts"] == 0
    assert (gt.numpy()[empty] == 1).all() and (gc.numpy()[empty] == 0).all()
    if case == "sparse":
        assert empty.any()
    else:
        assert lay["counts"].max() > tct.CHUNK and (lay["starts"] % tct.CHUNK != 0).any()


def _jax_bwd(d):
    lay = d["lay"]
    return np.asarray(jpr.composite_pallas_bwd(
        jnp.asarray(d["slab"]), *[jnp.asarray(lay[k]) for k in ("starts", "counts", "x0", "y0")],
        jnp.asarray(d["color_full"]), jnp.asarray(d["dcolor"]), T, interpret=True,
    ))


def _torch_args(d):
    ti = d["ti"]
    return (ti["starts"], ti["counts"], ti["x0"], ti["y0"],
            torch.from_numpy(d["color_full"]), torch.from_numpy(d["dcolor"]), T)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax(case):
    d = _get(case)
    ref = _jax_bwd(d)
    before = launches("composite_tile_bwd")
    got = tct.composite_tile_bwd(torch.from_numpy(d["slab"]), *_torch_args(d)).numpy()
    assert launches("composite_tile_bwd") == before
    assert got.shape == ref.shape == d["slab"].shape
    for r, name in enumerate(("x", "y", "A", "B", "C", "op", "r", "g", "b")):
        _grad_close(got[r], ref[r], name)
    assert np.abs(ref[:9]).max() > 0
    in_seg = np.zeros(got.shape[1], bool)
    for s, n in zip(d["lay"]["starts"], d["lay"]["counts"]):
        in_seg[s:s + n] = True
    assert (got[:, ~in_seg] == 0).all() and (got[9:] == 0).all()


@pytest.mark.parametrize("case", list(CASES) + list(FUSED_CASES))
def test_bwd_fused_plain_matches_jax(case):
    d = _get(case)
    lay = d["lay"]
    ref = np.asarray(jpr.composite_pallas_bwd_fused(
        jnp.asarray(d["slab"]), jnp.asarray(lay["sorted_g"]),
        *[jnp.asarray(lay[k]) for k in ("starts", "counts", "x0", "y0")],
        jnp.asarray(d["color_full"]), jnp.asarray(d["dcolor"]), T, d["n"],
        interpret=True,
    ))
    before = launches("composite_tile_bwd_fused")
    got = tct.composite_tile_bwd_fused(
        torch.from_numpy(d["slab"]), d["ti"]["sorted_g"], *_torch_args(d), d["n"]
    ).numpy()
    assert launches("composite_tile_bwd_fused") == before
    assert got.shape == ref.shape == (d["n"], 9)
    for r in range(9):
        _grad_close(got[:, r], ref[:, r], f"row {r}")
    assert np.abs(ref).max() > 0


def _reduction_inputs(seed, r_slab, n_live, p):
    """Rows at random slab positions, their survivor ranks and contiguous
    per-Gaussian segments (many empty, some spanning blocks), rows of a
    ~1e4 dynamic range; dropped slots hold poison rows."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-2, 2, size=(n_live, 1))
    rows = (rng.standard_normal((n_live, 9)) * mag).astype(np.float32)
    cuts = np.sort(rng.integers(0, n_live + 1, size=p - 1))
    bounds = np.concatenate([[0], cuts, [n_live]]).astype(np.int32)
    pos = rng.permutation(r_slab)[:n_live]
    sorted_e = np.full((r_slab,), jbin.E_SENTINEL, np.int32)
    sorted_e[pos] = np.arange(n_live, dtype=np.int32)
    slab_rows = rng.standard_normal((r_slab, 9)).astype(np.float32)
    slab_rows[pos] = rows
    return slab_rows, sorted_e, bounds[:-1].copy(), bounds[1:].copy()


@pytest.mark.parametrize(
    "r_slab,n_live,p", [(3000, 2500, 300), (1 << 17, (1 << 17) - 3000, 2048)],
    ids=["ragged", "blocked"],
)
def test_gather_reduce_rows_matches_jax(r_slab, n_live, p):
    rows, sorted_e, lo, hi = _reduction_inputs(7, r_slab, n_live, p)
    ref = np.asarray(jax.jit(jpr.gather_reduce_rows)(
        jnp.asarray(rows), jnp.asarray(sorted_e), jnp.asarray(lo), jnp.asarray(hi)
    ))
    got = tct.gather_reduce_rows(
        torch.from_numpy(rows), torch.from_numpy(sorted_e), torch.from_numpy(lo),
        torch.from_numpy(hi),
    ).numpy()
    assert got.shape == ref.shape == (p, 9)
    _grad_close(got, ref, "gather_reduce_rows")
    exact = np.zeros((p, 9))
    np.add.at(exact, np.searchsorted(hi, np.arange(n_live), side="right"),
              rows[np.argsort(sorted_e)[:n_live]].astype(np.float64))
    assert np.abs(got - exact).max() / np.abs(exact).max() < 2e-5


def test_scatter_reduce_drops_lanes_past_live():
    """The live-bound scatter sums each rank's lanes below the live mark,
    ignores every lane at or past it (nonzero rows there included) and is
    deterministic."""
    rng = np.random.default_rng(5)
    p, r, live = 12, 600, 450
    ids = rng.integers(0, p, size=r).astype(np.int32)
    dinst = rng.normal(size=(tct.NROWS, r + tct.CHUNK)).astype(np.float32)
    ref = np.zeros((p, tct.NGRAD), np.float64)
    np.add.at(ref, ids[:live], dinst[:tct.NGRAD, :live].T)
    args = (torch.from_numpy(dinst), torch.from_numpy(ids), torch.tensor(live), p)
    out = tct._scatter_reduce(*args)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, tct._scatter_reduce(*args))


def _jax_vjp(d, route):
    lay = d["lay"]
    ints = [jnp.asarray(lay[k]) for k in ("sorted_g", "starts", "counts", "x0", "y0")]
    emis = ([None] * 3 if route != "gather"
            else [jnp.asarray(lay[k]) for k in ("sorted_e", "seg_lo", "seg_hi")])

    def f(m, c, r, o, b):
        return jpr.composite_instances(
            m, c, r, o, b, *ints, *emis, jnp.asarray(lay["perm"]),
            jnp.asarray(lay["inv_perm"]), T, True, True, route == "fused",
        )[0]

    args = [jnp.asarray(d["gauss"][k]) for k in ("means2d", "conic", "rgb", "opacity")]
    out, vjp = jax.vjp(f, *args, jnp.asarray(d["bg"]))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(d["dcolor"]))]


def _torch_function(d, route):
    ti = d["ti"]
    g = {k: torch.from_numpy(v).requires_grad_(True) for k, v in d["gauss"].items()}
    bg = torch.from_numpy(d["bg"]).requires_grad_(True)
    emis = ([None] * 3 if route != "gather"
            else [ti[k] for k in ("sorted_e", "seg_lo", "seg_hi")])
    outs = tct.composite_instances(
        g["means2d"], g["conic"], g["rgb"], g["opacity"], bg,
        *[ti[k] for k in ("sorted_g", "starts", "counts", "x0", "y0")], *emis,
        ti.get("perm"), ti.get("inv_perm"), T, True, route == "fused",
    )
    return outs, [g["means2d"], g["conic"], g["rgb"], g["opacity"], bg]


@pytest.mark.parametrize("case", ["multichunk", "multichunk_two_key"])
def test_fused_backward_takes_the_table_view(case, monkeypatch):
    """On the card the fused wrapper returns the first nine columns of its
    (P, 16) table as a view, not a copy: the backward's consumers (the
    gather by ``inv_perm`` after a depth presort, the column slices without
    one) and autograd give bit for bit the gradients of a contiguous (P, 9)
    result."""
    d = _get(case)
    assert (d["ti"].get("inv_perm") is None) == (case == "multichunk_two_key")
    dcolor = torch.from_numpy(d["dcolor"])
    (color, _, _), inputs = _torch_function(d, "fused")
    ref = torch.autograd.grad(color, inputs[:4], dcolor)
    plain = tct.composite_tile_bwd_fused

    def table_view(*args):
        acc = plain(*args)
        table = torch.full((acc.shape[0], tct.FUSED_TABLE_COLS), float("nan"))
        table[:, : tct.NGRAD] = acc
        view = table[:, : tct.NGRAD]
        assert not view.is_contiguous()
        return view

    monkeypatch.setattr(tct, "composite_tile_bwd_fused", table_view)
    (color, _, _), inputs = _torch_function(d, "fused")
    got = torch.autograd.grad(color, inputs[:4], dcolor)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert max(float(g.abs().max()) for g in got) > 0


@pytest.mark.parametrize("route", ["scatter", "gather", "fused"])
def test_function_grads_match_jax_vjp(route):
    d = _get("multichunk")
    color_j, grads_j = _jax_vjp(d, route)
    (color, final_t, ncontrib), inputs = _torch_function(d, route)
    np.testing.assert_allclose(color.detach().numpy(), color_j, atol=2e-5)
    assert int(ncontrib.max()) > 0
    grads_t = torch.autograd.grad(color, inputs, torch.from_numpy(d["dcolor"]))
    for got, ref, name in zip(grads_t, grads_j, ("means2d", "conic", "rgb", "opacity")):
        assert got.shape == ref.shape, name
        _grad_close(got.numpy(), ref, name)
    # bg: zeros in both packages (a reference quirk, ROADMAP queue 3)
    assert (grads_j[4] == 0).all() and (grads_t[4] == 0).all()
    assert not final_t.requires_grad and not ncontrib.requires_grad


def test_final_t_is_not_differentiable():
    """A gradient into final_T fails loudly instead of being dropped."""
    (color, final_t, _), _ = _torch_function(_get("sparse"), "scatter")
    assert color.requires_grad and not final_t.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        final_t.sum().backward()
