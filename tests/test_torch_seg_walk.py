"""The compositing kernels' walk (omnigs_torch/csrc/composite_seg_walk.cuh,
kernels #1-#4) on the CPU, where the kernels cannot run.

* The staging test that lets a warp skip an instance (`strip_mask`, in
  plain PyTorch `composite_seg._strip_masks`, same formula and slack)
  never clears the bit of a strip that holds a live pair: on segmented
  slabs of the port's pipeline, on the tile-major layouts (the compact
  slab with and without the emission payload, the ghost-aligned layout,
  also with its pad lanes as zero rows inside the segments, and the 2-key
  binning; unaligned segment starts) and on made-up slabs with opacities
  at 1/255, needle-thin and near-singular conics and means just outside
  the tile and the strips. Every pair is evaluated with the kernels'
  float32 operations at the tiles' origins; the plain walk's composited
  pixels (`warp_gate`) are a subset of the live ones.
* Every ablation of `omnigs_torch/utils/kernel_variants.py` edits the
  shared walk once (and so reaches #1-#5); the ablations of #5's table sink
  and of #6 edit their own sources once. `composite.cuh` holds no walk, and
  every compositing kernel (#1-#5) runs the shared one.
* The backward's recursive-halving warp sums (12 shuffles) equal the xor
  butterfly (45) bit for bit, -0.0 and inf included, in a numpy float32
  emulation of the exchange the kernel unrolls; the plain backward sums the
  pixels in that tree (`composite_seg._pixel_sum`).
* The slack constants of the header and of the plain mirror are the same.

The segmented forward and backward and `train_step` are held against JAX
in tests/test_torch_composite_seg*.py and tests/test_torch_train*.py; the
kernels against the plain versions, bit for bit, on the card in
tests/test_torch_kernels_gpu.py."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.ops import composite_seg as tcs
from omnigs_torch.ops import composite_tile as tct
from omnigs_torch.ops.binning import (
    bin_instances,
    bin_instances_aligned,
    bin_instances_packed,
    segment_relay,
)
from omnigs_torch.ops.preprocess import TILE, preprocess
from omnigs_torch.utils import kernel_variants

from torch_helpers import random_cloud_np, to_torch

HEADER = Path(tcs.__file__).resolve().parent.parent / "csrc" / "composite_seg_walk.cuh"
ALPHA_MIN_F32 = float(np.float32(tcs.ALPHA_MIN))


def _prep(seed, n, scale_mu, w=256, h=128):
    c = to_torch(random_cloud_np(seed, n, scale_mu=scale_mu))
    return preprocess(
        c["means3d"], c["scales"], c["quats"], c["opacities"], c["shs"],
        Camera(CameraType.LONLAT, w, h), torch.eye(4), torch.zeros(3), 2,
        tight_culling=True,
    )


def _pipeline_slab(seed, n, scale_mu, w=256, h=128, max_instances=1 << 14):
    """The segmented slab → (slab, starts8, counts, x0, y0)."""
    prep = _prep(seed, n, scale_mu, w, h)
    gx, gy = w // 16, h // 16
    inst = bin_instances_packed(prep, gx, gy, max_instances, tile_cull=True)
    seg = segment_relay(inst.sorted_g, inst.starts, inst.counts, max_instances, n,
                        inst.sorted_key)
    slab = tcs._build_inst_seg(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                               seg.sorted_g8, inst.perm, seg.ride_d, seg.ride_t)
    return (slab, seg.starts8, seg.counts, *tct.tile_origins(gx, gy))


def _tile_major_slab(layout, seed, n, scale_mu, w=256, h=128, max_instances=1 << 14):
    """A tile-major slab (`composite_tile._build_inst`, as `rasterize`
    builds it) of one binning → (slab, starts, counts, x0, y0):
    ``compact`` and ``compact_emission`` (the packed key, without and with
    the survivor-rank payload), ``two_key`` (`bin_instances`), ``ghost``
    (`bin_instances_aligned`: segments at CHUNK-aligned starts) and
    ``ghost_pad`` (the same with every segment running over its ghost pad
    lanes, zeroed: zero rows inside the segments)."""
    prep = _prep(seed, n, scale_mu, w, h)
    gx, gy = w // 16, h // 16
    if layout.startswith("compact"):
        inst = bin_instances_packed(prep, gx, gy, max_instances, tile_cull=True,
                                    with_emission=layout == "compact_emission")
    elif layout == "two_key":
        inst = bin_instances(prep, gx, gy, max_instances, tile_cull=True)
    else:
        inst = bin_instances_aligned(prep, gx, gy, max_instances, chunk=tcs.CHUNK,
                                     tile_cull=True)
    live = torch.amax(inst.starts + inst.counts)
    slab = tct._build_inst(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                           inst.sorted_g, live, inst.perm)
    counts = inst.counts
    if layout == "ghost_pad":
        padded = (counts + tcs.CHUNK - 1) // tcs.CHUNK * tcs.CHUNK
        lane = torch.arange(slab.shape[1])
        owner = torch.searchsorted(inst.starts, lane, right=True) - 1
        in_pad = (lane >= inst.starts[owner] + counts[owner]) & (
            lane < inst.starts[owner] + padded[owner])
        slab[:, in_pad] = 0.0
        counts = padded.to(torch.int32)
    return (slab, inst.starts, counts, *tct.tile_origins(gx, gy))


def _edge_slab(seed, per_tile=160, gx=3, gy=2):
    """Made-up instances for a gx × gy tile grid: conics from σ 0.3–30 px
    with axis ratios up to 3,000 (needles; near-singular past the test's
    κ limit), opacities at and around 1/255, and means placed so that the
    ellipse α = 1/255 ends within ±0.05 px of a tile edge or a strip
    boundary, or lies anywhere near the tile."""
    rng = np.random.default_rng(seed)
    near = ALPHA_MIN_F32 * (1.0 + np.array([-1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-4, 1e-2]))
    rows, counts = [], []
    for tile in range(gx * gy):
        tx0, ty0 = (tile % gx) * TILE, (tile // gx) * TILE
        for _ in range(per_tile):
            s1 = math.exp(rng.uniform(math.log(0.3), math.log(30.0)))
            s2 = s1 / math.exp(rng.uniform(0.0, math.log(3000.0)))
            th = rng.uniform(0.0, math.pi)
            rot = np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
            conic = np.linalg.inv(rot @ np.diag([s1 * s1, s2 * s2]) @ rot.T)
            a, b, c = (float(np.float32(v)) for v in (conic[0, 0], conic[0, 1], conic[1, 1]))
            pick = rng.uniform()
            op = (float(rng.choice(near)) if pick < 0.3
                  else 0.0 if pick < 0.33 else float(rng.uniform(0.004, 1.0)))
            det = a * c - b * b
            tau = 2.0 * math.log(max(op, 1e-30) / ALPHA_MIN_F32)
            hx = math.sqrt(max(tau, 0.0) * c / det) if det > 0 else 0.0
            hy = math.sqrt(max(tau, 0.0) * a / det) if det > 0 else 0.0
            hx, hy = min(hx, 40.0), min(hy, 40.0)
            x = tx0 + rng.uniform(-8.0, 24.0)
            y = ty0 + rng.uniform(-8.0, 24.0)
            where = rng.integers(0, 4)
            jitter = rng.uniform(-0.05, 0.05)
            if where == 1:  # just left of or right of the tile
                x = (tx0 - hx if rng.uniform() < 0.5 else tx0 + 15 + hx) + jitter
            elif where == 2:  # ending at a strip boundary above or below
                lo = ty0 + 2 * int(rng.integers(0, 8))
                y = (lo - hy if rng.uniform() < 0.5 else lo + 1 + hy) + jitter
            elif where == 3:  # both
                x = tx0 - hx + jitter
                y = ty0 + 4 * int(rng.integers(0, 4)) - hy - jitter
            rows.append([x, y, a, b, c, op, *rng.uniform(size=3)])
        counts.append(per_tile)
    slab = np.zeros((tcs.NROWS, len(rows)), np.float32)
    slab[:9] = np.array(rows, np.float32).T
    counts = np.array(counts, np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    return (torch.from_numpy(slab), torch.from_numpy(starts), torch.from_numpy(counts),
            *tct.tile_origins(gx, gy))


def _live_pairs(slab, starts, counts, x0, y0):
    """(lanes (L,), live (L, PX) bool): every segment pair through the
    kernels' float32 operations at the tiles' pixels, alive iff power ≤ 0
    and α ≥ 1/255."""
    lanes, tiles = [], []
    for t in range(counts.shape[0]):
        lanes.append(torch.arange(int(starts[t]), int(starts[t]) + int(counts[t])))
        tiles.append(torch.full((int(counts[t]),), t))
    lanes, tiles = torch.cat(lanes), torch.cat(tiles)
    px, py = tct._tile_pixels(x0, y0)
    d = slab[:6, lanes][:, :, None]
    dx = d[0] - px[tiles]
    dy = d[1] - py[tiles]
    power = -0.5 * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy
    alpha = torch.clamp_max(d[5] * torch.exp(torch.clamp_max(power, 0.0)), tcs.ALPHA_MAX)
    return lanes, (power <= 0.0) & (alpha >= tcs.ALPHA_MIN)


def _strip_bits(pix: torch.Tensor, strip_rows: int) -> torch.Tensor:
    """(L, PX) bool → (L,) int32: bit s where a pixel of rows
    [s·strip_rows, (s + 1)·strip_rows) is True."""
    n = TILE // strip_rows
    hit = pix.reshape(pix.shape[0], n, strip_rows * TILE).any(dim=2).to(torch.int32)
    return (hit << torch.arange(n, dtype=torch.int32)).sum(dim=1, dtype=torch.int32)


SLABS = {
    "pipeline": lambda: _pipeline_slab(50, 400, -1.5),
    "pipeline_small": lambda: _pipeline_slab(51, 600, -3.0),
    "pipeline_large": lambda: _pipeline_slab(52, 60, 0.0),
    "edges": lambda: _edge_slab(53),
    "edges2": lambda: _edge_slab(54),
    "compact": lambda: _tile_major_slab("compact", 55, 400, -1.5),
    "compact_emission": lambda: _tile_major_slab("compact_emission", 56, 600, -3.0),
    "ghost": lambda: _tile_major_slab("ghost", 57, 400, -1.5),
    "ghost_pad": lambda: _tile_major_slab("ghost_pad", 58, 300, -2.0),
    "two_key": lambda: _tile_major_slab("two_key", 59, 400, -1.0),
}


@pytest.mark.parametrize("strip_rows", [tcs.BWD_STRIP, tcs.FWD_STRIP])
@pytest.mark.parametrize("kind", sorted(SLABS))
def test_strip_mask_keeps_every_live_pair(kind, strip_rows):
    slab, starts, counts, x0, y0 = SLABS[kind]()
    mask = tcs._strip_masks(slab, starts, counts, x0, y0, strip_rows)
    lanes, live = _live_pairs(slab, starts, counts, x0, y0)
    need = _strip_bits(live, strip_rows)
    lost = need & ~mask[lanes]
    assert int((lost != 0).sum()) == 0, f"{int((lost != 0).sum())} instances lose a live strip"
    # zero rows (the ghost layout's pad lanes) are dead and culled
    zero = (slab[:9, lanes] == 0).all(dim=0)
    assert not bool(live[zero].any()) and not bool(mask[lanes][zero].any())
    if kind == "ghost_pad":
        assert int(zero.sum()) > 0
    # the composited pixels of the plain walk are live ones
    gate = torch.zeros(slab.shape[1], dtype=torch.int32)
    px, py = tct._tile_pixels(x0, y0)
    tcs._walk_fwd_plain(slab, starts, counts, px, py, False, gate)
    assert int((gate[lanes] & ~_strip_bits(live, 2)).abs().sum()) == 0
    if strip_rows == 2:
        assert int((gate[lanes] & ~mask[lanes]).abs().sum()) == 0
    # and the test does cull: most strips without a live pair are dropped
    n_strips = TILE // strip_rows
    dead = n_strips * lanes.shape[0] - int(sum(((need >> s) & 1).sum() for s in range(n_strips)))
    kept_dead = sum(int((((mask[lanes] & ~need) >> s) & 1).sum()) for s in range(n_strips))
    assert dead > 0 and kept_dead <= 0.6 * dead, (kept_dead, dead)


def test_tile_major_slabs_have_unaligned_segments():
    """The compact and 2-key layouts start most segments off the CHUNK
    grid, the ghost-aligned one on it; every layout's tiles have the
    grid's origins."""
    for kind in ("compact", "compact_emission", "two_key", "ghost"):
        _, starts, counts, x0, y0 = SLABS[kind]()
        busy = counts > 0
        off_grid = (starts[busy] % tcs.CHUNK != 0).float().mean()
        if kind == "ghost":
            assert float(off_grid) == 0.0
        else:
            assert float(off_grid) > 0.5, kind
        gx0, gy0 = tct.tile_origins(16, 8)
        assert torch.equal(x0, gx0) and torch.equal(y0, gy0)


def test_ablations_edit_the_shared_walk_once(tmp_path, monkeypatch):
    """Each ablation of `kernel_variants` applies to the walk header that
    kernels #1-#4 share (an anchor that moved raises "is not once in"),
    and the compared builds cover all four kernels."""
    monkeypatch.setattr(kernel_variants, "VARIANT_DIR", tmp_path)
    assert set(kernel_variants.SOURCES) == {
        "composite_seg_fwd", "composite_seg_bwd", "composite_tile_fwd", "composite_tile_bwd"}
    for name, edits in kernel_variants.ABLATIONS.items():
        tree = kernel_variants._variant_tree(name, edits)
        assert {f for f, _, _ in edits} == {"composite_seg_walk.cuh"}
        text = (tree / "composite_seg_walk.cuh").read_text()
        for _, _, new in edits:
            assert new in text, name
        for src in kernel_variants.SOURCES:
            assert '#include "composite_seg_walk.cuh"' in (tree / f"{src}.cu").read_text()
        # the fused backward #5 sits in #4's source and runs the same walk
        fused = (tree / "composite_tile_bwd.cu").read_text()
        assert re.search(r"composite_tile_bwd_fused_kernel\([^{]*\{[^}]*bwd_walk\(",
                         fused), name


def test_sink_and_reduce_ablations_edit_their_sources_once(tmp_path, monkeypatch):
    """The ablations of #5's table sink edit composite_tile_bwd.cu, those of
    #6 reduce_accum.cu, each anchor exactly once; the earlier (p, 9) table
    width is the scalar sink's."""
    monkeypatch.setattr(kernel_variants, "VARIANT_DIR", tmp_path)
    for edits, fname in ((kernel_variants.SINK_ABLATIONS, "composite_tile_bwd.cu"),
                         (kernel_variants.REDUCE_ABLATIONS, "reduce_accum.cu")):
        assert edits
        for name, e in edits.items():
            tree = kernel_variants._variant_tree(name, e)
            assert {f for f, _, _ in e} == {fname}
            text = (tree / fname).read_text()
            for _, old, new in e:
                assert new in text and old not in text, name
    cols = kernel_variants._variant_tree(
        "scalar_sink", kernel_variants.SINK_ABLATIONS["scalar_sink"])
    assert "constexpr int TABLE_COLS = 9;" in (cols / "composite_tile_bwd.cu").read_text()
    src = (HEADER.parent / "composite_tile_bwd.cu").read_text()
    assert f"constexpr int TABLE_COLS = {tct.FUSED_TABLE_COLS};" in src


def test_every_compositing_kernel_runs_the_shared_walk():
    """composite.cuh keeps the constants and no walk; each `__global__` of
    the compositing sources (#1-#5) calls fwd_walk or bwd_walk."""
    csrc = HEADER.parent
    base = (csrc / "composite.cuh").read_text()
    assert "__device__" not in base and "__global__" not in base
    assert "constexpr float T_STOP" in base
    kernels = {}
    for src in kernel_variants.SOURCES:
        text = (csrc / f"{src}.cu").read_text()
        for m in re.finditer(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(", text):
            body = text[m.end():text.index("\n}\n", m.end())]
            kernels[m.group(1)] = body
    assert set(kernels) == {
        "composite_seg_fwd_kernel", "composite_seg_bwd_kernel", "composite_tile_fwd_kernel",
        "composite_tile_bwd_kernel", "composite_tile_bwd_fused_kernel"}
    for name, body in kernels.items():
        assert re.search(r"\b(fwd_walk<[^>]*>|bwd_walk)\(", body), name


def test_strip_mask_edge_rules():
    """The early returns: non-finite → all strips, opacity ≤ 0 or below
    1/255 → none, a conic that is not positive definite or too
    ill-conditioned → all."""
    rows = [
        [8.0, 8.0, 0.1, 0.0, 0.1, float("nan")],
        [8.0, 8.0, 0.1, 0.0, float("inf"), 0.5],
        [8.0, 8.0, 0.1, 0.0, 0.1, 0.0],
        [8.0, 8.0, 0.1, 0.0, 0.1, ALPHA_MIN_F32 * (1 - 1e-4)],
        [8.0, 8.0, -0.1, 0.0, 0.1, 0.5],
        [8.0, 8.0, 1.0, 1.0, 1.0, 0.5],
        [8.0, 8.0, 1.0, 0.9999999, 1.0, 0.5],
        [8.0, 0.2, 100.0, 0.0, 100.0, 0.5],  # a dot in the top strip
        [-30.0, 8.0, 10.0, 0.0, 10.0, 0.5],  # left of the tile
    ]
    slab = torch.zeros(tcs.NROWS, len(rows))
    slab[:6] = torch.tensor(rows).T
    zero = torch.zeros(1, dtype=torch.int32)
    m = tcs._strip_masks(slab, zero, torch.tensor([len(rows)], dtype=torch.int32), zero,
                         zero, 2)
    assert m.tolist() == [255, 255, 0, 0, 255, 255, 255, 1, 0]


def _parse_float(name):
    text = HEADER.read_text()
    rhs = re.search(rf"constexpr float {name} = ([^;]+);", text).group(1)
    return np.float32(math.prod(float(f.strip().rstrip("f")) for f in rhs.split("*")))


def test_slack_constants_match_the_header():
    for name in ("CULL_REL", "CULL_ABS", "TAU_FLOOR", "CULL_PAD", "LOG_ALPHA_MIN"):
        assert _parse_float(name) == np.float32(getattr(tcs, name)), name
    assert tcs.LOG_ALPHA_MIN == float(np.float32(np.log(np.float64(ALPHA_MIN_F32))))
    text = HEADER.read_text()
    rows = int(re.search(r"constexpr int FWD_ROWS = (\d+);", text).group(1))
    assert tcs.FWD_STRIP == 2 * rows
    assert re.search(r"constexpr int BWD_STRIP = (\d+);", text).group(1) == str(tcs.BWD_STRIP)


def _butterfly(v):
    """(32, 9) float32: every lane's values after five xor steps."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ off]
    return v


def _halving(v):
    """(32,) float32: each lane's h[0] after the kernel's exchange
    (`halve<9>`, `<5>`, `<3>`, `<2>`, `<1>` over offsets 16 … 1): keep
    K = ceil(n / 2) values, the upper lane of a pair the last n − K (missing
    ones sent as 0), each adding its partner's copy. Returns also the
    number of shuffles."""
    lanes = np.arange(32)
    h = v.copy()
    n, shuffles = v.shape[1], 0
    for off in (16, 8, 4, 2, 1):
        k_keep = (n + 1) // 2
        upper = (lanes & off) != 0
        new = h.copy()
        for k in range(k_keep):
            lo = h[:, k]
            hi = h[:, k_keep + k] if k_keep + k < n else np.zeros(32, np.float32)
            send = np.where(upper, lo, hi)
            new[:, k] = np.where(upper, hi, lo) + send[lanes ^ off]
            shuffles += 1
        h, n = new, k_keep
    return h[:, 0], shuffles


def _halving_slot(lane):
    """The kernel's `halving_slot`: which sum the lane ends with, or -1."""
    base, n, held = 0, tcs.NGRAD, tcs.NGRAD
    for off in (16, 8, 4, 2, 1):
        k = (n + 1) // 2
        if lane & off:
            base, held = base + k, max(held - k, 0)
        else:
            held = min(held, k)
        n = k
    return base if held > 0 else -1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_halving_exchange_equals_butterfly_bitwise(seed):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(32, tcs.NGRAD)) * 10.0 ** rng.uniform(-6, 6, size=(32, tcs.NGRAD)))
    v = v.astype(np.float32)
    v[rng.uniform(size=v.shape) < 0.3] = 0.0
    v[rng.uniform(size=v.shape) < 0.2] = -0.0
    if seed == 1:
        v[:, 3] = -0.0  # a sum of negative zeros stays -0.0
    if seed >= 2:
        v[rng.integers(0, 32), rng.integers(0, tcs.NGRAD)] = np.inf
        v[rng.integers(0, 32), rng.integers(0, tcs.NGRAD)] = -np.inf
    ref = _butterfly(v)
    # the butterfly leaves the same bits in every lane (addition commutes)
    np.testing.assert_array_equal(ref.view(np.uint32), np.broadcast_to(ref[:1], ref.shape).view(np.uint32))
    got, shuffles = _halving(v)
    assert shuffles == 12
    slots = [_halving_slot(lane) for lane in range(32)]
    assert [lane for lane in range(32) if slots[lane] >= 0] == [0, 2, 4, 8, 10, 16, 18, 20, 24]
    assert sorted(s for s in slots if s >= 0) == list(range(tcs.NGRAD))
    for lane, q in enumerate(slots):
        if q >= 0:
            assert got[lane].view(np.uint32) == ref[0, q].view(np.uint32), (lane, q)


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_pixel_sum_is_the_kernels_tree(seed):
    """`_pixel_sum` = per warp the butterfly's lane-0 value, then the eight
    warp sums left to right, bit for bit."""
    rng = np.random.default_rng(seed)
    t = (rng.normal(size=(6, tcs.PX)) * 10.0 ** rng.uniform(-4, 4, size=(6, tcs.PX)))
    t = t.astype(np.float32)
    t[rng.uniform(size=t.shape) < 0.4] = 0.0
    got = tcs._pixel_sum(torch.from_numpy(t)).numpy()
    for i in range(t.shape[0]):
        warps = [_butterfly(t[i, 32 * w: 32 * w + 32, None])[0, 0] for w in range(tcs.NWARP)]
        acc = warps[0]
        for x in warps[1:]:
            acc = np.float32(acc + x)
        assert got[i].view(np.uint32) == np.float32(acc).view(np.uint32)
