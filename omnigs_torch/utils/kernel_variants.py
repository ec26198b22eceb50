"""Other builds of the compositing kernels #1-#5, of the reduction kernel #6
and of the ablation kernel #8, timed in turns with the production build on
the same inputs.

`chip_smoke.py`'s `seg_compare`, `tile_compare`, `reduce_compare` and
`ablate_compare` phases run `compare_seg` (kernels #1/#2 on the segmented
slab), `compare_tile` (#3/#4/#5 on the compact slab), `compare_reduce` (#6
on the given ids and rows) and `compare_ablate` (#8's six modes on its
script's slab) at full width. The builds, each by nvcc with the production
flags into ``build/seg_variants/<variant>/``:

* ``before``: a copy of an earlier tree's CUDA sources with the present C
  interfaces, when present (the parent commit's: `git archive <commit>
  omnigs_torch/csrc | tar -x -C build/seg_before`);
* `ABLATIONS`: the present sources with one design element of the shared
  walk `csrc/composite_seg_walk.cuh` taken out (each edit acts on the
  segmented and the tile-major kernels, #5 included, at once);
* `SINK_ABLATIONS`: the present `csrc/composite_tile_bwd.cu` with one
  element of #5's table sink changed (#4 in the same build must keep its
  bytes);
* `REDUCE_ABLATIONS`: the present `csrc/reduce_accum.cu` with one element
  of #6 changed;
* `ABLATE_ABLATIONS`: the present `csrc/kernel_ablate.cu` with one design
  element of #8 turned off; #8 also builds in the walk's
  `ABLATE_WALK_ABLATIONS` (it stages with the shared header).

#1-#4 and #8 of every build must give the production build's output
bytes; #5 and #6 add with atomics in no fixed order, so their outputs are
held to a caller's float bar instead. The times say what each element
buys. Nothing here is on a render or training path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops import composite_seg as cs
from omnigs_torch.ops import composite_tile as ct
from omnigs_torch.scripts import kernel_ablate as ka
from omnigs_torch.scripts import reduce_bench as rb
from omnigs_torch.utils.profiling import mean_ms

VARIANT_DIR = cuda_build.BUILD_DIR.parent / "seg_variants"
SOURCES = ("composite_seg_fwd", "composite_seg_bwd", "composite_tile_fwd",
           "composite_tile_bwd")
_WALK = "composite_seg_walk.cuh"
_ALL_STRIPS = "  constexpr unsigned ALL = (1u << (TILE / H)) - 1u;\n"
_ROWS = "constexpr int FWD_ROWS = 2;"
_HALVING = (
    "          warp_sum_halving(g, lane);\n"
    "          if (slot >= 0) red[warp][slot][j] = g[0];\n"
)
_BUTTERFLY = """#pragma unroll
          for (int q = 0; q < NGRAD; ++q) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              g[q] += __shfl_xor_sync(FULL, g[q], off);
            }
            if (lane == 0) red[warp][q][j] = g[q];
          }
"""
# variant → exact text replacements in the present sources
ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    # every warp visits every instance (the ballot loop stays)
    "no_cull": [(_WALK, _ALL_STRIPS, _ALL_STRIPS + "  return ALL;\n")],
    # one pixel per forward thread, 256 threads, masks per two rows
    "fwd_rows_1": [(_WALK, _ROWS, "constexpr int FWD_ROWS = 1;")],
    "no_cull_fwd_rows_1": [
        (_WALK, _ALL_STRIPS, _ALL_STRIPS + "  return ALL;\n"),
        (_WALK, _ROWS, "constexpr int FWD_ROWS = 1;"),
    ],
    # the backward's nine sums by nine xor butterflies (45 shuffles)
    "butterfly": [(_WALK, _HALVING, _BUTTERFLY)],
}

_TILE_BWD = "composite_tile_bwd.cu"
_COLS16 = "constexpr int TABLE_COLS = 16;"
_ADD_ROW = """  float4* row4 = reinterpret_cast<float4*>(row);
  atomicAdd(row4, make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(row4 + 1, make_float4(v[4], v[5], v[6], v[7]));
  atomicAdd(row + 8, v[8]);
"""
_ADD_ROW_SCALAR = """#pragma unroll
  for (int q = 0; q < NGRAD; ++q) atomicAdd(row + q, v[q]);
"""
_B_SCALAR = "  atomicAdd(row + 8, v[8]);\n"
_SKIP = "    if (zero) return;  // adding +-0 changes no value of the table\n"
SINK_ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    # nine scalar atomics into a (p, 9) table (the previous sink, new walk)
    "scalar_sink": [(_TILE_BWD, _COLS16, "constexpr int TABLE_COLS = 9;"),
                    (_TILE_BWD, _ADD_ROW, _ADD_ROW_SCALAR)],
    # b as a third float4 atomic (b, 0, 0, 0) instead of a scalar one
    "b_vec4": [(_TILE_BWD, _B_SCALAR,
                "  atomicAdd(row4 + 2, make_float4(v[8], 0.f, 0.f, 0.f));\n")],
    # every instance adds its rows, also the all-zero ones
    "no_skip": [(_TILE_BWD, _SKIP, "    (void)zero;\n")],
}
# the fused table's columns in each build (the present sources': 16)
_FUSED_COLS = {"scalar_sink": 9}

_REDUCE = "reduce_accum.cu"
_ADD16 = """#pragma unroll
  for (int k = 0; k < NROWS / 4; ++k) {
    atomicAdd(row4 + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                    v[4 * k + 3]));
  }
"""
REDUCE_ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    # every lane adds its own values, also where the warp's ids repeat
    "no_warp_agg": [(_REDUCE, "    const unsigned peers = __match_any_sync(FULL, g);\n",
                     "    const unsigned peers = 1u << lane;\n")],
    # 16 scalar atomics into the (P, 16) table, no float4
    "scalar_table": [(_REDUCE, _ADD16, """  (void)row4;
#pragma unroll
  for (int q = 0; q < NROWS; ++q) atomicAdd(row + q, v[q]);
""")],
}

_ABLATE = "kernel_ablate.cu"


def _off(name: str) -> List[Tuple[str, str, str]]:
    return [(_ABLATE, f"constexpr bool {name} = true;", f"constexpr bool {name} = false;")]


ABLATE_ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    # the last chunk's 128 lanes staged and walked, the count tested per pair
    "no_count_trim": _off("COUNT_TRIM"),
    # every visited lane runs the log1p tail (nocumsum, lowprec, full)
    "no_live_skip": _off("LIVE_SKIP"),
    # full: a warp whose pixels have all stopped walks the chunk all the same
    "no_warp_stop": _off("WARP_STOP"),
    # dma: every thread sums the 3 x 128 staged values itself
    "dma_per_thread": _off("DMA_ONCE"),
}
# the walk's ablations that #8 is built in: the strip test and two pixel
# rows per thread (the halving is the backward's)
ABLATE_WALK_ABLATIONS = ("no_cull", "fwd_rows_1")

# variant → the sources it is built from (the walk's ablations build every
# compositing source; the earlier tree every source compared)
_BUILT = {
    **{v: SOURCES + (("kernel_ablate",) if v in ABLATE_WALK_ABLATIONS else ())
       for v in ABLATIONS},
    **{v: ("composite_tile_bwd",) for v in SINK_ABLATIONS},
    **{v: ("reduce_accum",) for v in REDUCE_ABLATIONS},
    **{v: ("kernel_ablate",) for v in ABLATE_ABLATIONS},
}
_EDITS = {**ABLATIONS, **SINK_ABLATIONS, **REDUCE_ABLATIONS, **ABLATE_ABLATIONS}


def _variant_tree(name: str, edits) -> Path:
    """A copy of the present csrc/ with ``edits`` applied."""
    out = VARIANT_DIR / name / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_build.CSRC, out)
    for fname, old, new in edits:
        path = out / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {fname}")
        path.write_text(text.replace(old, new))
    return out


@functools.lru_cache(maxsize=None)
def build_variants(before: Optional[Path]) -> Dict[str, dict]:
    """Build the compared kernels from ``before`` (a csrc/ directory, or
    None) and from every ablation of the present sources, all in parallel,
    once per process → variant → {"libs": source → .so path, "ptxas":
    source → report}."""
    trees = {k: _variant_tree(k, e) for k, e in _EDITS.items()}
    built = dict(_BUILT)
    if before is not None:
        trees["before"] = before
        built["before"] = (*SOURCES, "reduce_accum", "kernel_ablate")
    jobs = {
        f"{variant}/{src}": (tree / f"{src}.cu", VARIANT_DIR / variant / f"{src}.so")
        for variant, tree in trees.items()
        for src in built[variant]
    }
    reports = cuda_build.compile_all(jobs)
    out = {}
    for key, (_, lib) in jobs.items():
        variant, src = key.split("/")
        entry = out.setdefault(variant, {"libs": {}, "ptxas": {}})
        entry["libs"][src] = lib
        entry["ptxas"][src] = reports[key]["ptxas"]
    return out


# kernel → (source, C symbol, argument types, the variants it is built in)
_SYMBOLS = {
    "composite_seg_fwd": ("composite_seg_fwd", "omnigs_composite_seg_fwd",
                          cs._LAUNCH_ARGTYPES, tuple(ABLATIONS)),
    "composite_seg_bwd": ("composite_seg_bwd", "omnigs_composite_seg_bwd",
                          cs._BWD_ARGTYPES, tuple(ABLATIONS)),
    "composite_tile_fwd": ("composite_tile_fwd", "omnigs_composite_tile_fwd",
                           ct._FWD_ARGTYPES, tuple(ABLATIONS)),
    "composite_tile_bwd": ("composite_tile_bwd", "omnigs_composite_tile_bwd",
                           ct._BWD_ARGTYPES, (*ABLATIONS, *SINK_ABLATIONS)),
    "composite_tile_bwd_fused": ("composite_tile_bwd", "omnigs_composite_tile_bwd_fused",
                                 ct._FUSED_ARGTYPES, (*ABLATIONS, *SINK_ABLATIONS)),
    "reduce_accum": ("reduce_accum", "omnigs_reduce_accum", rb._ARGTYPES,
                     tuple(REDUCE_ABLATIONS)),
    "kernel_ablate": ("kernel_ablate", "omnigs_kernel_ablate", ka._ARGTYPES,
                      (*ABLATE_WALK_ABLATIONS, *ABLATE_ABLATIONS)),
}


def _launcher(lib: Path, kernel: str):
    _, symbol, argtypes, _ = _SYMBOLS[kernel]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch: CUDA error {err}")


def _bytes_equal(out, ref) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(out, ref))


def digest(outputs) -> str:
    """sha256 (16 hex digits) of the output tensors' bytes."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _compare(before: Optional[Path], runs: Dict[str, Callable], dev, reps: int,
             close: Optional[Dict[str, Callable]] = None, digests: bool = False) -> dict:
    """``runs``: kernel (or "kernel/case") → run(launcher, variant) →
    output tensors. Each kernel in the production build ("new"),
    ``before`` (when given) and the variants it is built in: its outputs
    against production's, bytes (``bytes_equal_new``; with ``digests``
    also each build's ``digest``) or, for the kernels in ``close`` (kernel
    → close(outputs) → ratio to a float bar), the ratio (``tol_ratio``); ms
    in turns earlier sources, production, variants…, variants reversed,
    production, earlier sources ("old, new, new, old")."""
    close = close or {}
    builds = build_variants(before)
    cuda_build.build({_SYMBOLS[k.split("/")[0]][0] for k in runs})
    result = {}
    for key, run in runs.items():
        kernel = key.split("/")[0]
        src, _, _, variants = _SYMBOLS[kernel]
        variants = list(variants)
        head = ["before"] if before is not None else []
        order = [*head, "new", *variants, *reversed(variants), "new", *head]
        launch = {"new": _launcher(cuda_build.library_path(src), kernel)}
        launch.update({v: _launcher(builds[v]["libs"][src], kernel)
                       for v in [*head, *variants]})
        with torch.inference_mode():
            ref = run(launch["new"], "new")
            rows = {}
            for v in ["new", *head, *variants]:
                out = run(launch[v], v)
                torch.cuda.synchronize(dev)
                rows[v] = {"ms": []}
                if key in close:
                    rows[v]["tol_ratio"] = close[key](out)
                else:
                    rows[v]["bytes_equal_new"] = _bytes_equal(out, ref)
                if digests:
                    rows[v]["digest"] = digest(out)
                if v != "new":
                    rows[v]["ptxas"] = builds[v]["ptxas"][src]
            for v in order:
                rows[v]["ms"].append(mean_ms(lambda v=v: run(launch[v], v), dev, reps=reps))
        result[key] = {"order": order, **rows}
    return result


def compare_seg(before: Path, slab, starts8, counts, color_full, dcolor,
                num_tiles: int, gx: int, reps: int = 20) -> dict:
    """Kernels #1 and #2 of every build on one segmented slab → {kernel:
    {"order": the timing order, variant: {"bytes_equal_new", "ms",
    "ptxas"}}}: whether its output bytes equal the production build's, its
    ptxas report, and its ms in turns."""
    dev = slab.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fwd(fn, _variant):
        color = torch.empty(num_tiles, 3, cs.PX, device=dev)
        final_t = torch.empty(num_tiles, cs.PX, device=dev)
        _checked(fn(slab.data_ptr(), slab.shape[1], starts8.data_ptr(), counts.data_ptr(),
                    num_tiles, gx, 0, color.data_ptr(), final_t.data_ptr(), dev.index,
                    stream), "seg_compare forward")
        return color, final_t

    def bwd(fn, _variant):
        dinst = torch.zeros_like(slab)
        _checked(fn(slab.data_ptr(), slab.shape[1], starts8.data_ptr(), counts.data_ptr(),
                    color_full.data_ptr(), dcolor.data_ptr(), num_tiles, gx, 0,
                    dinst.data_ptr(), dev.index, stream), "seg_compare backward")
        return (dinst,)

    return _compare(before, {"composite_seg_fwd": fwd, "composite_seg_bwd": bwd}, dev, reps)


def compare_tile(before: Path, slab, starts, counts, x0, y0, color_full, dcolor,
                 ids, num_gaussians: int, fused_close: Callable, num_tiles: int,
                 reps: int = 20) -> dict:
    """Kernels #3 (with n_contrib), #4 and #5 of every build on one compact
    slab, as `compare_seg`; #5 (rows summed per ``ids`` into each build's
    own table, (P, 9) or (P, 16), compared as (P, 9)) is held to
    ``fused_close`` ((P, 9) → ratio to a float bar) instead of bytes."""
    dev = slab.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = (starts.data_ptr(), counts.data_ptr(), x0.data_ptr(), y0.data_ptr())

    def fwd(fn, _variant):
        color = torch.empty(num_tiles, 3, ct.PX, device=dev)
        final_t = torch.empty(num_tiles, ct.PX, device=dev)
        ncontrib = torch.empty(num_tiles, ct.PX, dtype=torch.int32, device=dev)
        _checked(fn(slab.data_ptr(), slab.shape[1], *geo, num_tiles, 1, color.data_ptr(),
                    final_t.data_ptr(), ncontrib.data_ptr(), dev.index, stream),
                 "tile_compare forward")
        return color, final_t, ncontrib

    def bwd(fn, _variant):
        dinst = torch.zeros_like(slab)
        _checked(fn(slab.data_ptr(), slab.shape[1], *geo, color_full.data_ptr(),
                    dcolor.data_ptr(), num_tiles, dinst.data_ptr(), dev.index, stream),
                 "tile_compare backward")
        return (dinst,)

    def fused(fn, variant):
        cols = _FUSED_COLS.get(variant, ct.FUSED_TABLE_COLS)
        table = torch.zeros(num_gaussians, cols, device=dev)
        _checked(fn(slab.data_ptr(), slab.shape[1], ids.data_ptr(), ids.shape[0], *geo,
                    color_full.data_ptr(), dcolor.data_ptr(), num_tiles, num_gaussians,
                    table.data_ptr(), dev.index, stream), "tile_compare fused backward")
        return (table[:, : ct.NGRAD],)

    return _compare(
        before,
        {"composite_tile_fwd": fwd, "composite_tile_bwd": bwd,
         "composite_tile_bwd_fused": fused},
        dev, reps, close={"composite_tile_bwd_fused": lambda out: fused_close(out[0])},
    )


def compare_reduce(before: Optional[Path], ids, rows, p: int, close: Callable,
                   reps: int = 10) -> dict:
    """Kernel #6 of every build (``before`` when given, production,
    `REDUCE_ABLATIONS`) on ids (live,) int32 and rows (16, R) → {"order",
    variant: {"tol_ratio", "ms", "ptxas"}}, each output (16, P) held to
    ``close`` (→ ratio to a float bar)."""
    dev = rows.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn, _variant):
        # the tables as the wrapper allocates them: a zeroed (P, 16) scratch
        # table, and the result, of which the kernel writes every value
        acc = torch.empty(rb.NROWS, p, device=dev)
        scratch = torch.zeros(p, rb.NROWS, device=dev)
        _checked(fn(ids.data_ptr(), rows.data_ptr(), rows.shape[1], ids.shape[0], p,
                    scratch.data_ptr(), acc.data_ptr(), dev.index, stream),
                 "reduce_compare")
        return (acc,)

    res = _compare(before, {"reduce_accum": run}, dev, reps,
                   close={"reduce_accum": lambda out: close(out[0])})
    return res["reduce_accum"]


def compare_ablate(before: Optional[Path], inst_T, starts, counts, x0, y0,
                   reps: int = 10) -> dict:
    """Kernel #8 of every build (``before`` when given, production, the
    walk's `ABLATE_WALK_ABLATIONS` and `ABLATE_ABLATIONS`) in each of its
    six modes on one slab (its script's) → {mode: {"order", variant:
    {"bytes_equal_new", "digest", "ms", "ptxas"}}}."""
    dev = inst_T.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    num_tiles = counts.shape[0]

    def runner(mode):
        def run(fn, _variant):
            out = torch.empty(num_tiles, 3, ka.PX, device=dev)
            _checked(fn(ka.MODES.index(mode), inst_T.data_ptr(), inst_T.shape[1],
                        starts.data_ptr(), counts.data_ptr(), x0.data_ptr(), y0.data_ptr(),
                        num_tiles, out.data_ptr(), dev.index, stream),
                     f"ablate_compare {mode}")
            return (out,)
        return run

    res = _compare(before, {f"kernel_ablate/{m}": runner(m) for m in ka.MODES}, dev, reps,
                   digests=True)
    return {key.split("/")[1]: v for key, v in res.items()}
