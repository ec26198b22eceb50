"""Other builds of the compositing kernels #1-#4, timed in turns with the
production build on the same inputs.

`chip_smoke.py`'s `seg_compare` and `tile_compare` phases run
`compare_seg` (kernels #1/#2 on the segmented slab) and `compare_tile`
(#3/#4 on the compact slab) at full width when a copy of an earlier tree's
CUDA sources is present (for example `git archive <commit>
omnigs_torch/csrc | tar -x -C build/seg_before`): the earlier sources'
kernels against the present ones, and the present sources with one design
element of the shared walk `csrc/composite_seg_walk.cuh` taken out
(`ABLATIONS`; each edit acts on the segmented and the tile-major kernels
at once), each built by nvcc with the production flags into
``build/seg_variants/<variant>/``. Every build must give the production
build's output bytes; the times say what each element buys. Nothing here
is on a render or training path.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops import composite_seg as cs
from omnigs_torch.ops import composite_tile as ct
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
def build_variants(before: Path) -> Dict[str, dict]:
    """Build kernels #1-#4 from ``before`` (a csrc/ directory) and from
    every ablation of the present sources, all in parallel, once per
    process → variant → {"libs": source → .so path, "ptxas": source →
    report}."""
    trees = {"before": before}
    trees.update({k: _variant_tree(k, e) for k, e in ABLATIONS.items()})
    jobs = {
        f"{variant}/{src}": (tree / f"{src}.cu", VARIANT_DIR / variant / f"{src}.so")
        for variant, tree in trees.items()
        for src in SOURCES
    }
    reports = cuda_build.compile_all(jobs)
    out = {}
    for key, (_, lib) in jobs.items():
        variant, src = key.split("/")
        entry = out.setdefault(variant, {"libs": {}, "ptxas": {}})
        entry["libs"][src] = lib
        entry["ptxas"][src] = reports[key]["ptxas"]
    return out


# kernel → (source, C symbol, argument types)
_SYMBOLS = {
    "composite_seg_fwd": ("composite_seg_fwd", "omnigs_composite_seg_fwd",
                          cs._LAUNCH_ARGTYPES),
    "composite_seg_bwd": ("composite_seg_bwd", "omnigs_composite_seg_bwd",
                          cs._BWD_ARGTYPES),
    "composite_tile_fwd": ("composite_tile_fwd", "omnigs_composite_tile_fwd",
                           ct._FWD_ARGTYPES),
    "composite_tile_bwd": ("composite_tile_bwd", "omnigs_composite_tile_bwd",
                           ct._BWD_ARGTYPES),
}


def _launcher(lib: Path, kernel: str):
    _, symbol, argtypes = _SYMBOLS[kernel]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch: CUDA error {err}")


def _compare(before: Path, runs: Dict[str, Callable], dev, reps: int) -> dict:
    """``runs``: kernel → run(launcher) → output tensors. Every build's
    bytes against production's, ms in turns earlier sources, production,
    ablations…, ablations reversed, production, earlier sources ("old, new,
    new, old")."""
    builds = build_variants(before)
    kernels = list(runs)
    cuda_build.build([_SYMBOLS[k][0] for k in kernels])
    order = ["before", "new", *ABLATIONS, *reversed(list(ABLATIONS)), "new", "before"]
    result = {"order": order}
    for kernel, run in runs.items():
        src = _SYMBOLS[kernel][0]
        launch = {"new": _launcher(cuda_build.library_path(src), kernel)}
        launch.update({v: _launcher(b["libs"][src], kernel) for v, b in builds.items()})
        with torch.inference_mode():
            ref = run(launch["new"])
            rows = {}
            for v in ["new", "before", *ABLATIONS]:
                out = run(launch[v])
                torch.cuda.synchronize(dev)
                rows[v] = {
                    "bytes_equal_new": all(
                        torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(out, ref)
                    ),
                    "ms": [],
                }
                if v != "new":
                    rows[v]["ptxas"] = builds[v]["ptxas"][src]
            for v in order:
                rows[v]["ms"].append(mean_ms(lambda v=v: run(launch[v]), dev, reps=reps))
        result[kernel] = rows
    return result


def compare_seg(before: Path, slab, starts8, counts, color_full, dcolor,
                num_tiles: int, gx: int, reps: int = 20) -> dict:
    """Kernels #1 and #2 of every build on one segmented slab → {"order":
    the timing order, kernel: {variant: {"bytes_equal_new", "ms",
    "ptxas"}}}: whether its output bytes equal the production build's, its
    ptxas report, and its ms in turns."""
    dev = slab.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fwd(fn):
        color = torch.empty(num_tiles, 3, cs.PX, device=dev)
        final_t = torch.empty(num_tiles, cs.PX, device=dev)
        _checked(fn(slab.data_ptr(), slab.shape[1], starts8.data_ptr(), counts.data_ptr(),
                    num_tiles, gx, 0, color.data_ptr(), final_t.data_ptr(), dev.index,
                    stream), "seg_compare forward")
        return color, final_t

    def bwd(fn):
        dinst = torch.zeros_like(slab)
        _checked(fn(slab.data_ptr(), slab.shape[1], starts8.data_ptr(), counts.data_ptr(),
                    color_full.data_ptr(), dcolor.data_ptr(), num_tiles, gx, 0,
                    dinst.data_ptr(), dev.index, stream), "seg_compare backward")
        return (dinst,)

    return _compare(before, {"composite_seg_fwd": fwd, "composite_seg_bwd": bwd}, dev, reps)


def compare_tile(before: Path, slab, starts, counts, x0, y0, color_full, dcolor,
                 num_tiles: int, reps: int = 20) -> dict:
    """Kernels #3 (with n_contrib) and #4 of every build on one compact
    slab, as `compare_seg`."""
    dev = slab.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = (starts.data_ptr(), counts.data_ptr(), x0.data_ptr(), y0.data_ptr())

    def fwd(fn):
        color = torch.empty(num_tiles, 3, ct.PX, device=dev)
        final_t = torch.empty(num_tiles, ct.PX, device=dev)
        ncontrib = torch.empty(num_tiles, ct.PX, dtype=torch.int32, device=dev)
        _checked(fn(slab.data_ptr(), slab.shape[1], *geo, num_tiles, 1, color.data_ptr(),
                    final_t.data_ptr(), ncontrib.data_ptr(), dev.index, stream),
                 "tile_compare forward")
        return color, final_t, ncontrib

    def bwd(fn):
        dinst = torch.zeros_like(slab)
        _checked(fn(slab.data_ptr(), slab.shape[1], *geo, color_full.data_ptr(),
                    dcolor.data_ptr(), num_tiles, dinst.data_ptr(), dev.index, stream),
                 "tile_compare backward")
        return (dinst,)

    return _compare(before, {"composite_tile_fwd": fwd, "composite_tile_bwd": bwd}, dev, reps)
