"""Other builds of the segmented compositing kernels, timed in turns with
the production build on the same inputs.

`chip_smoke.py`'s `seg_compare` phase runs `compare_seg` on its full-width
slab when a copy of an earlier tree's CUDA sources is present (for
example `git archive <commit> omnigs_torch/csrc | tar -x -C
build/seg_before`): the earlier sources' kernels #1/#2 against the present
ones, and the present sources with one design element of
`csrc/composite_seg_walk.cuh` taken out (`ABLATIONS`), each built by nvcc
with the production flags into ``build/seg_variants/<variant>/``. Every
build must give the production build's output bytes; the times say what
each element buys. Nothing here is on a render or training path.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops import composite_seg as cs
from omnigs_torch.utils.profiling import mean_ms

VARIANT_DIR = cuda_build.BUILD_DIR.parent / "seg_variants"
SOURCES = ("composite_seg_fwd", "composite_seg_bwd")
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
    "butterfly": [("composite_seg_bwd.cu", _HALVING, _BUTTERFLY)],
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


def build_variants(before: Path) -> Dict[str, dict]:
    """Build kernels #1/#2 from ``before`` (a csrc/ directory) and from
    every ablation of the present sources, all in parallel → variant →
    {"libs": source → .so path, "ptxas": source → report}."""
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


def _launchers(lib_paths: Dict[str, Path]):
    libs = {src: ctypes.CDLL(str(p)) for src, p in lib_paths.items()}
    fwd = libs["composite_seg_fwd"].omnigs_composite_seg_fwd
    fwd.argtypes, fwd.restype = cs._LAUNCH_ARGTYPES, ctypes.c_int
    bwd = libs["composite_seg_bwd"].omnigs_composite_seg_bwd
    bwd.argtypes, bwd.restype = cs._BWD_ARGTYPES, ctypes.c_int
    return fwd, bwd


def compare_seg(before: Path, slab, starts8, counts, color_full, dcolor,
                num_tiles: int, gx: int, reps: int = 20) -> dict:
    """Kernels #1 and #2 of every build on one slab → {"order": the timing
    order, kernel: {variant: {"bytes_equal_new", "ms", "ptxas"}}}: whether
    its output bytes equal the production build's, its ptxas report, and
    its ms in turns earlier sources, production, ablations…, ablations
    reversed, production, earlier sources ("old, new, new, old")."""
    dev = slab.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    builds = build_variants(before)
    cuda_build.build(SOURCES)
    launch = {"new": _launchers({s: cuda_build.library_path(s) for s in SOURCES})}
    launch.update({v: _launchers(b["libs"]) for v, b in builds.items()})

    def fwd(fn):
        color = torch.empty(num_tiles, 3, cs.PX, device=dev)
        final_t = torch.empty(num_tiles, cs.PX, device=dev)
        err = fn(slab.data_ptr(), slab.shape[1], starts8.data_ptr(), counts.data_ptr(),
                 num_tiles, gx, 0, color.data_ptr(), final_t.data_ptr(), dev.index, stream)
        if err:
            raise RuntimeError(f"seg_compare forward launch: CUDA error {err}")
        return color, final_t

    def bwd(fn):
        dinst = torch.zeros_like(slab)
        err = fn(slab.data_ptr(), slab.shape[1], starts8.data_ptr(), counts.data_ptr(),
                 color_full.data_ptr(), dcolor.data_ptr(), num_tiles, gx, 0,
                 dinst.data_ptr(), dev.index, stream)
        if err:
            raise RuntimeError(f"seg_compare backward launch: CUDA error {err}")
        return (dinst,)

    order = ["before", "new", *ABLATIONS, *reversed(list(ABLATIONS)), "new", "before"]
    result = {"order": order}
    for idx, (kernel, run) in enumerate((("composite_seg_fwd", fwd), ("composite_seg_bwd", bwd))):
        with torch.inference_mode():
            ref = run(launch["new"][idx])
            rows = {}
            for v in ["new", "before", *ABLATIONS]:
                out = run(launch[v][idx])
                torch.cuda.synchronize(dev)
                rows[v] = {
                    "bytes_equal_new": all(
                        torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(out, ref)
                    ),
                    "ms": [],
                }
                if v != "new":
                    rows[v]["ptxas"] = builds[v]["ptxas"][kernel]
            for v in order:
                rows[v]["ms"].append(
                    mean_ms(lambda v=v: run(launch[v][idx]), dev, reps=reps)
                )
        result[kernel] = rows
    return result
