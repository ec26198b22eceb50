"""Instance → Gaussian gradient reduction strategies, timed on one card.

The port's copy of `scripts/reduce_bench.py`, at the same sizes: R =
8704·128 slab rows, P = 2^17 Gaussians, the first ⌊0.92·R⌋ (rounded down to
128) of them live, ids and rows from a seeded `torch.Generator`. It times
and prints, for each strategy, ms, ns per live row and the max |Δ| from (a):

  a) the port's live-bound scatter reduction of the (R, 9) rows
     (`composite_tile._scatter_reduce`, the production path);
  b) kernel #6, `reduce_accum`: hand-written CUDA (`csrc/reduce_accum.cu`,
     replacing the TPU kernel `scripts/reduce_bench.py::_reduce_kernel`)
     that adds every live instance's 16 rows into a Gaussian-major (P, 16)
     table with four float4 atomics (lanes of a warp with the same id sum
     first), then transposes it into the (16, P) result;
  c) sort by Gaussian, gather the rows, f32 cumsum and segment difference
     (for the record).

    python -m omnigs_torch.scripts.reduce_bench [R] [P] [--device cpu]

On the CPU (``--device cpu``) `reduce_accum` runs its plain version.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from omnigs_torch import cuda_build
from omnigs_torch.ops.composite_tile import _scatter_reduce
from omnigs_torch.utils import profiling
from omnigs_torch.utils.profiling import mean_ms

NROWS = 16
CHUNK = 128
LIVE_FRAC = 0.92  # live rows of the slab cap at the production reduction

_VP = ctypes.c_void_p
# omnigs_reduce_accum(ids, rows, r, live, p, scratch, acc, device, stream)
_ARGTYPES = [_VP, _VP, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _VP,
             _VP, ctypes.c_int, _VP]


def reduce_accum_plain(ids: torch.Tensor, rows: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version of kernel #6: one ``index_add_`` of the first
    ``len(ids)`` columns of ``rows`` into a zero (16, P) table."""
    acc = torch.zeros(NROWS, p, dtype=rows.dtype, device=rows.device)
    return acc.index_add_(1, ids.to(torch.int64), rows[:, : ids.shape[0]])


def reduce_accum(ids: torch.Tensor, rows: torch.Tensor, p: int) -> torch.Tensor:
    """(16, P) f32 table: column g holds the sum of ``rows[:, j]`` over the
    j < len(ids) with ``ids[j] == g`` (ids (live,) int32 in [0, P), rows
    (16, R) f32 with R ≥ live).

    On a CUDA tensor it launches `csrc/reduce_accum.cu` (the accumulate
    into a zeroed (P, 16) scratch table and its transpose, counted as one
    launch, `utils.profiling.count_launch`); its float atomics sum in no fixed
    order, so the last bits vary from run to run. On a CPU tensor it runs
    `reduce_accum_plain`.
    """
    if rows.device.type == "cpu":
        return reduce_accum_plain(ids, rows, p)
    if rows.device.type != "cuda":
        raise ValueError(f"reduce_accum: unsupported device {rows.device}")
    dev = rows.device
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[0] != NROWS:
        raise ValueError(f"rows must be ({NROWS}, R) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if (ids.dtype != torch.int32 or ids.ndim != 1 or ids.device != dev
            or ids.shape[0] > rows.shape[1]):
        raise ValueError(f"ids must be (live,) int32 on {dev} with live ≤ "
                         f"{rows.shape[1]}")
    if not rows.is_contiguous() or not ids.is_contiguous():
        raise ValueError("rows and ids must be contiguous")
    scratch = torch.zeros(p, NROWS, dtype=torch.float32, device=dev)
    acc = torch.empty(NROWS, p, dtype=torch.float32, device=dev)
    lib, fn = cuda_build.launcher("reduce_accum", "reduce_accum", _ARGTYPES)
    err = fn(ids.data_ptr(), rows.data_ptr(), rows.shape[1], ids.shape[0], p,
             scratch.data_ptr(), acc.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "reduce_accum launch")
    profiling.count_launch("reduce_accum")
    return acc



def make_inputs(r: int, p: int, device, seed: int = 0):
    """(ids (R,) int32 uniform in [0, P), rows (16, R) N(0, 1) f32, live)."""
    live = int(r * LIVE_FRAC) // CHUNK * CHUNK
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, p, (r,), generator=gen, device=device, dtype=torch.int32)
    rows = torch.randn(NROWS, r, generator=gen, device=device)
    return ids, rows, live


def sort_reduce(ids: torch.Tensor, rows9: torch.Tensor, p: int) -> torch.Tensor:
    """(P, 9): sort by Gaussian, gather the rows, one f32 cumsum, and the
    difference at each Gaussian's segment ends."""
    sid, pos = torch.sort(ids)
    cs = torch.cat([rows9.new_zeros(1, rows9.shape[1]), torch.cumsum(rows9[pos], dim=0)])
    g = torch.arange(p, dtype=sid.dtype, device=sid.device)
    lo = torch.searchsorted(sid, g, right=False)
    hi = torch.searchsorted(sid, g, right=True)
    return cs[hi] - cs[lo]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("r", nargs="?", type=int, default=8704 * 128)
    ap.add_argument("p", nargs="?", type=int, default=1 << 17)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    r, p = args.r, args.p
    ids, rows, live = make_inputs(r, p, dev)
    live_t = torch.tensor(live, device=dev)
    rows9 = rows[:9].T.contiguous()  # (R, 9) as the scatter path consumes it
    out = {"r": r, "p": p, "live": live}

    def run(key, label, fn, ref):
        ms = mean_ms(fn, dev, reps=args.reps)
        acc = fn()
        err = None if ref is None else float((acc - ref).abs().max())
        out[key] = {"ms": ms, "ns_per_row": ms * 1e6 / live, "max_abs_err": err}
        tail = "" if err is None else f"  maxerr={err:.2e}"
        print(f"{label} live={live}: {ms:8.3f} ms ({ms * 1e6 / live:.2f} ns/row){tail}",
              flush=True)
        return acc

    acc_a = run("scatter", "a) port scatter-reduce  ",
                lambda: _scatter_reduce(rows, ids, live_t, p), None)
    run("reduce_accum", "b) reduce_accum (#6)    ",
        lambda: reduce_accum(ids[:live], rows, p)[:9].T, acc_a)
    run("sort", "c) sort+gather+diff     ",
        lambda: sort_reduce(ids[:live], rows9[:live], p), acc_a)
    return out


if __name__ == "__main__":
    main()
