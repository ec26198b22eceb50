"""The best case of a bucketed counting sort, timed on one card.

The port's copy of `scripts/bucket_emit_bench.py`: instead of sorting the
(Gaussian, tile) instances, each one writes its 16-float row straight to
its slot. The best case keeps every destination inside the row's own block
of K = 2048 rows (block-local permutations), which kernel #7,
`bucket_emit` (a hand-written CUDA kernel, `csrc/bucket_emit.cu`,
replacing the TPU kernel `scripts/bucket_emit_bench.py::_emit_kernel`),
measures at R = 2^20 rows. It also times the incumbent that such a kernel
would have to beat, a 1-key sort of R int32 keys (`torch.sort`), and prints
ns per row for both. Slots, rows and keys come from a numpy seed of 0, as
in the JAX script.

    python -m omnigs_torch.scripts.bucket_emit_bench [R] [--device cpu]

On the CPU (``--device cpu``) `bucket_emit` runs its plain version.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from omnigs_torch import cuda_build
from omnigs_torch.utils import profiling
from omnigs_torch.utils.profiling import mean_ms

NROWS = 16
K = 2048  # rows per block: every slot lies inside its row's block

_VP = ctypes.c_void_p
# omnigs_bucket_emit(slots, data, r, k, out, device, stream)
_ARGTYPES = [_VP, _VP, ctypes.c_longlong, ctypes.c_int, _VP, ctypes.c_int, _VP]


def emit_index(slots: torch.Tensor) -> torch.Tensor:
    """(R,) int64 destination row of every row: its block's first row plus
    its slot."""
    j = torch.arange(slots.numel(), device=slots.device)
    return j // K * K + slots.reshape(-1).to(torch.int64)


def bucket_emit_plain(slots: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel #7: one index assignment."""
    out = torch.empty_like(data)
    out[emit_index(slots)] = data
    return out


def bucket_emit(slots: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(R, 16) f32 with ``out[b·K + slots[b·K + j]] = data[b·K + j]``:
    ``slots`` (R, 1) or (R,) int32 a permutation of 0..K−1 inside each
    block of K rows, ``data`` (R, 16) f32, R a multiple of K.

    On a CUDA tensor it launches `csrc/bucket_emit.cu` and counts the
    launch (`utils.profiling.count_launch`; the output equals the plain
    version's bit for bit); on a CPU tensor it runs `bucket_emit_plain`.
    """
    if data.device.type == "cpu":
        return bucket_emit_plain(slots, data)
    if data.device.type != "cuda":
        raise ValueError(f"bucket_emit: unsupported device {data.device}")
    dev = data.device
    r = data.shape[0]
    if (data.dtype != torch.float32 or data.ndim != 2 or data.shape[1] != NROWS
            or r % K != 0 or not data.is_contiguous() or data.data_ptr() % 16 != 0):
        raise ValueError(f"data must be contiguous, 16-byte aligned (R, {NROWS}) "
                         f"float32 with R a multiple of {K}, got {tuple(data.shape)}")
    if (slots.dtype != torch.int32 or slots.numel() != r or slots.device != dev
            or not slots.is_contiguous()):
        raise ValueError(f"slots must be contiguous ({r},) or ({r}, 1) int32 on {dev}")
    out = torch.empty_like(data)
    lib, fn = cuda_build.launcher("bucket_emit", "bucket_emit", _ARGTYPES)
    err = fn(slots.data_ptr(), data.data_ptr(), r, K, out.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "bucket_emit launch")
    profiling.count_launch("bucket_emit")
    return out



def make_inputs(r: int, seed: int = 0):
    """numpy (slots (R, 1) int32 block-local permutations, data (R, 16) f32
    N(0, 1), keys (R,) int32 uniform in [0, 2^31)), drawn in the JAX
    script's order."""
    grid = r // K
    rng = np.random.default_rng(seed)
    slots = np.stack([rng.permutation(K).astype(np.int32) for _ in range(grid)])
    data = rng.standard_normal((grid * K, NROWS), dtype=np.float32)
    keys = rng.integers(0, 1 << 31, r, dtype=np.int32)
    return slots.reshape(grid * K, 1), data, keys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("r", nargs="?", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    slots, data, keys = (torch.from_numpy(a).to(dev) for a in make_inputs(args.r))
    r = data.shape[0]
    ms = mean_ms(lambda: bucket_emit(slots, data), dev, reps=args.reps)
    print(f"block-local per-row emit: {ms:8.3f} ms for {r} rows "
          f"({ms * 1e6 / r:6.2f} ns/row)", flush=True)
    ms_s = mean_ms(lambda: torch.sort(keys), dev, reps=args.reps)
    print(f"torch.sort 1-key:         {ms_s:8.3f} ms for {keys.numel()} rows "
          f"({ms_s * 1e6 / keys.numel():6.2f} ns/row)", flush=True)
    return {"rows": r, "emit_ms": ms, "emit_ns_per_row": ms * 1e6 / r,
            "sort_ms": ms_s, "sort_ns_per_row": ms_s * 1e6 / keys.numel()}


if __name__ == "__main__":
    main()
