"""Ablations of the elementwise tile-major forward compositing, timed on one
card.

The port's copy of `scripts/kernel_ablate.py`: kernel #8, `kernel_ablate`
(a hand-written CUDA kernel, `csrc/kernel_ablate.cu`, replacing the TPU
kernel `scripts/kernel_ablate.py::make_kernel`), runs the chunked
elementwise forward of the early tile-major kernels with parts removed, to
attribute its cost per chunk (the copy floor, the α math, the
transcendentals, the prefix sums, the color product, bf16 operands):

  dma, alpha, notrans, nocumsum, lowprec, full

Each mode keeps the TPU kernel's function bit for bit; on the card all six
run one staging and one walk, so "mode − dma" is what the mode's
arithmetic costs there. ``dma`` is the staging floor (the TPU's
double-buffered DMA windows hid load latency in a grid that runs in order;
on the card other resident blocks do), ``alpha`` the α math of the visited
pairs, ``notrans`` the compositing without transcendentals, ``nocumsum``
the log1p/exp pair per live pair, ``full`` the prefix, the division and
the mask on top. ``lowprec`` rounds the operands to bf16: on the TPU that
saved matrix-unit passes of the prefix and color products; on the card
those are sequential per pixel, so it only adds conversions.

It runs on the ghost-aligned slab of one pose at lonlat 1920×960: P = 2^17
Gaussians of the JAX package's example model (`__graft_entry__.py`'s
`_example_model`, drawn here from a seeded `torch.Generator` by
`example.example_model`), the view
matrix the identity, SH degree 3, tight culling; `bin_instances_aligned`
with tile culling at R = 2^21, tiles trimmed to a 7·2^18 slab, and
`composite_tile._build_inst`. It prints ms per mode, and the max |Δ|
between `full`'s color and kernel #3's (`composite_tile_fwd`, background
0) on the same slab — a finding, not a gate: the two composite in other
orders.

    python -m omnigs_torch.scripts.kernel_ablate [--device cpu]

On the CPU (``--device cpu``, with small ``--width/--height/--gaussians``)
`kernel_ablate` runs its plain version.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from omnigs_torch import cuda_build
from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.ops import composite_tile as ct
from omnigs_torch.ops.binning import bin_instances_aligned
from omnigs_torch.ops.composite_seg import (
    ALPHA_MAX, ALPHA_MIN, FWD_STRIP, PX, T_STOP, TILE, _warp_bits,
)
from omnigs_torch.ops.preprocess import tile_grid
from omnigs_torch.scripts.example import example_model, preprocess_model
from omnigs_torch.utils import profiling
from omnigs_torch.utils.profiling import mean_ms

MODES = ("dma", "alpha", "notrans", "nocumsum", "lowprec", "full")
CHUNK = 128
NSTAGE = 9  # slab rows the modes read: x y A B C op r g b (dma: x y A)

_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# omnigs_kernel_ablate(mode, inst, rpad, starts, counts, x0, y0, num_tiles,
#                      out, device, stream)
_ARGTYPES = [_I32, _VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _I32, _VP, _I32, _VP]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _chunk_colors(mode, d, c, counts, px, py, n):
    """One chunk of every tile: (color increment (T, 3, PX), new N (T, PX),
    live (T, PX) int32 pairs with a > 0 per pixel, bits (T, CHUNK) int32
    `_warp_bits` of each lane's live pixels), with ``d`` (rows, T, CHUNK)
    the chunk's staged rows, one lane at a time with the kernel's operations
    in its order."""
    n_live = torch.zeros(n.shape, dtype=torch.int32, device=n.device)
    bits = torch.zeros(n.shape[0], CHUNK, dtype=torch.int32, device=n.device)
    if mode == "dma":
        sums = torch.zeros_like(d[:3, :, 0])
        for k in range(CHUNK):
            sums = sums + d[:3, :, k]
        return sums.T[:, :, None].expand(-1, -1, PX), n, n_live, bits
    zero = torch.zeros_like(n)
    total, cs, wr, wg, wb = zero, zero, zero, zero, zero
    for k in range(CHUNK):
        x, y, A, B, C, op, r, g, b = (d[q, :, k, None] for q in range(NSTAGE))
        dx = x - px
        dy = y - py
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        alpha = torch.clamp_max(op * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
        live = ((c * CHUNK + k) < counts)[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        n_live += live.to(torch.int32)
        bits[:, k] = _warp_bits(live)
        a = torch.where(live, alpha, 0.0)
        if mode == "alpha":
            total = total + a
            continue
        if mode == "notrans":
            cs = cs + (-a)
            w = a * (n * (1.0 + cs))
            total = total + a
        else:
            l = torch.log1p(-a)
            total = total + l
            if mode == "nocumsum":
                w = a * (n * torch.exp(l))
            elif mode == "lowprec":
                cs = cs + _bf16(l)
                w = _bf16(a * (n * torch.exp(cs)))
                r, g, b = _bf16(r), _bf16(g), _bf16(b)
            else:  # full
                cs = cs + l
                n_incl = n * torch.exp(cs)
                w = a * (n_incl / (1.0 - a)) * (n_incl >= T_STOP).to(a.dtype)
        wr = wr + r * w
        wg = wg + g * w
        wb = wb + b * w
    if mode == "alpha":
        return total[:, None, :].expand(-1, 3, -1), n * 0.9999, n_live, bits
    if mode == "notrans":
        n = n * (1.0 - total * 1e-6)
    else:
        n = n * torch.exp(total)
    return torch.stack([wr, wg, wb], dim=1), n, n_live, bits


def kernel_ablate_plain(mode, inst_T, starts, counts, x0, y0, warp_gate=None):
    """Plain version of kernel #8 → (color (T, 3, PX), visited (T,) int64
    chunks each tile walked, live (T,) int64 lane-pixel pairs with a > 0 in
    them, walked (T, PX) int64 lanes each pixel's warp walks): every tile's
    chunks in order, all tiles and pixels at once, each chunk's lanes one at
    a time with the kernel's operations in its order.

    ``walked`` counts what the kernel's warps (`FWD_STRIP` pixel rows each)
    walk: the lanes below the count in the visited chunks, less in ``full``
    the chunks at whose start every pixel of the warp has N < T_STOP.
    ``warp_gate``, an (R,) int32 zero tensor if given, gets at each walked
    lane the `_warp_bits` of its live pixels."""
    num_tiles = counts.shape[0]
    dev = inst_T.device
    rpad = inst_T.shape[1]
    px, py = ct._tile_pixels(x0, y0)
    n = torch.ones(num_tiles, PX, device=dev)
    color = torch.zeros(num_tiles, 3, PX, device=dev)
    visited = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    live = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    walked = torch.zeros(num_tiles, PX, dtype=torch.int64, device=dev)
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    rows = 3 if mode == "dma" else NSTAGE
    lane = torch.arange(CHUNK, device=dev)
    strip = TILE * FWD_STRIP  # pixels of a kernel warp
    for c in range(int(n_chunks.max()) if num_tiles else 0):
        go = (c < n_chunks) & (n >= T_STOP).any(dim=1)
        if not bool(go.any()):
            break
        at = starts.to(torch.int64)[:, None] + c * CHUNK + lane
        d = torch.where(at < rpad, inst_T[:rows, torch.clamp_max(at, rpad - 1)], 0.0)
        dc, n_new, n_live, bits = _chunk_colors(mode, d, c, counts, px, py, n)
        below = torch.clamp(counts.to(torch.int64) - c * CHUNK, 0, CHUNK)
        warp_go = go[:, None].expand(-1, PX // strip)
        if mode == "full":
            warp_go = warp_go & (n >= T_STOP).reshape(num_tiles, -1, strip).any(dim=2)
        walked += torch.where(warp_go, below[:, None], 0).repeat_interleave(strip, dim=1)
        color = torch.where(go[:, None, None], color + dc, color)
        n = torch.where(go[:, None], n_new, n)
        visited += go
        live += torch.where(go, n_live.sum(dim=1, dtype=torch.int64), 0)
        if warp_gate is not None:
            walk = go[:, None] & (lane < below[:, None])
            warp_gate[at[walk]] = bits[walk]
    return color, visited, live, walked


def kernel_ablate(mode, inst_T, starts, counts, x0, y0) -> torch.Tensor:
    """(T, 3, PX) f32 color planes of ablation ``mode`` (one of MODES) over
    the chunk-aligned slab ``inst_T`` (16, rpad) f32 and the (T,) int32
    ``starts``, ``counts``, pixel origins ``x0``, ``y0`` (the function in
    `csrc/kernel_ablate.cu`'s header).

    On a CUDA tensor it launches `csrc/kernel_ablate.cu` and counts the
    launch (`utils.profiling.count_launch`); on a CPU tensor it runs
    `kernel_ablate_plain`.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}, one of {MODES}")
    if inst_T.device.type == "cpu":
        return kernel_ablate_plain(mode, inst_T, starts, counts, x0, y0)[0]
    if inst_T.device.type != "cuda":
        raise ValueError(f"kernel_ablate: unsupported device {inst_T.device}")
    num_tiles = counts.shape[0]
    ct._check_inputs(inst_T, starts, counts, x0, y0, num_tiles)
    dev = inst_T.device
    out = torch.empty(num_tiles, 3, PX, dtype=torch.float32, device=dev)
    lib, fn = cuda_build.launcher("kernel_ablate", "kernel_ablate", _ARGTYPES)
    err = fn(MODES.index(mode), inst_T.data_ptr(), inst_T.shape[1], starts.data_ptr(),
             counts.data_ptr(), x0.data_ptr(), y0.data_ptr(), num_tiles, out.data_ptr(),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "kernel_ablate launch")
    profiling.count_launch("kernel_ablate")
    return out



def build_slab(device, width=1920, height=960, gaussians=1 << 17,
               max_instances=1 << 21, cap=7 << 18, seed=0) -> dict:
    """The aligned slab of the script's pose: preprocess, ghost-aligned
    binning with tile culling, the trim of tiles whose padded segment
    crosses ``cap`` (their counts zeroed) and the full slab gather."""
    camera = Camera(CameraType.LONLAT, width, height)
    gx, gy = tile_grid(camera)
    prep = preprocess_model(example_model(gaussians, device, seed), camera)
    with torch.no_grad():
        inst = bin_instances_aligned(prep, gx, gy, max_instances, CHUNK, tile_cull=True)
        padded = (inst.counts + CHUNK - 1) // CHUNK * CHUNK
        fits = inst.starts + padded <= cap
        counts = torch.where(fits, inst.counts, 0)
        starts = torch.clamp(inst.starts, 0, cap - CHUNK)
        sorted_g = inst.sorted_g[:cap]
        # every lane gathered, ghost lanes included (they hold Gaussian 0)
        inst_T = ct._build_inst(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                                sorted_g, sorted_g.shape[0], None)
    x0, y0 = ct.tile_origins(gx, gy, device)
    return dict(inst_T=inst_T, starts=starts, counts=counts, x0=x0, y0=y0,
                num_tiles=gx * gy, truncated=int(inst.truncated),
                dropped_tiles=int((~fits & (inst.counts > 0)).sum()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    ap.add_argument("--max-instances", type=int, default=1 << 21)
    ap.add_argument("--cap", type=int, default=7 << 18)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    s = build_slab(dev, args.width, args.height, args.gaussians, args.max_instances,
                   args.cap)
    slab = (s["inst_T"], s["starts"], s["counts"], s["x0"], s["y0"])
    out = {"tiles": s["num_tiles"], "instances": int(s["counts"].sum()),
           "truncated": s["truncated"], "dropped_tiles": s["dropped_tiles"], "ms": {}}
    for mode in MODES:
        ms = mean_ms(lambda: kernel_ablate(mode, *slab), dev, reps=args.reps)
        out["ms"][mode] = ms
        print(f"{mode:>10}: {ms:9.3f} ms", flush=True)
    with torch.no_grad():
        full = kernel_ablate("full", *slab)
        tile = ct.composite_tile_fwd(*slab, s["num_tiles"], False)[0]
    out["full_vs_tile_fwd_max_abs"] = float((full - tile).abs().max())
    print(f"full vs composite_tile_fwd color: max |Δ| "
          f"{out['full_vs_tile_fwd_max_abs']:.3g}", flush=True)
    return out


if __name__ == "__main__":
    main()
