"""Training losses and image metrics.

Counterpart of `omnigs_tpu/ops/loss.py`: L1, two PSNR variants and SSIM
with an 11×11 σ = 1.5 Gaussian window over (C, H, W) float32 images
(float64 ones for a reference step), zero-padded at the border.

* `ssim` adapts to its input. A CUDA float32 pair with the 11-tap window
  goes through `_SSIM`, a `torch.autograd.Function` over the hand-written
  kernels of `csrc/ssim.cu`: `ssim_fwd` (the separable window as a stencil,
  the map or the mean, and the map's partials when the input needs a
  gradient) and `ssim_bwd`, each counting its launches
  (`utils.profiling.count_launch`).
  Any other input (the CPU, float64, another window) runs `ssim_plain`,
  the same Function over the plain versions, which repeat the kernels'
  operations in their order (`_conv_plain`: the shifted slices times the
  taps summed in tap order, horizontal over the rows with their halo, then
  vertical; `_ssim_terms`; the
  mean's fixed tree, `_map_sum`), so the kernels equal them bit for bit.
  The JAX package runs the window as banded matrix products (B_v · img ·
  B_h), which on the card were dense float32 GEMMs over ~99% zeros.
* `ssim_rows` gives a row block of the SSIM map from the block and its
  window halo alone, the piece each rank of the sharded loss computes
  (`parallel/shard.py`), through the same Function and dispatch: the
  kernels take a first row and a row count, so a block's rows equal the
  whole map's bit for bit, and its backward writes the rows its window
  reaches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from omnigs_torch import cuda_build
from omnigs_torch.utils import profiling


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean-over-pixels PSNR."""
    mse = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10(1.0 / mse)


def psnr_gaussian_splatting(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """3DGS-style PSNR: per-channel MSE, then the mean of the per-channel
    20·log10(1/√mse)."""
    mse = torch.mean((img1 - img2) ** 2, dim=(-2, -1))
    return torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(mse)))


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _taps(window_size: int) -> List[float]:
    return [float(v) for v in _gaussian_1d(window_size, 1.5)]


C1 = 0.01**2
C2 = 0.03**2
WINDOW = 11  # the kernels' window
HALO = WINDOW // 2
# the kernels' tiling (csrc/ssim.cu): a block's TH × TW tile of one channel,
# NTY warps of TW lanes, RPT consecutive rows a thread; the slots' sum in
# SUM_THREADS threads
TW, NTY, RPT = 32, 8, 4
TH = NTY * RPT
WARP = 32
SUM_THREADS = 1024


def _conv_plain(x: torch.Tensor, taps: List[float]) -> torch.Tensor:
    """(..., R + w − 1, W) ⊛ the separable w-tap window → (..., R, W), as the
    kernels run it: the horizontal pass SAME (zero columns), then the
    vertical pass VALID over rows that hold the (w − 1)-row halo; each pass
    sums the shifted slices times the taps in tap order."""
    h = len(taps) // 2
    w = x.shape[-1]
    xp = F.pad(x, (h, h))
    acc = xp[..., 0:w] * taps[0]
    for k in range(1, len(taps)):
        acc += xp[..., k : k + w] * taps[k]
    n = acc.shape[-2] - 2 * h
    out = acc[..., 0:n, :] * taps[0]
    for k in range(1, len(taps)):
        out += acc[..., k : k + n, :] * taps[k]
    return out


def _halo_rows(img: torch.Tensor, row0: int, nrows: int, h: int) -> torch.Tensor:
    """Image rows [row0 − h, row0 + nrows + h) of (C, H, W) ``img``, zero
    outside the image (the SAME padding)."""
    H = img.shape[-2]
    p = F.pad(img, (0, 0, h, max(row0 + nrows + h - H, 0)))
    return p[..., row0 : row0 + nrows + 2 * h, :]


def _ssim_terms(mu1, mu2, e11, e22, e12, partials: bool):
    """The SSIM map from the windowed moments and, with ``partials``, its
    partials (dS/dμ₁ with the −2μ₁ term of σ₁² = E[x²] − μ₁² and the −μ₂
    term of σ₁₂ = E[xy] − μ₁μ₂ in place, dS/dσ₁², dS/dσ₁₂), in the
    kernels' operation order."""
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq, sigma2_sq, sigma12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu1_mu2
    a1 = 2 * mu1_mu2 + C1
    a2 = 2 * sigma12 + C2
    b1 = mu1_sq + mu2_sq + C1
    b2 = sigma1_sq + sigma2_sq + C2
    den = b1 * b2
    s = a1 * a2 / den
    if not partials:
        return s, None
    d_s = -s / b2
    d_c = 2 * a1 / den
    d_m = 2 * mu2 * a2 / den - 2 * mu1 * s / b1
    return s, (d_m - 2 * mu1 * d_s - mu2 * d_c, d_s, d_c)


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """(..., 32) → (...): the kernels' butterfly over a warp's lanes (halves
    at 16, 8, 4, 2, 1, lane i plus lane i + half)."""
    half = v.shape[-1] // 2
    while half:
        v = v[..., :half] + v[..., half : 2 * half]
        half //= 2
    return v[..., 0]


def _slot_sum(slots: torch.Tensor) -> torch.Tensor:
    """The sum of the tiles' slots as `ssim_sum_kernel` takes it: thread t
    adds slots t, t + 1024, ... from 0, then the warp tree, then the 32 warp
    sums left to right."""
    n = slots.shape[0]
    v = F.pad(slots, (0, -n % SUM_THREADS)).reshape(-1, SUM_THREADS)
    acc = torch.zeros(SUM_THREADS, dtype=slots.dtype, device=slots.device)
    for row in v:
        acc = acc + row
    t = _warp_tree(acc.reshape(SUM_THREADS // WARP, WARP))
    total = t[0]
    for k in range(1, t.shape[0]):
        total = total + t[k]
    return total


def _map_sum(s: torch.Tensor) -> torch.Tensor:
    """The sum of a (C, H, W) map as the forward kernel and the slots' sum
    take it: a tile's thread adds its RPT rows in order, a warp its lanes in
    the warp tree, the block its NTY warps left to right, one slot a tile
    in (channel, tile row, tile column) order; pixels off the image add 0."""
    c, h, w = s.shape
    nby, nbx = -(-h // TH), -(-w // TW)
    v = F.pad(s, (0, nbx * TW - w, 0, nby * TH - h)).reshape(c, nby, NTY, RPT, nbx, TW)
    t = v[:, :, :, 0]
    for i in range(1, RPT):
        t = t + v[:, :, :, i]
    t = _warp_tree(t)  # (c, nby, NTY, nbx)
    b = t[:, :, 0]
    for k in range(1, NTY):
        b = b + t[:, :, k]
    return _slot_sum(b.reshape(-1))


def _count(img: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(img.numel()), dtype=img.dtype, device=img.device)


def _ssim_fwd_plain(img1, img2, size_average, want_partials, window_size, row0, nrows):
    h = window_size // 2
    a, b = (_halo_rows(x, row0, nrows, h) for x in (img1, img2))
    m = _conv_plain(torch.stack([a, b, a * a, b * b, a * b]), _taps(window_size))
    s, partials = _ssim_terms(*m, want_partials)
    return (_map_sum(s) / _count(s) if size_average else s), partials


def _ssim_bwd_plain(img1, img2, partials, grad, size_average, window_size, row0):
    """dSSIM/d``img1`` (C, H, W) from the partials of the map's rows from
    ``row0`` on: G·partials in their image rows, zero elsewhere, through the
    window (its own adjoint)."""
    g = grad / _count(partials[0]) if size_average else grad
    gp = torch.stack([p * g for p in partials])
    c, H, w = img1.shape
    h = window_size // 2
    n = max(min(gp.shape[-2], H - row0), 0)  # the block's rows inside the image
    z = gp.new_zeros(3, c, H + 2 * h, w)
    z[..., h + row0 : h + row0 + n, :] = gp[..., :n, :]
    cm, cs, cc = _conv_plain(z, _taps(window_size))
    return cm + 2 * img1 * cs + img2 * cc


_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLP, _FP = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float)
# omnigs_ssim_fwd(x, xs, y, ys, C, H, W, row0, R, taps, c1, c2, map, dmu, dsig,
#                 dcov, slots, out, device, stream)
_FWD_ARGTYPES = [
    _VP, _LLP, _VP, _LLP, _I32, _I32, _I32, _I32, _I32, _FP, _F32, _F32, _VP, _VP,
    _VP, _VP, _VP, _VP, _I32, _VP,
]
# omnigs_ssim_bwd(x, xs, y, ys, C, H, W, row0, R, d0, D, taps, dmu, dsig, dcov,
#                 g, gs, gdiv, dx, device, stream)
_BWD_ARGTYPES = [
    _VP, _LLP, _VP, _LLP, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _FP, _VP, _VP,
    _VP, _VP, _LLP, _F32, _VP, _I32, _VP,
]


def _kernel_takes(img1: torch.Tensor, img2: torch.Tensor, window_size: int) -> bool:
    return (
        window_size == WINDOW
        and img1.device.type == "cuda"
        and img2.device == img1.device
        and img1.dtype == img2.dtype == torch.float32
        and img1.ndim == 3
        and img1.shape == img2.shape
    )


def _check_images(img1, img2):
    if not _kernel_takes(img1, img2, WINDOW):
        raise ValueError(
            "the SSIM kernels take two CUDA float32 (C, H, W) images of one shape, got "
            f"{tuple(img1.shape)} {img1.dtype} {img1.device} and "
            f"{tuple(img2.shape)} {img2.dtype} {img2.device}"
        )


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride())


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ssim_fwd(img1, img2, size_average: bool, want_partials: bool, row0: int = 0,
             nrows: Optional[int] = None):
    """The forward kernel (`csrc/ssim.cu`) on two CUDA float32 (C, H, W)
    images, read through their strides → (the mean () or the map's rows
    [row0, row0 + nrows) (C, nrows, W), all of them by default; the three
    partial maps of those rows or None). The mean, of the whole image only,
    is taken by a second kernel over the tiles' slots, behind the same
    launch."""
    _check_images(img1, img2)
    c, h, w = img1.shape
    r = h if nrows is None else nrows
    if size_average and (row0, r) != (0, h):
        raise ValueError("the SSIM's mean is taken over the whole image")
    dev = img1.device

    def new(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    smap = None if size_average else new(c, r, w)
    partials = (new(c, r, w), new(c, r, w), new(c, r, w)) if want_partials else None
    slots = new(c * -(-r // TH) * -(-w // TW)) if size_average else None
    mean = new(()) if size_average else None
    lib, fn = cuda_build.launcher("ssim", "ssim_fwd", _FWD_ARGTYPES)
    err = fn(
        img1.data_ptr(), _strides(img1), img2.data_ptr(), _strides(img2), c, h, w, row0, r,
        (ctypes.c_float * WINDOW)(*_taps(WINDOW)), C1, C2, _ptr(smap),
        *(_ptr(p) for p in partials or (None,) * 3), _ptr(slots), _ptr(mean), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "ssim_fwd launch")
    profiling.count_launch("ssim_fwd")
    return (mean if size_average else smap), partials



def ssim_bwd(img1, img2, partials, grad, size_average: bool, row0: int = 0) -> torch.Tensor:
    """The backward kernel: dSSIM/d``img1`` (contiguous (C, H, W)) from the
    forward's partials of the map's rows from ``row0`` on (C, R, W) and
    ``grad``, the mean's () gradient or those rows' (C, R, W) one (any
    strides); zero on the rows the block's window does not reach."""
    _check_images(img1, img2)
    c, h, w = img1.shape
    r = partials[0].shape[1]
    dev = img1.device
    for p in partials:
        if p.shape != (c, r, w) or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("the SSIM partials must be contiguous float32 (C, R, W)")
    want = () if size_average else (c, r, w)
    if grad.shape != want or grad.dtype != torch.float32 or grad.device != dev:
        raise ValueError(f"the SSIM's gradient must be float32 {tuple(want)} on {dev}")
    # the mean's gradient reaches every pixel over the pixel count
    g_strides, gdiv = ((0, 0, 0), float(c * r * w)) if size_average else (grad.stride(), 1.0)
    d0, d1 = max(row0 - HALO, 0), min(row0 + r + HALO, h)
    dx = (torch.empty if (d0, d1) == (0, h) else torch.zeros)(
        c, h, w, dtype=torch.float32, device=dev
    )
    lib, fn = cuda_build.launcher("ssim", "ssim_bwd", _BWD_ARGTYPES)
    err = fn(
        img1.data_ptr(), _strides(img1), img2.data_ptr(), _strides(img2), c, h, w, row0, r,
        d0, d1 - d0, (ctypes.c_float * WINDOW)(*_taps(WINDOW)),
        *(p.data_ptr() for p in partials), grad.data_ptr(), (ctypes.c_longlong * 3)(*g_strides),
        gdiv, dx.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "ssim_bwd launch")
    profiling.count_launch("ssim_bwd")
    return dx



class _SSIM(torch.autograd.Function):
    """SSIM (the mean, or the map's rows from ``row0`` on) with its backward
    in ``img1``: the kernels, or (``plain``) their plain versions."""

    @staticmethod
    def forward(ctx, img1, img2, size_average, want_grad, plain, window_size, row0, nrows):
        if plain:
            out, partials = _ssim_fwd_plain(
                img1, img2, size_average, want_grad, window_size, row0, nrows
            )
        else:
            out, partials = ssim_fwd(img1, img2, size_average, want_grad, row0, nrows)
        if want_grad:
            ctx.save_for_backward(img1, img2, *partials)
        ctx.meta = (size_average, plain, window_size, row0)
        return out

    @staticmethod
    def backward(ctx, grad):
        img1, img2, *partials = ctx.saved_tensors
        size_average, plain, window_size, row0 = ctx.meta
        if plain:
            d = _ssim_bwd_plain(img1, img2, partials, grad, size_average, window_size, row0)
        else:
            d = ssim_bwd(img1, img2, partials, grad, size_average, row0)
        return (d,) + (None,) * 7


def _apply(img1, img2, window_size, size_average, plain, row0=0, nrows=None):
    grad_on = torch.is_grad_enabled()
    if grad_on and img2.requires_grad:
        raise ValueError("ssim is differentiable in its first image (the prediction) only")
    nrows = img1.shape[-2] if nrows is None else nrows
    want_grad = grad_on and img1.requires_grad
    return _SSIM.apply(img1, img2, size_average, want_grad, plain, window_size, row0, nrows)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM of two (C, H, W) images (zero-padded border): the mean, or the
    map with ``size_average=False``; differentiable in ``img1``. A CUDA
    float32 pair with the 11-tap window runs the kernels; any other input
    `ssim_plain`."""
    plain = not _kernel_takes(img1, img2, window_size)
    return _apply(img1, img2, window_size, size_average, plain)


def ssim_plain(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    size_average: bool = True,
) -> torch.Tensor:
    """`ssim` through the plain versions of the kernels, on any device and
    dtype: the same operations in the same order."""
    return _apply(img1, img2, window_size, size_average, True)


def ssim_rows(
    img1: torch.Tensor,
    img2: torch.Tensor,
    row0: int,
    nrows: int,
    total_rows: int,
    window_size: int = 11,
) -> torch.Tensor:
    """Rows [row0, row0 + nrows) of the SAME-padded `ssim` map of two
    (C, H, W) images, from the rows of that block and its (window − 1)-row
    halo only → (C, nrows, W), bit for bit the whole map's rows;
    differentiable in ``img1``, whose gradient reaches the block's rows and
    halo. Rows at or past ``total_rows`` (the last block of a ceil split)
    come from the zero padding: the caller masks them. Dispatched as
    `ssim`: the kernels, or `ssim_plain`'s versions."""
    if img1.shape[-2] != total_rows:
        raise ValueError(f"image has {img1.shape[-2]} rows, total_rows is {total_rows}")
    plain = not _kernel_takes(img1, img2, window_size)
    return _apply(img1, img2, window_size, False, plain, row0, nrows)


def training_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    lambda_dssim: float = 0.2,
) -> torch.Tensor:
    """(1-λ)·L1 + λ·(1−SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt)
    )
