"""Image loading for datasets: decode, then the native loader's resize.

Counterpart of `load_image` in `omnigs_tpu/io/native_loader.py`. A PNG
decodes through PIL (lossless, so to the bytes libpng gives); any other
format goes through a ctypes binding of the repository's C++ loader
(`native/libomnigs_loader.so`, built by `native/build.sh`), and raises when
that library does not load — no other decoder is tried, since lossy
decoders differ in their output. Both give the native loader's arithmetic:
a point-sampled bilinear resize in float32 scaled by ``* (1.0f / 255.0f)``
(`native/loader.cpp:153-180`), not PIL's resize or ``/ 255``, so a PNG
loads bit for bit as the JAX package loads it through that library. The
prefetching pool (`ImagePool`) is not ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

SO_PATH = Path(__file__).resolve().parents[2] / "native" / "libomnigs_loader.so"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the native loader's scale, 1.0f / 255.0f in float32
INV_255 = np.float32(1.0) / np.float32(255.0)


def _load_native() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(SO_PATH))
    except OSError:
        return None
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def resize_to_float(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """(h, w, 3) uint8 → (height, width, 3) float32 in [0, 1]: the native
    loader's `resize_to_float`, operation for operation in float32."""
    f32 = np.float32
    sh, sw = src.shape[:2]
    sx = f32(sw) / f32(width)
    sy = f32(sh) / f32(height)

    def taps(n_out, n_src, s):
        f = (np.arange(n_out, dtype=f32) + f32(0.5)) * s - f32(0.5)
        i0 = np.where(f < 0, 0, f.astype(np.int64))
        i1 = np.where(i0 + 1 < n_src, i0 + 1, n_src - 1)
        wt = np.maximum(f - i0.astype(f32), f32(0))
        return i0, i1, wt

    x0, x1, wx = taps(width, sw, sx)
    y0, y1, wy = taps(height, sh, sy)
    img = src.astype(f32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top, bot = img[y0], img[y1]
    a = top[:, x0] * (f32(1) - wx) + top[:, x1] * wx
    b = bot[:, x0] * (f32(1) - wx) + bot[:, x1] * wx
    return (a * (f32(1) - wy) + b * wy) * INV_255


def load_image(path, width: int, height: int) -> np.ndarray:
    """Decode + resize one image to (height, width, 3) float32 in [0, 1]."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_SIGNATURE
    if is_png:
        from PIL import Image

        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
        return resize_to_float(rgb, width, height)
    lib = _load_native()
    if lib is None:
        raise RuntimeError(
            f"{path}: not a PNG, and the native image loader {SO_PATH} does not "
            "load (build it with `sh native/build.sh`)"
        )
    out = np.empty((height, width, 3), np.float32)
    rc = lib.decode_image(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        width,
        height,
    )
    if rc != 0:
        raise RuntimeError(f"{path}: the native image loader could not decode it")
    return out
