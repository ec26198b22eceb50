"""Image loading for datasets: decode, then the native loader's resize.

Counterpart of `load_image` in `omnigs_tpu/io/native_loader.py`. A PNG
decodes through PIL (lossless, so to the bytes libpng gives); any other
format goes through a ctypes binding of the repository's C++ loader
(`native/libomnigs_loader.so`, built by `native/build.sh`), and raises when
that library does not load — no other decoder is tried, since lossy
decoders differ in their output. Both give the native loader's arithmetic:
a point-sampled bilinear resize in float32 scaled by ``* (1.0f / 255.0f)``
(`native/loader.cpp:153-180`), not PIL's resize or ``/ 255``, so a PNG
loads bit for bit as the JAX package loads it through that library.
`ImagePool` prefetches a list of images on the native library's thread
pool (``loader_create`` / ``loader_submit`` / ``loader_fetch`` /
``loader_destroy``, as the JAX package binds them); a file the library
fails to decode is loaded by `load_image`, and where the library does not
load the pool is a Python thread pool over `load_image`. The images are
the same either way.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple

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
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_submit.restype = None
    lib.loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.loader_fetch.restype = ctypes.c_int
    lib.loader_fetch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
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


class ImagePool:
    """Prefetching image loader on ``n_threads`` threads: the native
    library's pool where it loads, else a Python thread pool over
    `load_image`."""

    def __init__(self, width: int, height: int, n_threads: int = 4):
        self.width = width
        self.height = height
        self._lib = _load_native()
        self._handle = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if self._lib is not None:
            self._handle = self._lib.loader_create(n_threads, width, height)
        else:
            self._pool = ThreadPoolExecutor(n_threads)

    @property
    def native(self) -> bool:
        """Whether the native library's pool decodes."""
        return self._handle is not None

    def load_all(self, paths: Iterable) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (index, image) for every path, in completion order."""
        paths = list(paths)
        if self._handle is None and self._pool is None:
            raise RuntimeError("ImagePool is closed")
        if self._handle is None:
            futures = {
                self._pool.submit(load_image, p, self.width, self.height): i
                for i, p in enumerate(paths)
            }
            for fut in as_completed(futures):
                yield futures[fut], fut.result()
            return
        for i, p in enumerate(paths):
            self._lib.loader_submit(self._handle, str(p).encode(), i)
        out = np.empty((self.height, self.width, 3), np.float32)
        for _ in paths:
            rc = self._lib.loader_fetch(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            if rc < 0:
                # the library could not decode it: the file's own path
                idx = -1 - rc
                yield idx, load_image(paths[idx], self.width, self.height)
            else:
                yield rc, out.copy()

    def close(self):
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        self.close()
