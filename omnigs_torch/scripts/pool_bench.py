"""Image prefetch: `ImagePool` on the native library's thread pool against a
Python thread pool over `load_image`.

Writes ``--images`` panoramas of ``--src-width`` × ``--src-height`` (smooth
colour fields with noise, from ``--seed``) as PNG and as JPEG, then loads
each list at ``--width`` × ``--height`` on ``--threads`` threads both ways,
in turns (native, python, python, native per repeat), and prints one JSON
line per format: seconds per arm, images/s, and whether every image is
equal between the two. The native arm needs `native/libomnigs_loader.so`
(`sh native/build.sh`); without it the script raises. Host work only: no
device is used.

    python -m omnigs_torch.scripts.pool_bench [--images 32] [--threads 4]
        [--src-width 3840 --src-height 1920] [--width 1920 --height 960]
        [--repeats 3] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from omnigs_torch.io import native_loader


def write_images(out: Path, n: int, width: int, height: int, seed: int) -> dict:
    """``n`` images per format under ``out``: {"png": [...], "jpg": [...]}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    paths = {"png": [], "jpg": []}
    for i in range(n):
        f = rng.uniform(1, 6, 3).astype(np.float32)
        ph = rng.uniform(0, 6.3, 3).astype(np.float32)
        base = np.stack([
            np.sin(xx / width * f[c] * 6.2832 + ph[c]) * np.cos(yy / height * f[c] * 3.1416)
            for c in range(3)
        ], -1)
        noise = rng.normal(0, 12, (height, width, 3)).astype(np.float32)
        rgb = np.clip(127.5 + 100 * base + noise, 0, 255).astype(np.uint8)
        img = Image.fromarray(rgb)
        for fmt, kw in (("png", {}), ("jpg", {"quality": 95})):
            p = out / f"{i:03d}.{fmt}"
            img.save(p, **kw)
            paths[fmt].append(p)
    return paths


def native_arm(paths, width, height, threads):
    pool = native_loader.ImagePool(width, height, n_threads=threads)
    if not pool.native:
        raise RuntimeError(f"the native library {native_loader.SO_PATH} does not load")
    t0 = time.perf_counter()
    got = dict(pool.load_all(paths))
    secs = time.perf_counter() - t0
    pool.close()
    return secs, got


def python_arm(paths, width, height, threads):
    with ThreadPoolExecutor(threads) as ex:
        t0 = time.perf_counter()
        got = dict(enumerate(ex.map(
            lambda p: native_loader.load_image(p, width, height), paths)))
        secs = time.perf_counter() - t0
    return secs, got


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--src-width", type=int, default=3840)
    ap.add_argument("--src-height", type=int, default=1920)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="where the images go (default: a temp dir)")
    args = ap.parse_args(argv)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        paths = write_images(out, args.images, args.src_width, args.src_height, args.seed)
        for fmt, plist in paths.items():
            secs = {"native": [], "python": []}
            equal = True
            for _ in range(args.repeats):
                for arm in ("native", "python", "python", "native"):
                    fn = native_arm if arm == "native" else python_arm
                    s, got = fn(plist, args.width, args.height, args.threads)
                    secs[arm].append(s)
                    if arm == "native":
                        ref = got
                    else:
                        equal = equal and all(np.array_equal(got[i], ref[i]) for i in ref)
            line = {
                "format": fmt, "images": args.images, "threads": args.threads,
                "src": [args.src_width, args.src_height], "out": [args.width, args.height],
                "native_s": secs["native"], "python_s": secs["python"],
                "native_images_per_s": args.images / min(secs["native"]),
                "python_images_per_s": args.images / min(secs["python"]),
                "native_over_python": min(secs["native"]) / min(secs["python"]),
                "equal": equal,
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
    if not all(line["equal"] for line in lines):
        raise RuntimeError("the two pools gave different images")
    return lines


if __name__ == "__main__":
    main()
