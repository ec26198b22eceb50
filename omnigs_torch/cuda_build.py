"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/omnigs_torch/<name>-<hash>.so`` at the repository root, with a
plain C interface that the wrappers call through ``ctypes``. The file name
carries a hash of the sources and flags, so a stale library is never
loaded. Builds run at first use, never at import; several sources build in
parallel (one ``nvcc`` each). A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "omnigs_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # separate mul/add as written: the kernels round like their plain
    # PyTorch versions (elementwise ops, no contraction across ops)
    "--fmad=false",
    "-Xptxas", "-v",
)

# name → loaded library; name → {"seconds", "ptxas"} of this process's builds
_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_REPORT: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "omnigs_torch are built from source on the machine with the card"
    )


def library_path(name: str) -> Path:
    """Content-addressed path of the library built from csrc/<name>.cu."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Build every named source whose library is missing, all in parallel."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ),
            tmp,
            out,
        )
    failures = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)
        BUILD_REPORT[name] = {
            "seconds": time.perf_counter() - t0,
            # registers, shared memory, stack and spills per kernel
            "ptxas": [
                line.strip()
                for line in (stdout + stderr).splitlines()
                if "ptxas info" in line or "spill" in line
            ],
        }
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.omnigs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.omnigs_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def launcher(source: str, name: str, argtypes) -> Tuple[ctypes.CDLL, Any]:
    """(library of csrc/<source>.cu, its C function ``omnigs_<name>``) with
    the given ``argtypes`` and an int (CUDA error code) result."""
    lib = load(source)
    fn = getattr(lib, f"omnigs_{name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.omnigs_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
