"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Every source under ``csrc/`` is compiled for Hopper (``sm_90a``) by its
own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, inside the checkout
(``thor_slam_tpu_torch/_build/<source hash>/libthor_kernels.so``), and is
reused while the sources and flags are unchanged. Nothing here runs at
import time, so the package imports on hosts without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libthor_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
build_log: str = ""


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME or /usr/local/cuda)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a build of the same sources exists.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept in :data:`build_log`.
    """
    global build_log
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{LIB_NAME}.{os.getpid()}")
    nvcc = _nvcc()
    objs = [out.with_name(f".{src.stem}.{os.getpid()}.o") for src in _sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_sources(), objs)
    ]
    try:
        build_log = "".join(proc.communicate()[0] for proc in procs)
        failed = [src.name for src, proc in zip(_sources(), procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.thor_patches_gather.argtypes = [p, p, ll, ll, p, p, p, p, i, i, i, i, i, i, p]
        lib.thor_patches_gather.restype = i
        lib.thor_fast_nms.argtypes = [p, p, p, i, i, i, f, p]
        lib.thor_fast_nms.restype = i
        lib.thor_sgm_scan.argtypes = [i, ctypes.POINTER(ll), i, f, f, p]
        lib.thor_sgm_scan.restype = i
        lib.thor_sgm_winner_lr.argtypes = [p, i, i, i, p, p, p, p, p, p, p]
        lib.thor_sgm_winner_lr.restype = i
        _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")
