"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, ``build/torch_kernels/libvft_scan.so`` at
the repository root, and loaded with ``ctypes``.  The build runs at first use
and again whenever the sources or flags change: a SHA-256 of both is kept
beside the library.  No PyTorch header is compiled, so a build takes seconds.

A missing ``nvcc`` or a failed build raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libvft_scan.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> tuple[Path, str]:
    """Compile the kernels if the library is missing or stale.  Returns the
    library path and nvcc's report (ptxas register and shared-memory use),
    which is empty when the existing library was current."""
    digest = _digest()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH, res.stdout + res.stderr


def _declare(lib) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("vft_scan_dense_blocks", "vft_scan_codes_blocks"):
        fn = getattr(lib, name)
        fn.argtypes = [i64]
        fn.restype = i64
    lib.vft_nj_scan_dense_f64.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i64, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vft_nj_scan_dense_f64.restype = i32
    lib.vft_nj_scan_codes_f64.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, i64, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vft_nj_scan_codes_f64.restype = i32
    lib.vft_me_pair_dists_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr, i32,
        ptr, ptr, ptr]
    lib.vft_me_pair_dists_f32.restype = i32
    lib.vft_me_average_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, i32,
        ctypes.c_float, i32, ctypes.c_float, ptr]
    lib.vft_me_average_f32.restype = i32


def library():
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
    return _lib
