"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper (``sm_90a``),
all of them at once, and the objects are linked into one shared library with
a plain C interface, ``build/torch_kernels/libvft_scan.so`` at the
repository root, loaded with ``ctypes``.  The build runs at first use and
again whenever the sources or flags change: a SHA-256 of both is kept beside
the library.  No PyTorch header is compiled, so a build takes seconds.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source flags: the likelihood kernels round every float expression as
# written, as their plain twins do (no fused multiply-adds)
SOURCE_FLAGS = {"ml_lk.cu": ["-fmad=false"]}

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
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _run_all(cmds):
    """Run the commands at once; raise on the first that failed.  Returns
    their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile the kernels if the library is missing or stale.  Returns the
    library path and nvcc's report (ptxas register and shared-memory use),
    which is empty when the existing library was current."""
    digest = _digest()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.name, []), "-c",
                     "-o", str(o), str(s)] for s, o in zip(srcs, objs)])
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}.tmp")
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH, log


def _declare(lib) -> None:
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    for name in ("vft_scan_dense_blocks", "vft_scan_codes_blocks"):
        fn = getattr(lib, name)
        fn.argtypes = [i64]
        fn.restype = i64
    lib.vft_nj_scan_dense_f64.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i64, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vft_nj_scan_codes_f64.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, i64, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vft_me_pair_dists_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr, i32,
        ptr, ptr, ptr]
    lib.vft_me_average_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, i32,
        f32, i32, f32, ptr]
    # the ML store's arguments, first in each ML entry (csrc/ml_lk.cu)
    ml_store = [ptr] * 9 + [i64, i32, i32, i32, i32, i32, f32]
    lib.vft_ml_pair_loglk_f32.argtypes = ml_store + [ptr, ptr, i32, ptr, ptr,
                                                     ptr]
    lib.vft_ml_posterior_f32.argtypes = ml_store + [f32, ptr, ptr, i32, ptr]
    lib.vft_ml_opt_branch_f32.argtypes = ml_store + [
        ptr, ptr, i32, f32, f32, f32, f32, ptr, ptr, ptr, ptr, ptr]
    lib.vft_ml_opt_branch_fits_smem.argtypes = [i32, i32]
    lib.vft_ml_quartet_opt_f32.argtypes = ml_store + [
        f32, ptr, ptr, i32, f32, f32, f32, f32, i32, ptr, ptr, ptr, ptr]
    lib.vft_ml_quartet_scratch_floats.argtypes = [i32, i32]
    lib.vft_ml_quartet_scratch_floats.restype = i64
    for name in ("vft_nj_scan_dense_f64", "vft_nj_scan_codes_f64",
                 "vft_me_pair_dists_f32", "vft_me_average_f32",
                 "vft_ml_pair_loglk_f32", "vft_ml_posterior_f32",
                 "vft_ml_opt_branch_f32", "vft_ml_opt_branch_fits_smem",
                 "vft_ml_quartet_opt_f32"):
        getattr(lib, name).restype = i32


def library():
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
    return _lib
