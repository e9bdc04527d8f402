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
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libvft_scan.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source flags: the likelihood kernels, the ML rounds and the
# whole-tree sweep and log-likelihood, the decisions of
# the SPR and NNI rounds, of the join epoch and of the fused join step,
# and the bootstrap columns
# round every float and double expression as written, as their plain twins
# and numpy do (no fused multiply-adds)
SOURCE_FLAGS = {"ml_lk.cu": ["-fmad=false"], "ml_round.cu": ["-fmad=false"],
                "ml_sweep.cu": ["-fmad=false"],
                "me_spr.cu": ["-fmad=false"], "me_nni.cu": ["-fmad=false"],
                "nj_epoch.cu": ["-fmad=false"], "nj_join.cu": ["-fmad=false"],
                "sh_resample.cu": ["-fmad=false"],
                # the -constraints units: a round or the epoch with its
                # constrained kernel alone
                "ml_round_cons.cu": ["-fmad=false"],
                "me_spr_cons.cu": ["-fmad=false"],
                "me_nni_cons.cu": ["-fmad=false"],
                "nj_epoch_cons.cu": ["-fmad=false"]}

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


def build(force: bool = False) -> tuple[Path, str]:
    """Compile the kernels if the library is missing or stale, or always
    with force.  Returns the library path and nvcc's report (ptxas register,
    stack and shared-memory use), which is empty when the existing library
    was current."""
    digest = _digest()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if not force and LIB_PATH.exists() and stamp.exists() and \
            stamp.read_text() == digest:
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


def ptxas_report(log: str) -> dict:
    """{entry function: {"registers", "stack", "spill_stores",
    "spill_loads", "cumulative_stack"}} (bytes but the registers) from
    nvcc's ``-Xptxas -v`` report, as build() returns it: each "Compiling
    entry function" line names the kernel that the "Function properties"
    and "Used ... registers" lines after it describe (the properties of a
    function the kernel calls are not the kernel's, but its frame counts in
    the kernel's cumulative stack)."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "stack": None,
                          "spill_stores": None, "spill_loads": None,
                          "cumulative_stack": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes cumulative stack size", line)
            if m:
                out[entry]["cumulative_stack"] = int(m.group(1))
    return out


def kernel_resources(report: dict, kernel: str, n_codes: int = 4) -> dict:
    """The ptxas_report entry of the kernel template `kernel<n_codes>`
    (found by its mangled name); raises if the report has none or two."""
    tag = f"{kernel}ILi{n_codes}E"
    hits = [v for k, v in report.items() if tag in k]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} entries of {kernel}<{n_codes}> in the "
                       "ptxas report")
    return hits[0]


# the most stack (bytes) each kernel template (C=4) may keep, and no spill
# stores where the limit is 0: the ML and ME round kernels hold their state
# in registers; the quartet kernel keeps its 32 bytes, the join epoch its
# deciding warp's 616-byte frame (the master object; no spills)
STACK_LIMITS = {"ml_nni_round_kernel": 0, "ml_lengths_pass_kernel": 0,
                "ml_quartet_opt_kernel": 32, "nj_epoch_kernel": 616,
                "me_spr_round_kernel": 0, "me_nni_round_kernel": 0,
                # the -constraints instantiations, at what their builds
                # reach: the penalties' pairwise sum keeps its explicit
                # stack (csrc/constraints.cuh np_sum, 312 bytes) in local
                # memory, and the ME rounds spill beside it (80 and 204
                # bytes of spill stores); the epoch's master carries the
                # counts' 48 bytes
                "nj_epoch_cons_kernel": 664, "me_spr_round_cons_kernel": 432,
                "me_nni_round_cons_kernel": 352,
                "ml_nni_round_cons_kernel": 320,
                # the fused join step: no stack, no spills (72 registers)
                "nj_join_step_kernel": 0}
# the same for the ML kernels' 20-code templates (protein ML), at what the
# builds reach: the NNI round, its walk on a block of its own and each
# optimization over a group of blocks, keeps an 8-byte frame at 255
# registers (8 bytes of spill stores: the quartet bodies' Part state beside
# the posteriors' rotations); the pass and the quartet kernel none
STACK_LIMITS_20 = {"ml_nni_round_kernel": 8, "ml_lengths_pass_kernel": 0,
                   "ml_quartet_opt_kernel": 0,
                   # -constraints: np_sum's stack, 16 bytes of spills
                   "ml_nni_round_cons_kernel": 336,
                   "nj_join_step_kernel": 0}


def resource_faults(report: dict, limits: dict = STACK_LIMITS,
                    n_codes: int = 4) -> list:
    """What ptxas_report says against `limits` for the kernel templates
    <n_codes>: one line for each kernel missing from the report, reporting
    more stack (its own frame or with the functions it calls) than its
    limit, or any spill store where its limit is 0."""
    out = []
    for kernel, limit in limits.items():
        try:
            res = kernel_resources(report, kernel, n_codes)
        except KeyError as err:
            out.append(err.args[0])
            continue
        stack = None if res["stack"] is None else max(
            res["stack"], res["cumulative_stack"])
        if stack is None or stack > limit:
            out.append(f"{kernel}<{n_codes}>: {stack} bytes of stack frame "
                       f"(at most {limit})")
        if limit == 0 and res["spill_stores"]:
            out.append(f"{kernel}<{n_codes}>: {res['spill_stores']} bytes of "
                       "spill stores")
    return out


def _declare(lib) -> None:
    ptr, i64, i32, f32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_float, ctypes.c_double)
    lib.vft_scan_dense_blocks.argtypes = [i64]
    lib.vft_scan_dense_blocks.restype = i64
    lib.vft_scan_codes_blocks.argtypes = [i64, i32, i32]
    lib.vft_scan_codes_blocks.restype = i64
    lib.vft_nj_scan_dense_f64.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i64, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vft_nj_scan_codes_f64.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, i64, i32, i64,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vft_nj_scan_dense_partial_f64.argtypes = [
        ptr, ptr, ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
    lib.vft_nj_scan_codes_partial_f64.argtypes = [
        ptr, ptr, ptr, i64, i32, i32, i64, ptr, ptr, ptr]
    lib.vft_scan_finish_blocks.argtypes = [i64]
    lib.vft_scan_finish_blocks.restype = i64
    lib.vft_nj_scan_finish_f64.argtypes = [
        ptr, i32, ptr, i64, i64, i64, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr]
    lib.vft_me_pair_dists_partial_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr, i32, i32,
        ptr, ptr, ptr]
    lib.vft_me_pair_list_partial_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i32, i32, ptr, ptr, i64, i32, ptr, ptr]
    lib.vft_me_pair_finish_f64.argtypes = [ptr, i32, i64, i32, ptr, ptr]
    lib.vft_me_pair_dists_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr, i32,
        ptr, ptr, ptr]
    lib.vft_me_average_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, i32,
        f32, i32, f32, ptr]
    lib.vft_me_pair_list_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i32, i32, ptr, ptr, i64, ptr, ptr]
    lib.vft_me_pieces_list_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr, ptr, i64, ptr, ptr, ptr]
    lib.vft_me_average_sweep_units.argtypes = [i64, i32]
    lib.vft_me_average_sweep_units.restype = i64
    lib.vft_me_average_sweep_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i32, i32, ptr, ptr, i64, f32, ptr, i64, i32,
        ptr]
    # the store, model, tree and options, first in each round entry
    # (ops/me_round.entry_args)
    me_round = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, f32, i32,
                i32, i32, i32, i32, i32, f64]
    lib.vft_me_spr_round_f32.argtypes = me_round + [
        i32, ptr, i32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.vft_me_nni_round_f32.argtypes = me_round + [
        i32, f64, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr]
    # the constrained rounds take the counts (ops/me_round.Counts) before
    # the stream
    cons = [ptr, ptr, i32, f64]
    lib.vft_me_spr_round_cons_f32.argtypes = \
        lib.vft_me_spr_round_f32.argtypes[:-1] + cons + [ptr]
    lib.vft_me_nni_round_cons_f32.argtypes = \
        lib.vft_me_nni_round_f32.argtypes[:-1] + cons + [ptr]
    # the join epoch takes its parameters as one struct
    # (ops/epoch_kernels.EpochParams)
    lib.vft_nj_epoch_f32.argtypes = [ptr, i32, ptr, ptr]
    # and under -constraints the counts as a second struct
    # (ops/epoch_kernels.ConParams; NULL: none)
    lib.vft_nj_epoch_cons_f32.argtypes = [ptr, ptr, i32, ptr, ptr]
    lib.vft_nj_epoch_scratch.argtypes = [i64, i64, i64, ptr]
    lib.vft_nj_epoch_scratch.restype = None
    # the fused join step: its parameters as one struct
    # (ops/join_kernels.JoinParams), the staged inputs
    lib.vft_nj_join_step_f32.argtypes = [ptr, ptr, i64, ptr, ptr, ptr]
    # the ML store's arguments, first in each ML entry (csrc/ml_lk.cu)
    ml_store = [ptr] * 9 + [i64, i32, i32, i32, i32, i32, f32, ptr, ptr, i32,
                            ptr]
    lib.vft_ml_pair_loglk_f32.argtypes = ml_store + [ptr, ptr, i64, ptr, ptr,
                                                     ptr, ptr]
    lib.vft_ml_posterior_f32.argtypes = ml_store + [f32, ptr, ptr, i64, ptr,
                                                    ptr, i64, f32, ptr]
    lib.vft_ml_opt_branch_f32.argtypes = ml_store + [
        ptr, ptr, i64, ptr, ptr, i64, f32, f32, f32, f32, ptr, ptr, ptr, ptr,
        ptr]
    lib.vft_ml_opt_branch_fits_smem.argtypes = [i32, i32]
    lib.vft_ml_quartet_opt_f32.argtypes = ml_store + [
        f32, ptr, ptr, i64, ptr, f32, f32, f32, f32, i32, ptr, ptr, ptr, ptr]
    lib.vft_ml_quartet_scratch_floats.argtypes = [i32, i32]
    lib.vft_ml_quartet_scratch_floats.restype = i64
    # the whole-tree kernels' scheduler (csrc/dataflow.cuh) and the ML
    # sweep and tree log-likelihood (csrc/ml_sweep.cu)
    lib.vft_dataflow_ctrl_words.argtypes = []
    lib.vft_ml_posterior_sweep_grid.argtypes = [i32]
    lib.vft_ml_posterior_sweep_units.argtypes = [i64, i32, i32]
    lib.vft_ml_posterior_sweep_units.restype = i64
    lib.vft_ml_posterior_sweep_flags.argtypes = [i64, i32, i32]
    lib.vft_ml_posterior_sweep_flags.restype = i64
    lib.vft_ml_tree_loglk_units.argtypes = [i64, i32, i32, i32, i32, i32]
    lib.vft_ml_tree_loglk_units.restype = i64
    lib.vft_ml_tree_loglk_group_rows.argtypes = []
    lib.vft_ml_tree_loglk_scratch_bytes.argtypes = [i64, i32, i32, i32, i32,
                                                    i32]
    lib.vft_ml_tree_loglk_scratch_bytes.restype = i64
    lib.vft_ml_posterior_sweep_f32.argtypes = ml_store + [
        f32, ptr, ptr, i64, ptr, i64, i64, ptr, i64, i32, ptr]
    lib.vft_ml_tree_loglk_f32.argtypes = ml_store + [
        f32, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, f32, f32,
        f32, i32, ptr, ptr, ptr, i64, ptr, i64, i32, ptr]
    # the ML store, the model's tolerance and the line searches' limits,
    # first in each ML round entry (ops/ml_round.py)
    ml_round = ml_store + [f32, f32, f32, f32, f32, f64]
    lib.vft_ml_nni_round_f32.argtypes = ml_round + [
        i32, i32, i32, i32, i32, f64, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.vft_ml_nni_round_cons_f32.argtypes = \
        lib.vft_ml_nni_round_f32.argtypes[:-1] + cons + [ptr]
    lib.vft_ml_lengths_pass_f32.argtypes = ml_round + [
        i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.vft_ml_round_tree_fits_smem.argtypes = [i32, i32, i32]
    lib.vft_ml_round_scratch_floats.argtypes = [i32, i32, i32, i32, i32]
    lib.vft_ml_round_scratch_floats.restype = i64
    lib.vft_ml_round_layout.argtypes = [i32, i32, i32, i32, i32, i32, ptr]
    lib.vft_sh_resample_counts.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                           i32, ptr, ptr]
    for name in ("vft_nj_scan_dense_f64", "vft_nj_scan_codes_f64",
                 "vft_nj_scan_dense_partial_f64",
                 "vft_nj_scan_codes_partial_f64", "vft_nj_scan_finish_f64",
                 "vft_me_pair_dists_partial_f32",
                 "vft_me_pair_list_partial_f32", "vft_me_pair_finish_f64",
                 "vft_me_pair_dists_f32", "vft_me_average_f32",
                 "vft_me_spr_round_f32", "vft_me_nni_round_f32",
                 "vft_me_spr_round_cons_f32", "vft_me_nni_round_cons_f32",
                 "vft_ml_pair_loglk_f32", "vft_ml_posterior_f32",
                 "vft_ml_opt_branch_f32", "vft_ml_opt_branch_fits_smem",
                 "vft_ml_quartet_opt_f32", "vft_ml_nni_round_f32",
                 "vft_ml_nni_round_cons_f32",
                 "vft_ml_lengths_pass_f32", "vft_ml_round_tree_fits_smem",
                 "vft_ml_round_layout",
                 "vft_nj_epoch_f32", "vft_nj_epoch_cons_f32",
                 "vft_nj_join_step_f32",
                 "vft_sh_resample_counts",
                 "vft_dataflow_ctrl_words", "vft_ml_posterior_sweep_grid",
                 "vft_ml_tree_loglk_group_rows",
                 "vft_ml_posterior_sweep_f32",
                 "vft_ml_tree_loglk_f32"):
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
