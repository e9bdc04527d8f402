#!/usr/bin/env python3
"""Where the ML round kernels spend their cycles: one ML lengths pass and
one ML NNI round at N=2000 (chip_smoke.py phase 2e's N=MAIN_N start), on
one or more checkouts, each in a process of its own.

    python scripts/profile_ml_round.py [ROOT ...]

Each ROOT (default ".") gets a second copy of its csrc/ml_round.cu built
with -DVFT_ML_ROUND_PROFILE into ROOT/build/ml_round_profile/ (the library
the port loads never has that define).  With it, the first thread of each
group of 256 threads adds the clock64() cycles between its probes
(csrc/ml_lk.cuh, ProfPhase) to the phase it was in: rate tables, site
sums, reductions, the scalar Brent and bracket control, effective-vector
staging, quartet posteriors, the walk with setup_abcd and the node
posteriors, and waiting for the other group or blocks.  The round and the
pass run through the ROOT's own wrappers (ops/ml_round.py) with the
profiled library in place of the round entries; the start comes from this
checkout's chip_smoke.ml_start.  Each child prints one line "PROFILE
{json}"; the script then prints each group's shares side by side.  The
probes cost cycles of their own: compare the shares, and take the kernels'
times from chip_smoke.py or scripts/compare_torch_port.py.

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# csrc/ml_lk.cuh ProfPhase, in its order
PHASES = ("tables", "site sums", "reductions", "control", "staging",
          "quartet posteriors", "walk", "waiting")
N_SLOTS = 8                     # kProfSlots: block * 2 + group

CHILD = r"""
import ctypes, json, os, subprocess, sys, time
root, smoke_path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
import importlib.util
spec = importlib.util.spec_from_file_location("smoke", smoke_path)
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import torch
from veryfasttree_tpu_torch.engine import rearrange
from veryfasttree_tpu_torch.ops import _build, ml_round

main = _build.library()
out_dir = os.path.join(root, "build", "ml_round_profile")
os.makedirs(out_dir, exist_ok=True)
lib_path = os.path.join(out_dir, "libvft_ml_round_profile.so")
subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                *_build.SOURCE_FLAGS.get("ml_round.cu", []),
                "-DVFT_ML_ROUND_PROFILE", "-shared", "-o", lib_path,
                str(_build.SRC_DIR / "ml_round.cu")],
               check=True, capture_output=True, text=True)
prof = ctypes.CDLL(lib_path)
# the round file's entries, taken from the profiled library
ENTRIES = ("vft_ml_nni_round_f32", "vft_ml_lengths_pass_f32",
           "vft_ml_round_tree_fits_smem", "vft_ml_round_scratch_floats")
for name in ENTRIES:
    fn, ref = getattr(prof, name), getattr(main, name)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
prof.vft_ml_round_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
prof.vft_ml_round_profile_read.restype = ctypes.c_int


class Lib:
    def __getattr__(self, name):
        return getattr(prof if name in ENTRIES else main, name)


def read():
    buf = (ctypes.c_ulonglong * (8 * 8))()
    rc = prof.vft_ml_round_profile_read(buf, 1)
    if rc:
        raise RuntimeError(f"vft_ml_round_profile_read: {rc}")
    return [list(buf[8 * k: 8 * k + 8]) for k in range(8)]


dev = torch.device("cuda")
start = s.ml_start(n, dev)
nj = s.ml_copy(start, dev)
_build._lib = Lib()
read()
result = {}
for what in ("pass", "round"):
    stats = rearrange.NNIStats.init(nj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if what == "pass":
        ml_round.ml_lengths_pass(nj)
    else:
        ml_round.ml_nni_round(nj, 0, 2, stats)
    torch.cuda.synchronize()
    fn = ml_round.ml_lengths_pass if what == "pass" else ml_round.ml_nni_round
    result[what] = {"cycles": read(), "wall_s": time.perf_counter() - t0,
                    "totals": dict(fn.totals)}
print("PROFILE " + json.dumps({"root": root, "n": n, "card": s.card_line(),
                               **result}), flush=True)
"""


def parse_breakdown(text):
    """The PROFILE records of a child's output: a list of dicts with the
    root, N, the card line and, for "pass" and "round", the cycles per
    slot and phase ([N_SLOTS][len(PHASES)]), the wall and the totals."""
    out = []
    for line in text.splitlines():
        if line.startswith("PROFILE "):
            rec = json.loads(line[len("PROFILE "):])
            for what in ("pass", "round"):
                cyc = rec[what]["cycles"]
                if len(cyc) != N_SLOTS or any(len(r) != len(PHASES)
                                               for r in cyc):
                    raise ValueError(f"{what}: cycles of shape "
                                     f"{len(cyc)} x {len(cyc[0])}")
            out.append(rec)
    return out


def shares(cycles):
    """{slot: (total cycles, [share of each phase])} of the slots that
    recorded any cycles."""
    out = {}
    for slot, row in enumerate(cycles):
        total = sum(row)
        if total:
            out[slot] = (total, [c / total for c in row])
    return out


def slot_name(slot):
    return f"block {slot // 2} group {slot % 2}"


def report(rec):
    """Text lines of one PROFILE record."""
    lines = [f"{rec['root']} (N={rec['n']}, {rec['card']}):"]
    for what in ("pass", "round"):
        r = rec[what]
        lines.append(f"  {what}: wall {r['wall_s']:.4f} s (probes on), "
                     f"totals {r['totals']}")
        for slot, (total, sh) in shares(r["cycles"]).items():
            lines.append(
                f"    {slot_name(slot)}: {total} cycles; " + ", ".join(
                    f"{p} {100 * x:.1f}%" for p, x in zip(PHASES, sh)))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--n", type=int, default=2000)
    args = ap.parse_args()
    smoke = os.path.join(REPO, "chip_smoke.py")
    for root in map(os.path.abspath, args.roots):
        proc = subprocess.run([sys.executable, "-c", CHILD, root, smoke,
                               str(args.n)], capture_output=True, text=True)
        recs = parse_breakdown(proc.stdout)
        if proc.returncode or not recs:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print("\n".join(report(recs[-1])), flush=True)
        print(proc.stdout.splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
