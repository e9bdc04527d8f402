#!/usr/bin/env python3
"""Where the join epoch kernel and the SPR round kernel spend their cycles:
the whole NJ join phase at N=2000 (chip_smoke.py phase 2d's main-path
start, ten launches) and the main path's first SPR round at N=2000 (the
-noml pipeline on chip_smoke.py's input, stopped at its first call of the
round), on one or more checkouts, each in a process of its own.

    python scripts/profile_me_kernels.py [ROOT ...] [--n N] [--two-tier]

Each ROOT (default ".") gets second copies of its csrc/nj_epoch.cu and
csrc/me_spr.cu built with -DVFT_PROBES into ROOT/build/me_kernels_profile/
(the library the port loads never has that define).  With it, one thread
(the epoch's deciding lane, the round's thread 0; csrc/probes.cuh) adds
the clock64() cycles between its probes to the phase it was in, and the
epoch's master splits its waits on the grid by the global timer into the
handshake (its publish to the first worker group's start, the last group's
end to its resume) and the phase work, of which it also counts the refresh
scans' apart; the phases block 0 runs itself count apart.  With
--two-tier the join phase runs on the two-tier store, whose leaf rows the
refresh scans read with the code scan's body.  The join phase and the round run
through the ROOT's own wrappers (ops/epoch_kernels.py, ops/spr_kernels.py)
with the profiled library in place of their entries; the starts come from
this checkout's chip_smoke.py.  Each child prints one line "PROFILE
{json}"; the script then prints each kernel's shares.  The probes cost
cycles of their own: compare the shares, and take the kernels' times from
chip_smoke.py or scripts/compare_torch_port.py.

With --resources it profiles nothing: for each ROOT it rebuilds the
library the port loads and prints, for each of the three kernels (4 codes)
and ml_nni_round_kernel beside them, ptxas's registers, stack frame and
spill stores (ops/_build.ptxas_report) and the number of SASS instructions
that cuobjdump -sass shows, one line "RESOURCES {json}" per ROOT.

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS = 16                    # csrc/probes.cuh kProbeSlots
# csrc/probes.cuh, in the order of its enums
NJ_PHASES = ("other", "search", "hill climb", "merge", "refresh", "visible",
             "select", "anc chains", "waiting", "block-0 phases")
ME_PHASES = ("decisions", "path walk", "memo fills", "dist loads",
             "dist reductions", "averages", "commits", "unwinds",
             "ancestors", "quartet setup", "corrections")
KERNELS = {"nj": NJ_PHASES, "spr": ME_PHASES}

CHILD = r"""
import ctypes, json, os, subprocess, sys, time
root, smoke_path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
two_tier = sys.argv[4] == "1"
sys.path.insert(0, root)
import importlib.util
spec = importlib.util.spec_from_file_location("smoke", smoke_path)
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import torch
from veryfasttree_tpu_torch.ops import _build, epoch_kernels, spr_kernels

main = _build.library()
out_dir = os.path.join(root, "build", "me_kernels_profile")
os.makedirs(out_dir, exist_ok=True)
FILES = {"nj": ("nj_epoch.cu", ("vft_nj_epoch_f32", "vft_nj_epoch_scratch"),
                "vft_nj_epoch_profile_read"),
         "spr": ("me_spr.cu", ("vft_me_spr_round_f32",),
                 "vft_me_round_profile_read")}
libs, routes = {}, {}
procs = {}
for what, (src, entries, reader) in FILES.items():
    path = os.path.join(out_dir, f"libvft_{what}_profile.so")
    procs[what] = (path, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(src, []),
         "-DVFT_PROBES", "-shared", "-o", path, str(_build.SRC_DIR / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
for what, (path, proc) in procs.items():
    out = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(out)
    lib = libs[what] = ctypes.CDLL(path)
    src, entries, reader = FILES[what]
    for name in entries:
        fn, ref = getattr(lib, name), getattr(main, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        routes[name] = lib
    getattr(lib, reader).argtypes = [ctypes.c_void_p, ctypes.c_int]
    getattr(lib, reader).restype = ctypes.c_int


class Lib:
    def __getattr__(self, name):
        return getattr(routes.get(name, main), name)


def read(what):
    buf = (ctypes.c_ulonglong * 19)()
    rc = getattr(libs[what], FILES[what][2])(buf, 1)
    if rc:
        raise RuntimeError(f"{FILES[what][2]}: {rc}")
    return list(buf[:16]), list(buf[16:19])


dev = torch.device("cuda")
# the main path's first SPR round: the -noml pipeline on the smoke's input,
# its state taken at its first call of the round and the run stopped there
import io
from veryfasttree_tpu_torch.options import noml_options
from veryfasttree_tpu_torch.pipeline import run_pipeline


class Taken(Exception):
    pass


def take(nj, i_round, n_rounds, **kw):
    global start
    start = s.engine_copy(nj, dev)
    raise Taken


round_fn, spr_kernels.spr_round = spr_kernels.spr_round, take
try:
    run_pipeline(noml_options(), io.StringIO(s.fasta_text(s.synth_codes(n, s.MAIN_P))),
                 io.StringIO(), device=dev)
except Taken:
    pass
spr_kernels.spr_round = round_fn
_build._lib = Lib()
result = {}
for what in ("nj", "spr"):
    read(what)
    s.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if what == "nj":
        s.epoch_run(n, dev, two_tier=two_tier)
        fn = epoch_kernels.join_epoch
    else:
        nj = s.engine_copy(start, dev)
        spr_kernels.spr_round(nj, 0, 2)
        fn = spr_kernels.spr_round
    torch.cuda.synchronize()
    cycles, ns = read(what)
    result[what] = {"cycles": cycles, "ns": ns,
                    "wall_s": time.perf_counter() - t0,
                    "launches": fn.launches, "totals": dict(fn.totals)}
print("PROFILE " + json.dumps({"root": root, "n": n, "two_tier": two_tier,
                               "card": s.card_line(), **result}), flush=True)
"""


RESOURCE_KERNELS = ("nj_epoch_kernel", "me_spr_round_kernel",
                    "me_nni_round_kernel", "ml_nni_round_kernel")

RESOURCES = r"""
import json, os, re, subprocess, sys
root = sys.argv[1]
sys.path.insert(0, root)
from veryfasttree_tpu_torch.ops import _build
path, log = _build.build(force=True)
report = _build.ptxas_report(log)
cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                      text=True, check=True).stdout
counts, name = {}, None
for line in sass.splitlines():
    m = re.search(r"Function : (\S+)", line)
    if m:
        name = m.group(1)
        counts[name] = 0
    elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
        counts[name] += 1
out = {}
for k in KERNELS:
    res = _build.kernel_resources(report, k)
    tag = k + "ILi4E"
    out[k] = dict(res, sass=sum(v for f, v in counts.items() if tag in f))
print("RESOURCES " + json.dumps({"root": root, "kernels": out}), flush=True)
"""


def parse_breakdown(text):
    """The PROFILE records of a child's output: a list of dicts with the
    root, N, the card line and, for "nj" and "spr", the cycles per phase
    ([N_SLOTS]), the handshake, work and refresh-scan work nanoseconds ([3];
    [2] from probes that have no scan slot), the wall, the launches and the
    wrapper's totals."""
    out = []
    for line in text.splitlines():
        if line.startswith("PROFILE "):
            rec = json.loads(line[len("PROFILE "):])
            for what in KERNELS:
                r = rec[what]
                if len(r["cycles"]) != N_SLOTS or len(r["ns"]) not in (2, 3):
                    raise ValueError(f"{what}: {len(r['cycles'])} phases and "
                                     f"{len(r['ns'])} times")
            out.append(rec)
    return out


def shares(what, r):
    """(total cycles, {phase: share of the cycles}) of one kernel's record;
    the join epoch's waiting is split into its handshake and its work in
    the ratio of their nanoseconds."""
    names = KERNELS[what]
    cyc = r["cycles"]
    if any(cyc[len(names):]):
        raise ValueError(f"{what}: cycles past its {len(names)} phases")
    total = sum(cyc)
    out = {p: (c / total if total else 0.0) for p, c in zip(names, cyc)}
    if what == "nj":
        wait = out.pop("waiting")
        hand, work = r["ns"][:2]
        split = hand / (hand + work) if hand + work else 0.0
        out["handshake"] = wait * split
        out["phase work"] = wait * (1 - split)
    return total, out


def per_unit(what, r):
    """(cycles per join or per chain step, its name) of a record."""
    total = sum(r["cycles"])
    if what == "nj":
        return total / max(r["totals"].get("joins", 0), 1), "join"
    return total / max(r["totals"].get("quartets", 0), 1), "quartet"


def report(rec):
    """Text lines of one PROFILE record."""
    store = ", two-tier" if rec.get("two_tier") else ""
    lines = [f"{rec['root']} (N={rec['n']}{store}, {rec['card']}):"]
    for what in KERNELS:
        r = rec[what]
        total, sh = shares(what, r)
        unit, name = per_unit(what, r)
        lines.append(f"  {what}: {total} cycles in {r['launches']} launches "
                     f"({unit:.0f} per {name}), wall {r['wall_s']:.4f} s "
                     f"(probes on)")
        lines.append("    " + ", ".join(f"{p} {100 * x:.1f}%"
                                        for p, x in sh.items()))
        if what == "nj" and len(r["ns"]) == 3:
            t = r["totals"]
            lines.append(f"    refresh scans: {r['ns'][2] / 1e6:.4f} ms of "
                         f"phase work ({r['ns'][1] / 1e6:.4f} ms in all), "
                         f"{t.get('scans', 0)} scans of "
                         f"{t.get('scan_rows', 0)} rows")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--two-tier", action="store_true",
                    help="the join phase on the two-tier store (leaf rows "
                    "as codes, scanned by the code scan's body)")
    ap.add_argument("--resources", action="store_true",
                    help="registers, stack, spills and SASS instructions")
    args = ap.parse_args()
    if args.resources:
        child = RESOURCES.replace("KERNELS", repr(RESOURCE_KERNELS))
        for root in map(os.path.abspath, args.roots):
            proc = subprocess.run([sys.executable, "-c", child, root],
                                  capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESOURCES ")]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            print(lines[-1], flush=True)
        return 0
    smoke = os.path.join(REPO, "chip_smoke.py")
    for root in map(os.path.abspath, args.roots):
        proc = subprocess.run([sys.executable, "-c", CHILD, root, smoke,
                               str(args.n), str(int(args.two_tier))],
                              capture_output=True, text=True)
        recs = parse_breakdown(proc.stdout)
        if proc.returncode or not recs:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print("\n".join(report(recs[-1])), flush=True)
        print(proc.stdout.splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
