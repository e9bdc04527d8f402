#!/usr/bin/env python3
"""The bootstrap counts kernel (sh_resample_counts) and the two-tier code
scan (nj_scan_codes) of two checkouts on the same inputs, in turns.

    python scripts/compare_scan_resample.py OLD NEW [--rounds 2]

Each ROOT runs in a process of its own, in the order OLD, NEW, NEW, OLD
(--rounds 2; each round is one OLD-NEW or NEW-OLD pair), through the ROOT's
own wrappers and library (built into ROOT/build/torch_kernels/ as the port
builds it).  The inputs and the timing come from this checkout's
chip_smoke.py: the counts at B=1000 and P=500 (the default run's) and
P=5000; the code scan at L=20000, P=512 with 4 codes (%different) and 20
(BLOSUM45), chip_smoke.codes_case.  Per case: the device time per call
(torch.profiler, chip_smoke.device_us; for the scan, the scan kernel alone
and with its argmin pass) and the launch-to-launch median (CUDA events).
Outputs must be equal in every run of both roots (SHA-256 of the counts,
and of the scan's best index, dist, denom and crit); it exits 1 if not.

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, importlib.util, json, sys
root, smoke_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke", smoke_path)
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import torch
from veryfasttree_tpu_torch.ops import _build, resample_kernels as rk
from veryfasttree_tpu_torch.ops import scan_kernels as sk

_build.library()
dev = torch.device("cuda")


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


out = {}
for P in (500, 5000):
    fn = lambda: rk.sh_resample_counts(P, 1000, dev)
    sha = digest(fn())
    out[f"sh_resample_counts P={P} B=1000"] = {
        "sha": sha, "ms": s.median_ms(fn, runs=20),
        "device_us": s.device_us(fn, ("sh_resample_counts_kernel",), runs=10)}
gen = torch.Generator(device=dev)
gen.manual_seed(0)
for C, matrix in ((4, False), (20, True)):
    args = s.codes_case(C, matrix, gen, dev)
    fn = lambda: sk.nj_scan_codes(*args)
    sha = digest(*fn())
    out[f"nj_scan_codes L=20000 P=512 C={C}"] = {
        "sha": sha, "ms": s.median_ms(fn),
        "device_us": s.device_us(fn, ("nj_scan_codes_kernel",
                                      "argmin_partials_kernel")),
        "scan_us": s.device_us(fn, ("nj_scan_codes_kernel",))}
print("TIMES " + json.dumps({"root": root, "card": s.card_line(),
                             "cases": out}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smoke = os.path.join(REPO, "chip_smoke.py")
    old, new = os.path.abspath(args.old), os.path.abspath(args.new)
    order = []
    for r in range(args.rounds):
        order += [old, new] if r % 2 == 0 else [new, old]
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, root, smoke],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("TIMES ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][len("TIMES "):])
        runs.append(rec)
        tag = "OLD" if root == old else "NEW"
        print(f"{tag} {root} ({rec['card']}):")
        for case, r in rec["cases"].items():
            extra = (f", scan kernel alone {r['scan_us']:.2f} us"
                     if "scan_us" in r else "")
            print(f"  {case}: {r['device_us']:.2f} us on the device{extra}, "
                  f"{r['ms']:.4f} ms launch to launch, output {r['sha']}")
        print("RUN " + json.dumps(rec), flush=True)
    shas = {case: {r["cases"][case]["sha"] for r in runs}
            for case in runs[0]["cases"]}
    differ = [case for case, v in shas.items() if len(v) != 1]
    if differ:
        print(f"outputs differ between the runs: {differ}", file=sys.stderr)
        return 1
    print("outputs equal in every run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
