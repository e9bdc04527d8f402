#!/usr/bin/env python3
"""The single-call ML kernels (ml_pair_loglk, ml_posterior, ml_quartet_opt)
and the ML round kernels (ml_lengths_pass, ml_nni_round) of two checkouts
on the same inputs, in turns, each run in a process of its own.

    python scripts/compare_ml_kernels.py OLD NEW [--rounds 2]

OLD and NEW are roots of checkouts (this one is "."); with two rounds the
runs go OLD, NEW, NEW, OLD.  Both checkouts' kernels are built first, at
once.  Each run times the calls of chip_smoke.py's phase 2 (this
checkout's chip_smoke.py makes the inputs, the checkout's own wrappers
run them): one pair likelihood, one posterior and one quartet optimization
whose star test does not end it, on chip_smoke.ml_store_case's and
quartet_store's Jukes-Cantor stores (P=512, C=4), and one call each at the
SH pass's list shapes (chip_smoke.LIST_PAIRS pairs, LIST_POSTERIORS
posteriors; a checkout whose launches took 256 pairs or 128 posteriors
makes several launches of one call).  For each it prints the
device time per call from torch.profiler (chip_smoke.device_us, 50 calls;
a burst's time between CUDA events when the trace lost launches), the
median launch-to-launch time of 50 calls between CUDA events
(chip_smoke.median_ms), and the time per call of a burst of 200 calls.
Then one ML lengths pass and one ML NNI round at N=2000 from chip_smoke.py
phase 2e's N=MAIN_N start (ml_start: the main path's layout), through the
checkout's wrappers: the device time of each (torch.profiler over three
pass-then-round runs) and the wall of one launch.  Each run also hashes
what each call leaves behind (the single calls' outputs; the pass's and
round's tree, branch lengths, NNIStats, debug counters, work counters and
store rows, chip_smoke.ml_state) and the tree LogLk after the round; the
script fails unless every run of both checkouts gives the same hashes and
LogLk.  At the end, one line per checkout with the mean of its runs.
Before the runs it
prints each kernel's (C=4) registers and stack in each checkout's library
(`cuobjdump -res-usage`), its SASS instruction count, and whether the two
checkouts' instruction streams are the same (addresses and constants
aside).

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("ml_pair_loglk", "ml_posterior", "ml_quartet_opt")
LISTS = ("ml_pair_loglk_list", "ml_posterior_list")
ROUNDS = ("ml_lengths_pass", "ml_nni_round")

BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from veryfasttree_tpu_torch.ops import _build
_build.build()
"""

CHILD = r"""
ROUND_NAMES = ("ml_lengths_pass", "ml_nni_round")
import hashlib, importlib.util, json, sys, time
root, smoke_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke_inputs", smoke_path)
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import numpy as np
import torch
from veryfasttree_tpu_torch.ops import _build
from veryfasttree_tpu_torch.ops import ml_kernels as mk
_build.library()
dev = torch.device("cuda")


def burst_us(fn, runs=200):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    return 1e3 * start.elapsed_time(stop) / runs


calls = {}
codes, W, V, m = s.ml_store_case(4, "jc", torch.Generator(dev).manual_seed(0),
                                 dev)
rng = np.random.default_rng(6)
n_rows = codes.shape[0]
r1, r2 = rng.integers(0, n_rows, 200), rng.integers(0, n_rows, 200)
lens = rng.uniform(0.0, 0.5, 200)
calls["ml_pair_loglk"] = lambda: mk.ml_pair_loglk(
    codes, W, V, m, r1[:1], r2[:1], lens[3:4])
post = (codes.clone(), W.clone(), V.clone(), m, np.array([n_rows - 1]),
        r1[:1] % s.MAIN_N + s.MAIN_N, r2[:1] % s.MAIN_N, lens[:1] + 5e-4,
        lens[1:2] + 5e-4)
calls["ml_posterior"] = lambda: mk.ml_posterior(*post)
# the SH pass's list shapes at N=MAIN_N (chip_smoke.LIST_PAIRS pairs and
# LIST_POSTERIORS posteriors into the list-pass rows), in one call each
K = s.LIST_PAIRS
lr1, lr2 = rng.integers(0, n_rows, K), rng.integers(0, n_rows, K)
llens = rng.uniform(0.0, 0.5, K)
calls["ml_pair_loglk_list"] = lambda: mk.ml_pair_loglk(
    codes, W, V, m, lr1, lr2, llens, True)
K = s.LIST_POSTERIORS
lpost = (codes.clone(), W.clone(), V.clone(), m,
         n_rows - 2 * s.MAIN_N + np.arange(K),
         rng.integers(0, 2 * s.MAIN_N, K), rng.integers(0, 2 * s.MAIN_N, K),
         rng.uniform(5e-4, 0.5, K), rng.uniform(5e-4, 0.5, K))
calls["ml_posterior_list"] = lambda: mk.ml_posterior(*lpost)
store = s.quartet_store("jc", torch.Generator(dev).manual_seed(1), dev)
qrng = np.random.default_rng(13)
fam = 4 * np.arange(s.N_FAMILIES)[:, None]
rows4 = np.concatenate([
    fam[:100] + [0, 1, 2, 3], fam[100:] + [0, 2, 1, 3],
    qrng.integers(4 * s.N_FAMILIES, 4 * s.MAIN_N, (40, 4))]).astype(np.int32)
qlens = np.maximum(qrng.uniform(0.0, 0.3, (len(rows4), 5)), s.QUARTET_LIMS[0])
lims = (s.SCRATCH_ROWS, *s.QUARTET_LIMS)
rec, _ = mk.ml_quartet_opt(*store, rows4, qlens, *lims, True, False)
k = int(np.flatnonzero(rec["star"] == 0)[0])
calls["ml_quartet_opt"] = lambda: mk.ml_quartet_opt(
    *store, rows4[k:k + 1], qlens[k:k + 1], *lims, True, False)


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(
            a.cpu().numpy() if torch.is_tensor(a) else a).tobytes())
    return h.hexdigest()


out = {}
for name, fn in calls.items():
    kernel = name.replace("_list", "")
    out[name] = {"device_us": s.device_us(fn, s.DEVICE_NAMES[kernel]),
                 "l_to_l_us": 1e3 * s.median_ms(fn),
                 "burst_us": burst_us(fn)}
ll, _ = calls["ml_pair_loglk"]()
calls["ml_posterior"]()
rec, _ = calls["ml_quartet_opt"]()
out["ml_pair_loglk"]["digest"] = digest(ll)
out["ml_posterior"]["digest"] = digest(post[1][-1], post[2][-1])
out["ml_quartet_opt"]["digest"] = digest(rec)
out["ml_pair_loglk_list"]["digest"] = digest(*calls["ml_pair_loglk_list"]())
calls["ml_posterior_list"]()
out["ml_posterior_list"]["digest"] = digest(*(t[lpost[4]] for t in lpost[:3]))

# the round kernels at N=MAIN_N: a pass, then a round, from one start
from veryfasttree_tpu_torch.engine import ml, rearrange
from veryfasttree_tpu_torch.ops import ml_round

start = s.ml_start(s.MAIN_N, dev)
walls = {k: [] for k in ("ml_lengths_pass", "ml_nni_round")}
states = {}


def both():
    nj = s.ml_copy(start, dev)
    stats = rearrange.NNIStats.init(nj)
    for name, fn in (("ml_lengths_pass", lambda: ml_round.ml_lengths_pass(nj)),
                     ("ml_nni_round",
                      lambda: ml_round.ml_nni_round(nj, 0, 2, stats))):
        wrapper = getattr(ml_round, name)
        wrapper.totals = dict.fromkeys(wrapper.totals, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        tree, ctr, rows = s.ml_state(nj, stats if name == "ml_nni_round"
                                     else None, result)
        work = {k: v for k, v in wrapper.totals.items()
                if k != "speculative"}
        states[name] = (digest(*tree.values(), *rows.values(),
                               json.dumps([ctr, work]).encode()),
                        wrapper.totals.get("speculative"))
    return nj


for name in ROUND_NAMES:
    out[name] = {"device_us": s.device_us(both, s.DEVICE_NAMES[name],
                                          runs=3)}
for name in ROUND_NAMES:
    out[name].update(wall_ms=1e3 * sorted(walls[name])[len(walls[name]) // 2],
                     digest=states[name][0], speculative=states[name][1])
out["ml_nni_round"]["tree_loglk"] = ml.tree_loglk(both())
print("RESULT " + json.dumps(out), flush=True)
"""


def kernel_code(root):
    """{kernel: (resource line, SASS instruction count, digest of the
    instructions with addresses and constants blanked)} of KERNELS (C=4) in
    root's built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = os.path.join(root, "build", "torch_kernels", "libvft_scan.so")
    pick = lambda name: next((k for k in KERNELS  # noqa: E731
                              if f"{k}_kernelILi4E" in name), None)
    res, cur = {}, None
    for line in subprocess.run([tool, "-res-usage", lib], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        if "Function " in line:
            cur = pick(line)
        elif cur and "REG:" in line:
            res[cur] = " ".join(line.split()[:2])
            cur = None
    sass, cur = {}, None
    for line in subprocess.run([tool, "-sass", lib], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = pick(m.group(1))
            if cur:
                sass[cur] = []
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            sass[cur].append(re.sub(r"0x[0-9a-f]+", "X", ins))
    return {k: (res.get(k), len(sass.get(k, ())),
                hashlib.sha256("\n".join(sass.get(k, ())).encode())
                .hexdigest()) for k in KERNELS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in (args.old, args.new)]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, r])
              for r in roots]
    if any(p.wait() for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    code = [kernel_code(r) for r in roots]
    for k in KERNELS:
        (r0, n0, d0), (r1, n1, d1) = code[0][k], code[1][k]
        print(f"{k}<4>: OLD {r0}, {n0} SASS instructions; NEW {r1}, {n1}; "
              f"{'the same' if d0 == d1 else 'other'} instructions",
              flush=True)
    smoke = os.path.join(REPO, "chip_smoke.py")
    order = []
    for i in range(args.rounds):
        order += roots if i % 2 == 0 else roots[::-1]
    results = {r: [] for r in roots}
    for root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, root, smoke],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        results[root].append(res)
        print(f"{root}: " + "; ".join(
            f"{name} device {r['device_us']:.3f} us, l-to-l "
            f"{r['l_to_l_us']:.3f} us, burst {r['burst_us']:.3f} us"
            for name, r in res.items() if name in KERNELS + LISTS)
            + "; " + "; ".join(
            f"{name} device {r['device_us'] / 1e3:.3f} ms, wall "
            f"{r['wall_ms']:.3f} ms" + (f", speculative {r['speculative']}"
                                        if r.get("speculative") is not None
                                        else "")
            for name, r in res.items() if name in ROUNDS)
            + f"; tree LogLk {res['ml_nni_round']['tree_loglk']!r}",
            flush=True)
    for root, runs in results.items():
        mean = {name: {k: sum(r[name][k] for r in runs) / len(runs)
                       for k in ("device_us", "l_to_l_us", "burst_us",
                                 "wall_ms") if k in runs[0][name]}
                for name in runs[0]}
        print(f"mean of {len(runs)} runs, {root}: " + "; ".join(
            f"{name} " + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
            for name, m in mean.items()))
    seen = {name: {(r[name]["digest"], r[name].get("tree_loglk"))
                   for runs in results.values() for r in runs}
            for name in KERNELS + LISTS + ROUNDS}
    differ = [name for name, vals in seen.items() if len(vals) != 1]
    print("outputs: " + ("the same in every run of both checkouts"
                         if not differ else f"{differ} differ"))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
