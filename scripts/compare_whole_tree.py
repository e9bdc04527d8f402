#!/usr/bin/env python3
"""The whole-tree ML kernels (ml_posterior_sweep, ml_tree_loglk) of two
checkouts on the same inputs, in turns, each run in a process of its own.

    python scripts/compare_whole_tree.py OLD NEW [--rounds 2]

OLD and NEW are roots of checkouts (this one is "."); with two rounds the
runs go OLD, NEW, NEW, OLD.  Both checkouts' kernels are built first, at
once.  This checkout's chip_smoke.py makes the inputs and the checkout's
own wrappers and tables run them, at CAT 20 (chip_smoke.CAT_N rates, the
categories drawn from seed 0):

* nj: the port's N=MAIN_N NJ tree with its ME lengths, Jukes-Cantor
  (chip_smoke.ml_start), and the SH pass's up-profile sweep over it
  (a parent's up-profile feeds both children's: "nj up");
* caterpillar: chip_smoke.shaped_tree's caterpillar of DEEP_N leaves,
  Jukes-Cantor, and at 20 codes (JTT, -approxml's gate on);
* balanced: its balanced tree of MAIN_N leaves at 20 codes (JTT, the gate
  on).

For each tree, one sweep (TreeSweep.posteriors) and one tree
log-likelihood with per-site sums (TreeSweep.loglk): the device time per
call from torch.profiler (chip_smoke.device_us, 50 calls), the median
launch-to-launch time (chip_smoke.median_ms) and the bound
(chip_smoke.sweep_bound, loglk_bound).  Each run hashes the store's rows
after one sweep and one tree log-likelihood from the start, the total, the
per-site sums and the rough/exact counts; the script fails unless every
run of both checkouts gives the same hashes.  At the end, one line per
checkout with the mean of its runs.

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from veryfasttree_tpu_torch.ops import _build
_build.build()
"""

CHILD = r"""
import hashlib, importlib.util, json, sys
root, smoke_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke_inputs", smoke_path)
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import numpy as np
import torch
from veryfasttree_tpu_torch.engine import ml as eml
from veryfasttree_tpu_torch.ops import _build
from veryfasttree_tpu_torch.ops import ml_kernels as mk
from veryfasttree_tpu_torch.ops import ml_round
_build.library()
dev = torch.device("cuda")


def cat20(nj):
    rng = np.random.default_rng(0)
    nj.ml.set_rates(eml.ml_site_rates(s.CAT_N),
                    rng.integers(0, s.CAT_N, nj.n_pos).astype(np.int32))
    nj.ml.recompute_ml_profiles()
    return nj


def up_tables(nj):
    ml = nj.ml
    levels = ml_round._up_levels(nj, ml_round.SHPass(nj).nodes)
    return mk.SweepTables.from_levels([
        (t, r1, r2, ml._clamped(l1), ml._clamped(l2))
        for t, r1, r2, l1, l2 in levels])


def digest(ml, *extra):
    h = hashlib.sha256()
    for t in (ml.codes, ml.W, ml.V, ml.post_counts) + extra:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(fn, name, bound):
    return {"device_us": s.device_us(fn, s.DEVICE_NAMES[name]),
            "l_to_l_ms": s.median_ms(fn), "bound_ms": bound[0]}


starts = {
    "nj": lambda: cat20(s.ml_start(s.MAIN_N, dev, "jc")),
    "caterpillar": lambda: s.shaped_start(s.DEEP_N, dev, "caterpillar", "jc"),
    "caterpillar<20>": lambda: s.shaped_start(s.DEEP_N, dev, "caterpillar",
                                              "jtt", approx=True),
    "balanced<20>": lambda: s.shaped_start(s.MAIN_N, dev, "balanced", "jtt",
                                           approx=True),
}
out = {}
for label, make in starts.items():
    nj = make()
    start = s.ml_copy(nj, dev)   # the inputs of the hashed runs, untouched
    ml = nj.ml
    P, C = ml.W.shape[1], ml.V.shape[2]
    sw = ml.tree_sweep()
    store = ml._store()
    sweeps = [(label, sw.posteriors)]
    if label == "nj":
        sweeps.append(("nj up", up_tables(nj)))
    for name, tables in sweeps:
        fresh = s.ml_copy(start, dev).ml
        mk.ml_posterior_sweep(*fresh._store(), tables)
        out[f"sweep {name}"] = {
            "digest": digest(fresh), "items": int(tables.n_items),
            "levels": int(tables.n_levels),
            **timed(lambda: mk.ml_posterior_sweep(*store, tables),
                    "ml_posterior_sweep",
                    s.sweep_bound(tables, P, C, ml.jc))}
    fresh = s.ml_copy(start, dev).ml
    ll, site = mk.ml_tree_loglk(*fresh._store(), sw.loglk, True)
    out[f"loglk {label}"] = {
        "digest": digest(fresh, ll, site), "total": float(ll),
        "pairs": int(sw.loglk.n_pairs), "levels": int(sw.loglk.n_levels),
        **timed(lambda: mk.ml_tree_loglk(*store, sw.loglk, True),
                "ml_tree_loglk",
                s.loglk_bound(sw.loglk, P, C, ml.jc, ml.n_pos, True))}
print("RESULT " + json.dumps(out), flush=True)
"""


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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
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
            f"{r['l_to_l_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms"
            for name, r in res.items()), flush=True)
    for root, runs in results.items():
        print(f"mean of {len(runs)} runs, {root}: " + "; ".join(
            f"{name} device {sum(r[name]['device_us'] for r in runs) / len(runs):.3f} us"
            for name in runs[0]))
    names = list(next(iter(results.values()))[0])
    differ = [name for name in names
              if len({r[name]["digest"] for runs in results.values()
                      for r in runs}) != 1]
    print("outputs: " + ("the same in every run of both checkouts"
                         if not differ else f"{differ} differ"))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
