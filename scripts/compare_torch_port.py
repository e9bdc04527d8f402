#!/usr/bin/env python3
"""The PyTorch port's default -nt run at N=2000, P=500 (chip_smoke.py's ML
main path, bench.py's input), or its -nt -noml -nosupport run (--noml,
chip_smoke.py's -noml main path), in two or more checkouts, in turns, each
run in a process of its own.

    python scripts/compare_torch_port.py OLD NEW [--rounds 2] [--trace]
                                         [--noml] [--profile-sh]

OLD and NEW are roots of checkouts (this one is "."); with two rounds the
runs go OLD, NEW, NEW, OLD.  Each run builds its checkout's kernels first
(outside the timed wall), then runs once as a user's run does (no
deterministic mode) and prints one line "RESULT {json}": the wall, the
phase split (nj.timings), the ML-NNI rounds (LogLk, NNIs), the final
LogLk (none with --noml), every kernel wrapper's launches and the round
and epoch wrappers' totals (the join epoch's joins, phases and scans).  With
--trace the second round's runs are traced with torch.profiler (CUDA
activity): the device's busy seconds and share of that run's wall, and the
kernels by device time.  With --profile-sh (the default run) every run's
first SH pass, the only one of its process, runs under cProfile: its wall
(the device waited for), its host functions by own time with the chain
of callers that spent the most time in each, and the
garbage collections inside it (count, seconds, oldest generation) with
the objects the collector tracked when it began ("sh_profile").  Beside
each run, nvidia-smi samples the card's
power draw, SM and memory clocks and temperature every 100 ms, from the
end of its kernels' build to the end of its process; the RESULT line's
"smi" holds their mean, least and largest values.
At the end, one line per checkout: the walls and phases of its runs, and
whether the trees, LogLk values and ML-NNI counts of all runs agree.

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import collections, hashlib, importlib, io, json, os, re, sys, time
root, fasta, trace = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
noml = sys.argv[4] == "1"
profile_sh = sys.argv[5] == "1"
sys.path.insert(0, root)
import torch
from veryfasttree_tpu_torch.ops import _build
from veryfasttree_tpu_torch.options import ml_options, noml_options
from veryfasttree_tpu_torch.pipeline import run_pipeline
# the kernel wrappers' modules (an older checkout may lack one)
mods = [importlib.import_module("." + name, "veryfasttree_tpu_torch.ops")
        for name in ("scan_kernels", "store_kernels", "ml_kernels",
                     "spr_kernels", "nni_kernels", "epoch_kernels",
                     "ml_round", "resample_kernels")
        if os.path.exists(os.path.join(root, "veryfasttree_tpu_torch", "ops",
                                       name + ".py"))]

_build.library()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
print("READY", flush=True)
wrappers = {name: fn for mod in mods for name, fn in vars(mod).items()
            if callable(fn) and hasattr(fn, "launches")}
for fn in wrappers.values():
    fn.launches = 0
sh = {}
if profile_sh:
    import cProfile, gc, pstats
    from veryfasttree_tpu_torch.ops import ml_round
    inner = ml_round.sh_pass

    def sh_pass(*args, **kw):
        if sh:
            return inner(*args, **kw)
        sh["gc_objects"] = len(gc.get_objects())
        gcs, began = [], [0.0]

        def on_gc(phase, info):
            if phase == "start":
                began[0] = time.perf_counter()
            else:
                gcs.append((info["generation"], time.perf_counter() - began[0]))

        gc.callbacks.append(on_gc)
        prof_sh = cProfile.Profile()
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof_sh.enable()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        prof_sh.disable()
        sh["wall"] = time.perf_counter() - t
        gc.callbacks.remove(on_gc)
        sh["gc"] = [len(gcs), sum(s for _, s in gcs),
                    max((g for g, _ in gcs), default=None)]
        stats = pstats.Stats(prof_sh).stats

        def label(func):
            return f"{os.path.basename(func[0])}:{func[1]}:{func[2]}"

        def callers(func, depth=8):
            # up the callers that spent the most time in it
            chain = []
            while depth and stats.get(func, (0,) * 5)[4]:
                up = stats[func][4]
                func = max(up, key=lambda c: up[c][3])
                chain.append(label(func))
                depth -= 1
            return chain

        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
        sh["top_own"] = [(label(func), calls, tt, ct, callers(func))
                         for func, (_, calls, tt, ct, _) in top]
        return out

    ml_round.sh_pass = sh_pass
with open(fasta) as f:
    text = f.read()
out, log = io.StringIO(), io.StringIO()
prof = None
if trace:
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
t0 = time.perf_counter()
nj, _ = run_pipeline(noml_options() if noml else ml_options(),
                     io.StringIO(text), out, log_fp=log,
                     device=torch.device("cuda"))
torch.cuda.synchronize()
wall = time.perf_counter() - t0
res = {"root": root, "wall": wall, "timings": nj.timings,
       "launches": {k: fn.launches for k, fn in wrappers.items()},
       "totals": {k: fn.totals for k, fn in wrappers.items()
                  if hasattr(fn, "totals")},
       "rounds": [(float(a), int(b)) for _, a, b in re.findall(
           r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)",
           log.getvalue())],
       "final": (re.findall(r"Optimize all lengths: LogLk = (-?[\d.]+)",
                            log.getvalue()) or [None])[-1],
       "newick_sha256": hashlib.sha256(out.getvalue().encode()).hexdigest(),
       "card": torch.cuda.get_device_name(0)}
if sh:
    res["sh_profile"] = sh
if prof is not None:
    prof.__exit__(None, None, None)
    count, total = collections.Counter(), collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            count[evt.name] += 1
            total[evt.name] += evt.time_range.elapsed_us()
    busy = sum(total.values()) / 1e6
    res["busy_s"], res["busy_share"] = busy, busy / wall
    res["device_events"] = sum(count.values())
    res["kernels"] = [(name[:70], count[name], us / 1e3, us / count[name])
                      for name, us in total.most_common(10)]
print("RESULT " + json.dumps(res), flush=True)
"""


SMI_FIELDS = ("power.draw", "clocks.sm", "clocks.mem", "temperature.gpu")


def smi_sampler(path):
    """An nvidia-smi process writing SMI_FIELDS to `path` every 100 ms."""
    out = open(path, "w")
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
         "--format=csv,noheader,nounits", "-lms=100"],
        stdout=out, stderr=subprocess.DEVNULL)
    proc.log = out
    return proc


def smi_summary(proc, path):
    """Stop the sampler (None: none started); {field: [mean, least,
    largest], "samples": n}."""
    if proc is None:
        return None
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.log.close()
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
    rows = [r for r in rows if len(r) == len(SMI_FIELDS)]
    if not rows:
        return {"samples": 0}
    cols = list(zip(*rows))
    out = {k: [round(sum(c) / len(c), 2), min(c), max(c)]
           for k, c in zip(SMI_FIELDS, cols)}
    out["samples"] = len(rows)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", help="checkout roots to compare")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--trace", action="store_true",
                        help="trace the second round's runs")
    parser.add_argument("--noml", action="store_true",
                        help="the -nt -noml -nosupport run")
    parser.add_argument("--profile-sh", action="store_true",
                        help="profile each run's SH pass (the default run)")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from chip_smoke import MAIN_N, MAIN_P, card_line, fasta_text, synth_codes

    print(card_line(), flush=True)
    results = {root: [] for root in args.roots}
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "n2000.fasta")
        with open(fasta, "w") as f:
            f.write(fasta_text(synth_codes(MAIN_N, MAIN_P)))
        for r in range(args.rounds):
            order = args.roots if r % 2 == 0 else args.roots[::-1]
            for root in order:
                trace = args.trace and r == 1
                smi_path = os.path.join(tmp, "smi.csv")
                err_path = os.path.join(tmp, "stderr.txt")
                sampler = None
                with open(err_path, "w") as err:
                    child = subprocess.Popen(
                        [sys.executable, "-c", CHILD, os.path.abspath(root),
                         fasta, "1" if trace else "0",
                         "1" if args.noml else "0",
                         "1" if args.profile_sh else "0"],
                        cwd=os.path.abspath(root), stdout=subprocess.PIPE,
                        stderr=err, text=True)
                    try:
                        # sample from the end of the kernels' build on
                        first = child.stdout.readline()
                        if first.startswith("READY"):
                            sampler = smi_sampler(smi_path)
                        stdout = first + child.communicate()[0]
                    finally:
                        smi = smi_summary(sampler, smi_path)
                        if child.poll() is None:
                            child.kill()
                            child.wait()
                lines = [ln for ln in stdout.splitlines()
                         if ln.startswith("RESULT ")]
                if child.returncode != 0 or not lines:
                    with open(err_path) as f:
                        print(f"{root}: exit {child.returncode}\n"
                              f"{f.read()[-3000:]}", flush=True)
                    return 1
                result = json.loads(lines[-1][len("RESULT "):])
                result["smi"] = smi
                print("RESULT " + json.dumps(result), flush=True)
                results[root].append(result)
    runs = [res for rs in results.values() for res in rs]
    same = all((res["final"], res["rounds"], res["newick_sha256"])
               == (runs[0]["final"], runs[0]["rounds"],
                   runs[0]["newick_sha256"])
               for res in runs)
    for root, rs in results.items():
        walls = ", ".join(f"{res['wall']:.3f}" for res in rs)
        phases = {k: [round(res["timings"][k], 3) for res in rs]
                  for k in rs[0]["timings"]}
        print(f"{root}: walls {walls} s; phases {phases}; final LogLk "
              f"{rs[0]['final']}; ML-NNIs per round "
              f"{[n for _, n in rs[0]['rounds']]}", flush=True)
    print(f"same tree, LogLk and ML-NNI counts in every run: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
