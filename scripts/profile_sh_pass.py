#!/usr/bin/env python3
"""The SH-like supports of the default -nt run at N=2000, P=500 on the
card: the list pass (ops/ml_round.sh_pass) against the host loop it
replaces (engine/ml.test_splits_ml with the per-call kernels), from one
state.

    python scripts/profile_sh_pass.py [--runs 3]

The default run (chip_smoke.run_ml on chip_smoke.synth_codes, as the
smoke's phase 6) stops where its SH pass would start: the pass is swapped
for a function that copies the state (chip_smoke.ml_copy) and ends the
run.  From that state:

* the pass `runs` times: its wall, and the host-clock seconds of each of
  its steps (ops/ml_round.SHPass.STEPS, called one by one here, the device
  waited for after each, which the main path does not do);
* the pass once under cProfile (the host's functions by their own time),
  and once under torch.profiler (CUDA activity): each kernel's launches
  and device time;
* the host loop once for its wall, and once more, its calls recorded
  (chip_smoke.sh_host_loop), under torch.profiler for its kernels'
  launches and device time; the bootstrap draw it makes first
  (engine/supports.resample_columns and resample_count_matrix) timed
  alone;
* the two outputs: per-split log-likelihoods, per-site likelihoods,
  choices, bad splits, supports, SplitCount, counters and store rows, bit
  for bit (chip_smoke.sh_diff); the script fails where they differ.

Prints the card's name and power limit and one line "RESULT {json}".  GPU
only; about a minute and a half with the build.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    """Ends the default run where its SH pass would start."""


def kernel_times(trace):
    """{kernel name: [launches, device ms]} of a CUDA-activity trace."""
    import torch

    out = collections.defaultdict(lambda: [0, 0.0])
    for evt in trace.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            entry = out[evt.name[:60]]
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us() / 1e3
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    for sub in ("", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from veryfasttree_tpu_torch.engine import ml
    from veryfasttree_tpu_torch.engine.supports import (
        resample_columns, resample_count_matrix)
    from veryfasttree_tpu_torch.ops import _build, ml_round

    if not torch.cuda.is_available():
        print("profile_sh_pass: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    _build.library()
    dev = torch.device("cuda")
    fasta = cs.fasta_text(cs.synth_codes(cs.MAIN_N, cs.MAIN_P))

    starts, orig = [], ml_round.sh_pass

    def stop(nj, *a, **k):
        starts.append(cs.ml_copy(nj, dev))
        raise _Stop

    ml_round.sh_pass = stop
    try:
        cs.run_ml(fasta, dev)
    except _Stop:
        pass
    finally:
        ml_round.sh_pass = orig
    start = starts[0]
    out = {"card": cs.card_line(), "splits": start.n_seqs - 3}

    walls, stages = [], collections.defaultdict(float)
    for _ in range(args.runs):
        nj = cs.ml_copy(start, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ml_round.sh_pass(nj)
        walls.append(time.perf_counter() - t0)
    for _ in range(args.runs):
        sh = ml_round.SHPass(cs.ml_copy(start, dev))
        for step in sh.STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(sh, step)()
            torch.cuda.synchronize()
            stages[step] += time.perf_counter() - t0
    out["pass_walls_s"] = walls
    out["pass_stages_s"] = {k: v / args.runs for k, v in stages.items()}

    nj = cs.ml_copy(start, dev)
    prof = cProfile.Profile()
    prof.enable()
    ml_round.sh_pass(nj)
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
    out["pass_cprofile_top"] = text.getvalue()[-3000:]

    nj = cs.ml_copy(start, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        sc, record, sh = cs.sh_run(nj)
        torch.cuda.synchronize()
    out["pass_traced_wall_s"] = time.perf_counter() - t0
    out["pass_kernels"] = kernel_times(trace)
    out["pass_work"] = cs.sh_work(sh)
    got = cs.sh_state(nj, sc, record)

    t0 = time.perf_counter()
    resample_count_matrix(resample_columns(start), start.n_pos)
    out["host_draw_s"] = time.perf_counter() - t0
    nj = cs.ml_copy(start, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml.test_splits_ml(nj)
    torch.cuda.synchronize()
    out["host_loop_wall_s"] = time.perf_counter() - t0
    nj = cs.ml_copy(start, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        want = cs.sh_state(nj, *cs.sh_host_loop(nj))
        torch.cuda.synchronize()
    out["host_loop_kernels"] = kernel_times(trace)
    out["differ"] = cs.sh_diff(got, want)
    print(out["card"])
    print("RESULT " + json.dumps(out), flush=True)
    return 1 if out["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
