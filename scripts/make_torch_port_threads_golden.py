#!/usr/bin/env python3
"""Write the JAX package's -threads 8 trees that chip_smoke.py phase 9
holds the PyTorch port to.

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, the batched
tier of -threads > 1) on ``chip_smoke.synth_codes(n, 500, seed=0)`` with
the sequence names ``s0 .. s{n-1}``, twice: ``-nt -noml -threads 8`` at
n=500 (with its local bootstrap, 1000 resamples) and the default ``-nt
-threads 8`` run at n=200.  For each it writes

    tests/data/torch_port_threads_golden_n500_p500.nwk      (-noml)
    tests/data/torch_port_threads_ml_golden_n200_p500.nwk   (default)
    ... and a .json beside each: the SplitCount, the final LogLk (ML);
    and for the default run ..._decisions.json: every quartet of its
    batched ML NNI rounds in order, [rows (A, B, C, D), choice, the three
    LogLks]

Takes a few minutes.

Usage: python scripts/make_torch_port_threads_golden.py
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

P, SEED, THREADS = 500, 0, 8
DATA = os.path.join(REPO, "tests", "data")
RUNS = {"torch_port_threads_golden_n500_p500": (500, {"ml_nni": 0}),
        "torch_port_threads_ml_golden_n200_p500": (200, {})}
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke
    from torch_thread_runs import Decisions
    from veryfasttree_tpu.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    os.makedirs(DATA, exist_ok=True)
    for stem, (n, overrides) in RUNS.items():
        fasta = chip_smoke.fasta_text(chip_smoke.synth_codes(n, P, seed=SEED))
        opts = Options(n_codes=4, show_progress=False, threads=THREADS,
                       **overrides)
        opts.derive_settings()
        out, log = io.StringIO(), io.StringIO()
        with Decisions(MLProfiles) as rec:
            _, sc = run_pipeline(opts, io.StringIO(fasta), out, log_fp=log)
        decisions = [[list(rows), choice, [float(x) for x in crit]]
                     for rows, choice, crit in rec.quartets()]
        if decisions:
            with open(os.path.join(DATA, stem + "_decisions.json"),
                      "w") as f:
                json.dump(decisions, f)
                f.write("\n")
        with open(os.path.join(DATA, stem + ".nwk"), "w") as f:
            f.write(out.getvalue())
        final = FINAL.findall(log.getvalue())
        meta = {"n": n, "p": P, "seed": SEED, "threads": THREADS,
                "options": overrides,
                "split_count": {k: float(v) for k, v in
                                dataclasses.asdict(sc).items()},
                "final_loglk": float(final[-1]) if final else None}
        with open(os.path.join(DATA, stem + ".json"), "w") as f:
            json.dump(meta, f, indent=1)
            f.write("\n")
        print(stem, json.dumps(meta["split_count"]), meta["final_loglk"])


if __name__ == "__main__":
    main()
