#!/usr/bin/env python3
"""Write the JAX package's ML trees that the PyTorch port is held against.

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, serial host
loops) on ``bench_e2e.synth_codes(200, 500, seed=0)`` with the sequence
names ``s0 .. s199``, twice: the default ``-nt`` run (ML NNIs, CAT 20
rates, SH-like supports from 1000 resamples) and ``-nt -gtr -gamma``.  For
each it writes

    tests/data/torch_port_ml_golden_n200_p500[_gtr_gamma].nwk   the Newick
    tests/data/torch_port_ml_golden_n200_p500[_gtr_gamma].json  the final
        LogLk, per-round ML-NNI LogLk and counts, the CAT rates

``chip_smoke.py`` reads them.  Takes a few minutes.

Usage: python scripts/make_torch_port_ml_golden.py
"""
from __future__ import annotations

import io
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, P, SEED = 200, 500, 0
DATA = os.path.join(REPO, "tests", "data")
RUNS = {"": {}, "_gtr_gamma": {"use_gtr": True, "gamma_loglk": True}}
ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def fasta_text(codes) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1} (as bench.py)."""
    from bench_e2e import ALPHA

    return "".join(f">s{i}\n{''.join(ALPHA[c] for c in row)}\n"
                   for i, row in enumerate(codes))


def parse_log(text: str) -> dict:
    """Per-round ML-NNI LogLk and counts, and the final LogLk, of a run's
    log (the same lines in both packages)."""
    rounds = [(float(ll), int(n)) for _, ll, n in ROUND.findall(text)]
    return {"round_loglk": [r[0] for r in rounds],
            "round_nnis": [r[1] for r in rounds],
            "final_loglk": float(FINAL.findall(text)[-1])}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bench_e2e import synth_codes
    from veryfasttree_tpu.engine import ml
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    fasta = fasta_text(synth_codes(N, P, seed=SEED))
    os.makedirs(DATA, exist_ok=True)
    for suffix, overrides in RUNS.items():
        opts = Options(n_codes=4, show_progress=False, **overrides)
        opts.derive_settings()
        out, log = io.StringIO(), io.StringIO()
        nj, _ = run_pipeline(opts, io.StringIO(fasta), out, log_fp=log)
        stem = os.path.join(DATA, f"torch_port_ml_golden_n{N}_p{P}{suffix}")
        with open(stem + ".nwk", "w") as f:
            f.write(out.getvalue())
        meta = {"n": N, "p": P, "seed": SEED, "options": overrides,
                **parse_log(log.getvalue()),
                "tree_loglk": ml.tree_loglk(nj),
                "rates": [float(r) for r in nj.ml.rates_np]}
        with open(stem + ".json", "w") as f:
            json.dump(meta, f, indent=1)
            f.write("\n")
        print(json.dumps({k: meta[k] for k in ("final_loglk", "round_nnis")}))


if __name__ == "__main__":
    main()
