#!/usr/bin/env python3
"""Write the JAX package's protein ML trees that the PyTorch port is held
against.

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, serial host
loops) on ``bench_e2e.synth_codes(200, 300, seed=0, n_codes=20)`` (the
codes as the letters of ``constants.CODES_STRING_AA``, sequence names
``s0 .. s199``), three times: the default protein run (JTT, CAT 20 rates,
ML NNIs, SH-like supports from 1000 resamples), ``-lg -gamma`` and
``-approxml``.  For each it writes

    tests/data/torch_port_protein_ml_golden_n200_p300[_lg_gamma|_approxml].nwk
        the Newick
    tests/data/torch_port_protein_ml_golden_n200_p300[...].json
        the final LogLk, per-round ML-NNI LogLk and counts, the CAT rates,
        the rough and exact posterior counts and the approximate-posteriors
        share of the stats line, and the run's seconds
    tests/data/torch_port_protein_ml_golden_n200_p300[...]_decisions.json
        every ML NNI decision, in the order the rounds take them: the
        quartet's store rows, the choice and the three criteria

``chip_smoke.py`` (phase 7a) reads them.  Takes several minutes.

Usage: python scripts/make_torch_port_protein_golden.py
"""
from __future__ import annotations

import io
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, P, SEED = 200, 300, 0
DATA = os.path.join(REPO, "tests", "data")
RUNS = {"": {}, "_lg_gamma": {"use_lg": True, "gamma_loglk": True},
        "_approxml": {"exact_ml": False}}
ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")
SHARE = re.compile(r"approximate-posteriors ([\d.]+)%")


def fasta_text(codes) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1}."""
    from veryfasttree_tpu.constants import CODES_STRING_AA

    return "".join(f">s{i}\n{''.join(CODES_STRING_AA[c] for c in row)}\n"
                   for i, row in enumerate(codes))


def parse_log(text: str) -> dict:
    """Per-round ML-NNI LogLk and counts, the final LogLk and the
    approximate-posteriors share of a run's log (the same lines in both
    packages)."""
    rounds = [(float(ll), int(n)) for _, ll, n in ROUND.findall(text)]
    return {"round_loglk": [r[0] for r in rounds],
            "round_nnis": [r[1] for r in rounds],
            "final_loglk": float(FINAL.findall(text)[-1]),
            "approx_share": SHARE.findall(text)[-1]}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bench_e2e import synth_codes
    from veryfasttree_tpu.engine import ml
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    fasta = fasta_text(synth_codes(N, P, seed=SEED, n_codes=20))
    os.makedirs(DATA, exist_ok=True)
    decisions = []
    quartet_nni = ml.ml_quartet_nni

    def logged(nj, rows4, *a):
        out = quartet_nni(nj, rows4, *a)
        decisions.append([[int(r) for r in rows4], int(out[0]),
                          [float(c) for c in out[1]]])
        return out

    ml.ml_quartet_nni = logged
    for suffix, overrides in RUNS.items():
        decisions.clear()
        opts = Options(n_codes=20, show_progress=False, verbose=2,
                       **overrides)
        opts.derive_settings()
        out, log = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        nj, _ = run_pipeline(opts, io.StringIO(fasta), out, log_fp=log)
        seconds = time.perf_counter() - t0
        stem = os.path.join(DATA,
                            f"torch_port_protein_ml_golden_n{N}_p{P}{suffix}")
        with open(stem + ".nwk", "w") as f:
            f.write(out.getvalue())
        meta = {"n": N, "p": P, "seed": SEED, "options": overrides,
                **parse_log(log.getvalue()),
                "n_aa_posterior_rough": nj.debug.n_aa_posterior_rough,
                "n_aa_posterior_exact": nj.debug.n_aa_posterior_exact,
                "tree_loglk": ml.tree_loglk(nj),
                "rates": [float(r) for r in nj.ml.rates_np],
                "seconds": round(seconds, 1)}
        with open(stem + ".json", "w") as f:
            json.dump(meta, f, indent=1)
            f.write("\n")
        with open(stem + "_decisions.json", "w") as f:
            json.dump(decisions, f, separators=(",", ":"))
            f.write("\n")
        print(json.dumps({k: meta[k] for k in (
            "final_loglk", "round_nnis", "approx_share", "seconds")}),
            flush=True)


if __name__ == "__main__":
    main()
