#!/usr/bin/env python3
"""Write the JAX package's trees that the PyTorch port's -fastest and -2nd
runs are held against (their joins take the host join loop's fused step,
veryfasttree_tpu_torch/engine/fused.py).

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, serial host
loops, its fused join on) on ``bench_e2e.synth_codes(500, 500, seed=0)``
with the sequence names ``s0 .. s499`` (the input of
``make_torch_port_golden.py``) and writes, for each mode,

    tests/data/torch_port_<mode>_golden_n500_p500.nwk    -nt -noml -nosupport
        -fastest, or -2nd
    tests/data/torch_port_fastest_golden_n500_p500.json  each mode's options,
        joins, tree length and debug counters

``chip_smoke.py`` phase 10(b) reads them.  It takes a few minutes.

Usage: python scripts/make_torch_port_fastest_golden.py
"""
from __future__ import annotations

import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

N, P, SEED = 500, 500, 0
DATA = os.path.join(REPO, "tests", "data")
MODES = {"fastest": {"fastest": True}, "2nd": {"use_tophits_2nd": True}}
COUNTERS = ("outprofile_ops", "profile_ops", "seq_ops", "profile_avg_ops",
            "n_hill_better", "n_visible_update", "n_refresh_tophits")


def stem(mode: str) -> str:
    return os.path.join(DATA, f"torch_port_{mode}_golden_n{N}_p{P}")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bench_e2e import synth_codes
    from make_torch_port_golden import fasta_text
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    fasta = fasta_text(synth_codes(N, P, seed=SEED))
    meta = {"n": N, "p": P, "seed": SEED, "modes": {}}
    for mode, fields in MODES.items():
        opts = Options(n_codes=4, show_progress=False, ml_nni=0,
                       n_bootstrap=0, **fields).derive_settings()
        out = io.StringIO()
        nj, _ = run_pipeline(opts, io.StringIO(fasta), out)
        with open(stem(mode) + ".nwk", "w") as f:
            f.write(out.getvalue())
        meta["modes"][mode] = {
            "options": fields, "joins": len(nj.join_log),
            "total_len": nj.total_len(),
            "counters": {k: getattr(nj.debug, k) for k in COUNTERS}}
    os.makedirs(DATA, exist_ok=True)
    with open(stem("fastest") + ".json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
