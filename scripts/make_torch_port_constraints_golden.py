#!/usr/bin/env python3
"""Write the JAX package's -constraints trees that chip_smoke.py phase 8
holds the PyTorch port to.

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, serial host
loops) on ``chip_smoke.synth_codes(n, 500, seed=0)`` with the sequence
names ``s0 .. s{n-1}`` and the constraint alignment
``chip_smoke.cons_columns(n, 500)`` (16 columns: half following the
founder groups, half random bipartitions, 15% '-'), twice: ``-nt -noml``
at n=500 and the default ``-nt`` run at n=200.  For each it writes

    tests/data/torch_port_constraints_golden_n500_p500.nwk      (-noml)
    tests/data/torch_port_constraints_ml_golden_n200_p500.nwk   (default)
    ... and a .json beside each: the SplitCount, the final LogLk (ML)

Takes a few minutes.

Usage: python scripts/make_torch_port_constraints_golden.py
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

P, SEED, N_COLS = 500, 0, 16
DATA = os.path.join(REPO, "tests", "data")
RUNS = {"torch_port_constraints_golden_n500_p500": (500, {"ml_nni": 0}),
        "torch_port_constraints_ml_golden_n200_p500": (200, {})}
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    os.makedirs(DATA, exist_ok=True)
    for stem, (n, overrides) in RUNS.items():
        fasta = chip_smoke.fasta_text(chip_smoke.synth_codes(n, P, seed=SEED))
        with tempfile.TemporaryDirectory() as tmp:
            cons = os.path.join(tmp, "cons.fasta")
            with open(cons, "w") as f:
                f.write(chip_smoke.cons_fasta(
                    chip_smoke.cons_columns(n, P, N_COLS, SEED)))
            opts = Options(n_codes=4, show_progress=False, n_bootstrap=0
                           if overrides else 1000, constraints_file=cons,
                           **overrides)
            opts.derive_settings()
            out, log = io.StringIO(), io.StringIO()
            _, sc = run_pipeline(opts, io.StringIO(fasta), out, log_fp=log)
        with open(os.path.join(DATA, stem + ".nwk"), "w") as f:
            f.write(out.getvalue())
        final = FINAL.findall(log.getvalue())
        meta = {"n": n, "p": P, "seed": SEED, "n_cols": N_COLS,
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
