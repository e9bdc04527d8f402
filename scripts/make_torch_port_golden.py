#!/usr/bin/env python3
"""Write the JAX package's tree that the PyTorch port is held against.

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, serial host
loops, ``-nt -noml -nosupport``) on ``bench_e2e.synth_codes(500, 500,
seed=0)`` with the sequence names ``s0 .. s499`` and writes

    tests/data/torch_port_golden_n500_p500.nwk    the Newick
    tests/data/torch_port_golden_n500_p500.json   total tree length, joins

``chip_smoke.py`` and ``tests/test_torch_slice.py`` read them.

Usage: python scripts/make_torch_port_golden.py
"""
from __future__ import annotations

import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, P, SEED = 500, 500, 0
DATA = os.path.join(REPO, "tests", "data")
STEM = os.path.join(DATA, f"torch_port_golden_n{N}_p{P}")


def fasta_text(codes) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1} (as bench.py)."""
    from bench_e2e import ALPHA

    lines = []
    for i, row in enumerate(codes):
        lines.append(f">s{i}")
        lines.append("".join(ALPHA[c] for c in row))
    return "\n".join(lines) + "\n"


def noml_options():
    from veryfasttree_tpu.options import Options

    opts = Options(n_codes=4, show_progress=False, ml_nni=0, n_bootstrap=0)
    return opts.derive_settings()


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bench_e2e import synth_codes
    from veryfasttree_tpu.pipeline import run_pipeline

    out = io.StringIO()
    nj, _ = run_pipeline(noml_options(),
                         io.StringIO(fasta_text(synth_codes(N, P, seed=SEED))),
                         out)
    os.makedirs(DATA, exist_ok=True)
    with open(STEM + ".nwk", "w") as f:
        f.write(out.getvalue())
    meta = {"n": N, "p": P, "seed": SEED, "total_len": nj.total_len(),
            "n_joins": len(nj.join_log)}
    with open(STEM + ".json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
