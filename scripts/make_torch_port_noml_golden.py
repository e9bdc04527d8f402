#!/usr/bin/env python3
"""Write the JAX package's outputs that the PyTorch port's -noml surface is
held against.

Runs ``veryfasttree_tpu`` on the CPU (float64 accumulation, serial host
loops) on ``bench_e2e.synth_codes(500, 500, seed=0)`` with the sequence
names ``s0 .. s499`` (the input of ``make_torch_port_golden.py``) and
writes

    tests/data/torch_port_noml_golden_n500_p500.nwk    -nt -noml (the ME
        local bootstrap's supports from the default 1000 resamples)
    tests/data/torch_port_noml_golden_n500_p500.json   its suboptimal
        splits and tree length; the SHA-256 and size of -nt -makematrix's
        output; the Newick of -nt -noml -nosupport -intree
        tests/data/torch_port_golden_n500_p500.nwk

``chip_smoke.py`` phase 3 reads them.  It takes a few minutes.

Usage: python scripts/make_torch_port_noml_golden.py
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

N, P, SEED = 500, 500, 0
DATA = os.path.join(REPO, "tests", "data")
STEM = os.path.join(DATA, f"torch_port_noml_golden_n{N}_p{P}")
INTREE = os.path.join(DATA, f"torch_port_golden_n{N}_p{P}.nwk")


def options(**fields):
    from veryfasttree_tpu.options import Options

    return Options(n_codes=4, show_progress=False, ml_nni=0,
                   **fields).derive_settings()


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bench_e2e import synth_codes
    from make_torch_port_golden import fasta_text
    from veryfasttree_tpu.pipeline import run_pipeline

    fasta = fasta_text(synth_codes(N, P, seed=SEED))

    def run(**fields):
        out = io.StringIO()
        nj, _ = run_pipeline(options(**fields), io.StringIO(fasta), out)
        return out.getvalue(), nj

    supports, nj = run()
    matrix, _ = run(make_matrix=True)
    intree, _ = run(n_bootstrap=0, intree_file=INTREE)
    os.makedirs(DATA, exist_ok=True)
    with open(STEM + ".nwk", "w") as f:
        f.write(supports)
    meta = {"n": N, "p": P, "seed": SEED, "n_bootstrap": 1000,
            "total_len": nj.total_len(),
            "n_suboptimal_splits": nj.debug.n_suboptimal_splits,
            "makematrix_sha256": hashlib.sha256(matrix.encode()).hexdigest(),
            "makematrix_bytes": len(matrix.encode()),
            "intree_from": os.path.relpath(INTREE, REPO),
            "intree_newick": intree}
    with open(STEM + ".json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in meta.items() if k != "intree_newick"}))


if __name__ == "__main__":
    main()
