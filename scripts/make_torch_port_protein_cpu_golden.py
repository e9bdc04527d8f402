#!/usr/bin/env python3
"""Write the JAX package's half of the CPU protein pipeline tests.

``tests/torch_protein_runs.py`` holds the port's protein runs against the
JAX package's on ``simulate_alignment(40, 120, alphabet=AA, seed=s)``: the
default run, ``-lg -gamma`` and ``-approxml`` (``CONFIGS``) at seeds 5
(``tests/test_torch_protein_ml_*.py``) and 3
(``tests/test_torch_protein_ml_agree_*.py``).  This script runs the JAX
package's ``run_pipeline`` on the CPU for each of those six pairs, through
the tests' own ``_run`` (verbose 2, every ML NNI decision logged), under
the settings of ``tests/conftest.py`` (float64 enabled, eight virtual CPU
devices), and writes for each

    tests/data/torch_port_protein_cpu_s{seed}_{config}.nwk   the Newick
    tests/data/torch_port_protein_cpu_s{seed}_{config}.log   the verbose-2 log
    tests/data/torch_port_protein_cpu_s{seed}_{config}.npz   rows [K, 4],
        choice [K], criteria [K, 3] (float64) of every decision, and the
        rough/exact posterior counts
    tests/data/torch_port_protein_cpu_s{seed}_{config}_decisions.txt
        the same decisions as text

and ``tests/data/torch_port_protein_cpu.json``: a SHA-256 over the
sources of ``veryfasttree_tpu/`` and ``tests/util.py`` (``source_hash``)
and each run's seconds.  ``tests/test_torch_protein_ml.py`` recomputes the
hash and fails, naming this script, when the JAX package or the alignment
generator has changed since the goldens were written.

XLA's CPU build may round float32 sums otherwise on another CPU, so write
the goldens on the kind of host the tests run on.

Usage: python scripts/make_torch_port_protein_cpu_golden.py  (a few minutes)
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
STEM = "torch_port_protein_cpu"
SEEDS = (5, 3)


def source_hash(repo: str = REPO) -> str:
    """SHA-256 over every source file of veryfasttree_tpu/ and tests/util.py
    (path and bytes, in sorted path order)."""
    paths = [os.path.join("tests", "util.py")]
    for root, dirs, files in os.walk(os.path.join(repo, "veryfasttree_tpu")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        paths += [os.path.relpath(os.path.join(root, f), repo)
                  for f in files if not f.endswith((".pyc", ".pyo"))]
    h = hashlib.sha256()
    for rel in sorted(paths):
        h.update(rel.replace(os.sep, "/").encode() + b"\0")
        with open(os.path.join(repo, rel), "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    return h.hexdigest()


def golden_stem(seed: int, name: str) -> str:
    return os.path.join(DATA, f"{STEM}_s{seed}_{name.replace('-', '_')}")


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from torch_protein_runs import AA, CONFIGS, _run
    from util import simulate_alignment, write_fasta

    from veryfasttree_tpu import pipeline
    from veryfasttree_tpu.engine import ml

    meta = {"source_hash": source_hash(),
            "command": "python scripts/make_torch_port_protein_cpu_golden.py",
            "seconds": {}}
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for seed in SEEDS:
            fasta = os.path.join(tmp, f"aa{seed}.fasta")
            write_fasta(fasta, simulate_alignment(40, 120, alphabet=AA,
                                                  seed=seed))
            for name, flags in CONFIGS.items():
                t0 = time.perf_counter()
                newick, log, aa, decisions = _run(pipeline.run_pipeline,
                                                  fasta, flags, ml)
                seconds = time.perf_counter() - t0
                stem = golden_stem(seed, name)
                with open(stem + ".nwk", "w") as f:
                    f.write(newick)
                with open(stem + ".log", "w") as f:
                    f.write(log)
                np.savez(stem + ".npz",
                         rows=np.array([d[0] for d in decisions],
                                       dtype=np.int64).reshape(-1, 4),
                         choice=np.array([d[1] for d in decisions],
                                         dtype=np.int64),
                         criteria=np.array([d[2] for d in decisions],
                                           dtype=np.float64).reshape(-1, 3),
                         aa=np.array(aa, dtype=np.int64))
                with open(stem + "_decisions.txt", "w") as f:
                    f.write("# rows choice criteria (float64)\n")
                    for rows, choice, crit in decisions:
                        f.write(" ".join(map(str, rows)) + f" {choice} "
                                + " ".join(repr(float(c)) for c in crit)
                                + "\n")
                meta["seconds"][f"s{seed}_{name}"] = round(seconds, 1)
                print(f"seed {seed} {name}: {len(decisions)} decisions, "
                      f"{seconds:.1f} s", flush=True)
    meta["seconds"]["total"] = round(time.perf_counter() - t_all, 1)
    with open(os.path.join(DATA, STEM + ".json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps(meta["seconds"]))


if __name__ == "__main__":
    main()
