#!/usr/bin/env python3
"""Write the JAX package's half of the CPU -threads pipeline tests.

``tests/torch_thread_runs.py`` holds the port's -threads runs against the
JAX package's (``RUNS``: -noml at -threads 4 and 12, under -bionj, with
the local bootstrap, under -constraints, protein BLOSUM45 and -slow; the
default ML run, nucleotide and protein).  This script runs the JAX
package's ``run_pipeline`` on the CPU for each, through the tests' own
``run``, under the settings of ``tests/conftest.py`` (float64 enabled,
eight virtual CPU devices), and writes for each

    tests/data/torch_port_threads_cpu_{name}.nwk   the Newick
    tests/data/torch_port_threads_cpu_{name}.json  the SplitCount, the
        final LogLk (ML)
    tests/data/torch_port_threads_cpu_{name}.npz   (ML runs) every batched
        ML NNI round's quartet list: rows, choices and criteria

and ``tests/data/torch_port_threads_cpu.json``: a SHA-256 over the
sources of ``veryfasttree_tpu/``, ``tests/util.py``,
``tests/torch_constraint_runs.py`` and ``tests/torch_thread_runs.py``
(``source_hash``) and each run's seconds.
``tests/test_torch_threads_partition.py`` recomputes the hash and fails,
naming this script, when any of them has changed since the goldens were
written.

Usage: python scripts/make_torch_port_threads_cpu_golden.py  (about three
minutes)
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
STEM = "torch_port_threads_cpu"
SOURCES = ("util.py", "torch_constraint_runs.py", "torch_thread_runs.py")


def source_hash(repo: str = REPO) -> str:
    """SHA-256 over every source file of veryfasttree_tpu/ and the tests'
    SOURCES (path and bytes, in sorted path order)."""
    paths = [os.path.join("tests", f) for f in SOURCES]
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

    import torch_thread_runs as runs
    from veryfasttree_tpu.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    seconds = {}
    for name in runs.RUNS:
        with tempfile.TemporaryDirectory() as tmp, \
                runs.Decisions(MLProfiles) as decisions:
            t0 = time.perf_counter()
            newick, sc, nj, log = runs.run(run_pipeline, Options, name,
                                           pathlib.Path(tmp))
            seconds[name] = round(time.perf_counter() - t0, 1)
        stem = os.path.join(DATA, f"{STEM}_{name}")
        with open(stem + ".nwk", "w") as f:
            f.write(newick)
        meta = {"split_count": {k: float(v) for k, v in sc.items()},
                "final_loglk": runs.final_loglk(log)}
        with open(stem + ".json", "w") as f:
            json.dump(meta, f)
            f.write("\n")
        if decisions.log:
            np.savez_compressed(stem + ".npz", **decisions.arrays())
        print(name, seconds[name], meta, flush=True)
    with open(os.path.join(DATA, STEM + ".json"), "w") as f:
        json.dump({"source_hash": source_hash(), "seconds": seconds}, f,
                  indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
