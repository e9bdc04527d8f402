#!/usr/bin/env python3
"""How far the SH-like supports of a protein run move with float32
rounding alone, on the CPU.

For each seed, runs the default protein run, ``-lg -gamma`` and
``-approxml`` on ``simulate_alignment(40, 120)`` with the amino-acid
alphabet (the alignments of tests/test_torch_protein_ml*.py) three times:
the JAX package, the port, and the port with its posterior rotations taken
as float32 products (the JAX package's rounding) instead of double sums
rounded once.  Prints, for each run, the RF distances and the largest
support differences on branches at the minimum length (5e-4) and on the
others.

With --lengths, instead: the ML lengths pass and NNI round at 20 codes of
tests/test_torch_protein_ml.py (b) through the JAX package and through the
port with each rotation, and the largest (|port - JAX| - 1e-4) / length of
the branch lengths after each.

Usage: python scripts/compare_protein_supports.py [seed ...]   (default 3 4 7)
       python scripts/compare_protein_supports.py --lengths
"""
from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for sub in ("", "tests"):
    sys.path.insert(0, os.path.join(REPO, sub))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

import torch_protein_runs as runs  # noqa: E402
from util import rf_distance, simulate_alignment, write_fasta  # noqa: E402

from veryfasttree_tpu_torch.ops import kernels  # noqa: E402

FLOOR = 6e-4


def float32_rotations(fn):
    """fn() with the port's posterior rotations as float32 products."""
    orig = kernels._rotate
    kernels._rotate = lambda vec, mat: vec @ mat.T.to(vec.dtype)
    try:
        return fn()
    finally:
        kernels._rotate = orig


def gaps(a, b, floor):
    """The largest support difference between Newicks a and b on branches
    at the minimum length (floor) or off it, by a's lengths."""
    out = [abs(float(x) - float(y))
           for (x, la), (y, _) in zip(runs.SUPPORT.findall(a),
                                      runs.SUPPORT.findall(b))
           if (float(la) <= FLOOR) == floor]
    return max(out, default=0.0)


def main(seeds):
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    worst = {"jax": 0.0, "float32": 0.0, "off": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            fasta = os.path.join(tmp, f"aa{seed}.fasta")
            write_fasta(fasta, simulate_alignment(40, 120, alphabet=runs.AA,
                                                  seed=seed))
            for name, flags in runs.CONFIGS.items():
                nw_j = runs._run(runs.jax_pipeline.run_pipeline, fasta,
                                 flags, runs.jml)[0]
                port = lambda: runs._run(  # noqa: E731
                    runs.torch_pipeline.run_pipeline, fasta, flags,
                    runs.tml, device=cpu)[0]
                nw_t = port()
                nw_32 = float32_rotations(port)
                row = {"jax": gaps(nw_t, nw_j, True),
                       "float32": gaps(nw_t, nw_32, True),
                       "off": max(gaps(nw_t, nw_j, False),
                                  gaps(nw_t, nw_32, False))}
                for k, v in row.items():
                    worst[k] = max(worst[k], v)
                print(f"seed {seed} {name}: RF to the JAX package "
                      f"{rf_distance(nw_t, nw_j)[0]}, to float32 rotations "
                      f"{rf_distance(nw_t, nw_32)[0]}; supports at the "
                      f"minimum length {row['jax']:.3f} from the JAX "
                      f"package's, {row['float32']:.3f} from float32 "
                      f"rotations; elsewhere {row['off']:.3f} at most",
                      flush=True)
    print(f"largest: at the minimum length {worst['jax']:.3f} (JAX package) "
          f"and {worst['float32']:.3f} (float32 rotations); elsewhere "
          f"{worst['off']:.3f}")


def lengths():
    import pathlib

    import numpy as np

    import test_torch_protein_ml as case

    torch.set_num_threads(1)

    def worst(jnj, tnj):
        j, t = jnj.tree.branchlength, tnj.tree.branchlength
        live = j > 0
        return float(np.max((np.abs(t - j)[live] - 1e-4) / j[live]))

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            jnj, tnj = case._engines(pathlib.Path(tmp))
        case.jml.optimize_all_branch_lengths(jnj)
        case.ml_round.ml_lengths_pass(tnj)
        after_pass = worst(jnj, tnj)
        case.ml_round.ml_nni_round(tnj, 0, 1,
                                   case.trearrange.NNIStats.init(tnj))
        case.jrearrange.do_nni(jnj, 0, 1, True,
                               case.jrearrange.NNIStats.init(jnj))
        same = np.array_equal(jnj.tree.parent, tnj.tree.parent)
        return after_pass, worst(jnj, tnj), same

    for label, fn in (("double sums", run),
                      ("float32 products", lambda: float32_rotations(run))):
        p, r, same = fn()
        print(f"port rotations as {label}: (|port - JAX| - 1e-4) / length "
              f"{p:.3e} after the pass, {r:.3e} after the round (the same "
              f"tree: {same})")


if __name__ == "__main__":
    if sys.argv[1:] == ["--lengths"]:
        lengths()
    else:
        main([int(s) for s in sys.argv[1:]] or [3, 4, 7])
