"""Shared inputs and runs of the -constraints tests
(tests/test_torch_constraints_*.py) and their goldens
(scripts/make_torch_port_constraints_cpu_golden.py).

The constraint alignment is made from a seed with numpy: half its columns
follow the alignment (the sequences nearest a random pivot by Hamming
distance against the rest, a clade-like split), half are random
bipartitions, and a share of the entries is '-'.  The pipeline runs of
both packages take the same FASTA, constraints and option values.
"""
import dataclasses
import io
import re

import numpy as np

from util import simulate_alignment, write_fasta

PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
# (name, n_seqs, n_pos, seed, n_cons, protein, options) of each pipeline
# run whose JAX half the goldens hold
RUNS = {
    "noml": (60, 250, 21, 12, False, dict(ml_nni=0)),
    "noml_one": (60, 250, 22, 1, False, dict(ml_nni=0)),
    "ml": (60, 250, 23, 12, False, dict()),
    "protein_noml": (60, 200, 24, 12, True, dict(ml_nni=0)),
}


def constraint_columns(seqs, n_cons, seed, gap_frac=0.15):
    """[n_seqs] strings of n_cons '0'/'1'/'-' from numpy's seed."""
    rng = np.random.default_rng(seed)
    codes = np.array([list(s) for s in seqs])
    n = len(seqs)
    cols = []
    for c in range(n_cons):
        if c % 2 == 0:
            pivot = rng.integers(n)
            ham = (codes != codes[pivot]).sum(axis=1)
            k = int(rng.integers(max(2, n // 8), max(3, n // 2)))
            col = np.zeros(n, dtype=int)
            col[np.argsort(ham, kind="stable")[:k]] = 1
        else:
            col = (rng.random(n) < 0.5).astype(int)
        cols.append(col)
    out = np.array(cols).T.astype("<U1")
    out[rng.random(out.shape) < gap_frac] = "-"
    return ["".join(r) for r in out]


def write_inputs(tmp, n, p, seed, n_cons, protein=False):
    """The run's FASTA and constraints under tmp; returns their paths."""
    seqs = simulate_alignment(n, p, seed=seed,
                              **({"alphabet": PROTEIN} if protein else {}))
    fasta, cons = str(tmp / "aln.fasta"), str(tmp / "cons.fasta")
    write_fasta(fasta, seqs)
    write_fasta(cons, constraint_columns(seqs, n_cons, seed))
    return fasta, cons


def options(opts_cls, cons, protein=False, **kw):
    opts = opts_cls(show_progress=False, n_codes=20 if protein else 4,
                    n_bootstrap=0, constraints_file=cons, **kw)
    opts.derive_settings()
    return opts


def run(run_pipeline, opts_cls, fasta, cons, protein=False, **kw):
    """(Newick, join log, SplitCount as a dict, nj, log text) of one run;
    kw: option values, and device for the port."""
    device = kw.pop("device", None)
    opts = options(opts_cls, cons, protein, **kw)
    out, log = io.StringIO(), io.StringIO()
    with open(fasta) as f:
        if device is None:
            nj, sc = run_pipeline(opts, f, out, log)
        else:
            nj, sc = run_pipeline(opts, f, out, log, device=device)
    return (out.getvalue(), list(map(tuple, nj.join_log)),
            dataclasses.asdict(sc), nj, log.getvalue())


FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def final_loglk(log):
    """The final LogLk line's value of an ML run's log, or None."""
    found = FINAL.findall(log)
    return float(found[-1]) if found else None


def golden(name):
    """The JAX package's run `name` (scripts/make_torch_port_constraints_
    cpu_golden.py): (Newick, meta, counts npz)."""
    import json
    import os

    stem = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        f"torch_port_constraints_cpu_{name}")
    with open(stem + ".nwk") as f:
        newick = f.read()
    with open(stem + ".json") as f:
        meta = json.load(f)
    with np.load(stem + ".npz") as z:
        counts = {k: z[k] for k in z.files}
    return newick, meta, counts


def port_run(name, tmp):
    """The port's run `name` on the CPU: (Newick, join log, SplitCount dict,
    nj, log)."""
    import torch

    from veryfasttree_tpu_torch import pipeline
    from veryfasttree_tpu_torch.options import Options

    n, p, seed, n_cons, protein, kw = RUNS[name]
    fasta, cons = write_inputs(tmp, n, p, seed, n_cons, protein)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # the host loops' tiny ops only contend
    try:
        return run(pipeline.run_pipeline, Options, fasta, cons, protein,
                   device=torch.device("cpu"), **kw)
    finally:
        torch.set_num_threads(threads)
