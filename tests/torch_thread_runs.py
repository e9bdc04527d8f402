"""Shared inputs and runs of the -threads pipeline tests
(tests/test_torch_threads_*.py) and their goldens
(scripts/make_torch_port_threads_cpu_golden.py).

Each run takes one FASTA made from a seed (tests/util.simulate_alignment;
protein runs with the amino-acid alphabet), and for the -constraints run
a constraint alignment made from the same seed with numpy
(tests/torch_constraint_runs.py's constraint_columns).  Both packages run
it with the same option values; the JAX package's half is read from the
goldens.
"""
import dataclasses
import io
import json
import os
import re

import numpy as np

from torch_constraint_runs import constraint_columns
from util import simulate_alignment, write_fasta

AA = "ARNDCQEGHILKMFPSTWYV"
# name -> (n_seqs, n_pos, seed, protein, constraint columns, options)
RUNS = {
    "noml": (100, 250, 31, False, 0, dict(ml_nni=0, n_bootstrap=0,
                                          threads=4)),
    "noml_t12": (200, 250, 31, False, 0, dict(ml_nni=0, n_bootstrap=0,
                                              threads=12)),
    "bionj": (80, 250, 32, False, 0, dict(ml_nni=0, n_bootstrap=0,
                                          threads=4, bionj=True)),
    "boot": (80, 250, 33, False, 0, dict(ml_nni=0, n_bootstrap=100,
                                         threads=4)),
    "constraints": (60, 250, 34, False, 12, dict(ml_nni=0, n_bootstrap=0,
                                                 threads=4)),
    "protein_noml": (60, 200, 35, True, 0, dict(ml_nni=0, n_bootstrap=0,
                                                threads=4)),
    "slow": (40, 200, 36, False, 0, dict(ml_nni=0, n_bootstrap=0,
                                         threads=4, slow=True)),
    "ml": (60, 250, 37, False, 0, dict(threads=4)),
    "protein_ml": (40, 120, 5, True, 0, dict(threads=4)),
}
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")
STEM = "torch_port_threads_cpu"
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def write_inputs(tmp, name):
    """The run's FASTA (and constraints, or None) under tmp."""
    n, p, seed, protein, n_cons, _ = RUNS[name]
    seqs = simulate_alignment(n, p, seed=seed,
                              **({"alphabet": AA} if protein else {}))
    fasta = str(tmp / "aln.fasta")
    write_fasta(fasta, seqs)
    cons = None
    if n_cons:
        cons = str(tmp / "cons.fasta")
        write_fasta(cons, constraint_columns(seqs, n_cons, seed))
    return fasta, cons


def run(run_pipeline, opts_cls, name, tmp, **kw):
    """(Newick, SplitCount as a dict, nj, log text) of run `name`; kw: the
    port's device."""
    _, _, _, protein, _, overrides = RUNS[name]
    fasta, cons = write_inputs(tmp, name)
    opts = opts_cls(show_progress=False, n_codes=20 if protein else 4,
                    **({"constraints_file": cons} if cons else {}),
                    **overrides)
    opts.derive_settings()
    out, log = io.StringIO(), io.StringIO()
    with open(fasta) as f:
        nj, sc = run_pipeline(opts, f, out, log, **kw)
    return out.getvalue(), dataclasses.asdict(sc), nj, log.getvalue()


def final_loglk(log):
    found = FINAL.findall(log)
    return float(found[-1]) if found else None


def golden(name):
    """The JAX package's run `name`: (Newick, meta)."""
    stem = os.path.join(DATA, f"{STEM}_{name}")
    with open(stem + ".nwk") as f:
        newick = f.read()
    with open(stem + ".json") as f:
        meta = json.load(f)
    return newick, meta


def port_run(name, tmp):
    """The port's run `name` on the CPU: (Newick, SplitCount dict, nj,
    log)."""
    import torch

    from veryfasttree_tpu_torch import pipeline
    from veryfasttree_tpu_torch.options import Options

    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # the host loops' tiny ops only contend
    try:
        return run(pipeline.run_pipeline, Options, name, tmp,
                   device=torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)


def check_identical(name, tmp):
    """A -noml run: the port's Newick byte-identical to the JAX package's,
    and its SplitCount equal."""
    newick, meta = golden(name)
    nw, sc, _, _ = port_run(name, tmp)
    assert nw == newick, name
    assert {k: float(v) for k, v in sc.items()} == meta["split_count"], name


class Decisions:
    """Records every quartet list of a store class's quartet_nni_rows (the
    batched ML NNI rounds; the JAX package's or the port's) while it is
    entered: log [(rows [K, 4], choice [K], criteria [K, 3])].  Numpy
    only, so that chip_smoke.py and the golden scripts use it too."""

    def __init__(self, store_cls):
        self.cls, self.log = store_cls, []

    def __enter__(self):
        orig = self.orig = self.cls.quartet_nni_rows

        def recorded(store, rows, lengths, *a, **k):
            choice, crit, new_len = orig(store, rows, lengths, *a, **k)
            self.log.append((np.array(rows, dtype=np.int64),
                             np.array(choice, dtype=np.int64),
                             np.array(crit, dtype=np.float64)))
            return choice, crit, new_len

        self.cls.quartet_nni_rows = recorded
        return self

    def __exit__(self, *exc):
        self.cls.quartet_nni_rows = self.orig

    def quartets(self):
        """Every recorded quartet in order: [(rows (4 ints), choice,
        criteria [3] float64)]."""
        return [(tuple(int(r) for r in row), int(c), crit)
                for rows, choice, crits in self.log
                for row, c, crit in zip(rows, choice, crits)]

    def arrays(self):
        return {f"{k}_{i}": a for i, entry in enumerate(self.log)
                for k, a in zip(("rows", "choice", "crit"), entry)}


def golden_decisions(name):
    """The JAX package's batched ML NNI rounds of run `name`, as Decisions
    recorded them."""
    with np.load(os.path.join(DATA, f"{STEM}_{name}.npz")) as z:
        n = len([k for k in z.files if k.startswith("rows_")])
        return [(z[f"rows_{i}"], z[f"choice_{i}"], z[f"crit_{i}"])
                for i in range(n)]


def first_flip(ours, theirs, near_tie):
    """The first quartet the two packages' rounds decide otherwise: None,
    or (round, quartet, the two criteria's margin in each package); raises
    unless it is a near tie in both, or if the rounds' quartets part before
    it."""
    for r, ((rows_a, ch_a, cr_a), (rows_b, ch_b, cr_b)) in enumerate(
            zip(ours, theirs)):
        assert np.array_equal(rows_a, rows_b), f"round {r}: quartets differ"
        for k in np.flatnonzero(ch_a != ch_b):
            margins = [abs(float(c[k, ch_a[k]] - c[k, ch_b[k]]))
                       for c in (cr_a, cr_b)]
            assert max(margins) <= near_tie, (r, int(k), margins)
            return r, int(k), margins
    assert len(ours) == len(theirs)
    return None
