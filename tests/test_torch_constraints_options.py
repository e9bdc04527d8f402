"""-constraints through the port's options, command line and reader, on
the CPU.

* A heavily weighted constraint's split is in the tree (the port's form of
  tests/test_options_parity.py test_constraints): -constraints and
  -constraintWeight through the command line's parser, at 4 and 20 codes,
  with and without -noml.
* The reader (pipeline.read_constraints, ref alnToConstraints): a file of
  fewer than 4 sequences is ignored with a warning; a second sequence of a
  unique group that disagrees with the first is ignored with a warning;
  a name not in the alignment raises.
* The goldens of the pipeline tests (test_torch_constraints_{noml,
  noml_one,ml,protein}.py) were written from the current JAX package.
"""
import io
import json
import os
import sys

import pytest
import torch

from util import newick_splits, simulate_alignment, write_fasta

from veryfasttree_tpu_torch import cli
from veryfasttree_tpu_torch import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(argv, fasta):
    """The port's run of the command line argv on fasta, on the CPU:
    (Newick, nj, log text)."""
    opts = cli.args_to_options(cli.build_parser().parse_args(
        [*argv, "-nopr", fasta]))
    opts.derive_settings()
    out, log = io.StringIO(), io.StringIO()
    with open(fasta) as f:
        nj, _ = pipeline.run_pipeline(opts, f, out, log,
                                      device=torch.device("cpu"))
    return out.getvalue().strip(), nj, log.getvalue()


@pytest.mark.parametrize("flags,alphabet", [
    (["-nt", "-noml", "-nosupport"], "ACGT"), (["-nt", "-nosupport"], "ACGT"),
    (["-noml", "-nosupport"], AA), (["-nosupport"], AA)],
    ids=["noml", "ml", "protein-noml", "protein-ml"])
def test_heavy_constraint_split_is_in_the_tree(tmp_path, flags, alphabet):
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(16, 150, alphabet=alphabet,
                                          seed=47))
    cons = tmp_path / "cons.fasta"
    cons.write_text("".join(f">seq{i:05d}\n{'1' if i < 8 else '0'}\n"
                            for i in range(16)))
    nw, nj, _ = _run([*flags, "-notop", "-spr", "0", "-constraints",
                      str(cons), "-constraintWeight", "1000"], fasta)
    assert nj.n_cons == 1 and nj.options.constraint_weight == 1000.0
    splits, leaves = newick_splits(nw)
    want_a = frozenset(f"seq{i:05d}" for i in range(8))
    want = min(want_a, leaves - want_a, key=lambda s: (len(s), sorted(s)))
    assert want in splits, "constrained split not present in tree"


def _inputs(tmp_path, cons_text, n=12):
    fasta = str(tmp_path / "t.fasta")
    seqs = simulate_alignment(n, 120, seed=5)
    seqs[1] = seqs[0]                  # seq00001 shares seq00000's group
    write_fasta(fasta, seqs)
    cons = tmp_path / "cons.fasta"
    cons.write_text(cons_text)
    return fasta, str(cons)


def test_fewer_than_four_constraint_sequences_are_ignored(tmp_path, capsys):
    fasta, cons = _inputs(tmp_path, ">seq00000\n1\n>seq00002\n0\n"
                          ">seq00003\n1\n")
    nw, nj, log = _run(["-nt", "-noml", "-nosupport", "-constraints", cons],
                       fasta)
    assert nj.n_cons == 0 and nw
    assert "constraints file with less than 4 sequences ignored" in log


def test_a_conflicting_duplicate_is_ignored(tmp_path):
    text = "".join(f">seq{i:05d}\n{'10'[i % 2]}1\n" for i in range(12))
    fasta, cons = _inputs(tmp_path, text)
    _, nj, log = _run(["-nt", "-noml", "-nosupport", "-constraints", cons],
                      fasta)
    assert nj.n_cons == 2
    assert "Warning: ignoring constraints for seq00001" in log
    # the unique group keeps its first sequence's constraints
    assert nj.con_on[0].tolist() == [1, 1]
    assert nj.con_off[0].tolist() == [0, 0]


def test_an_unknown_name_raises(tmp_path):
    text = "".join(f">seq{i:05d}\n1\n" for i in range(5)) + ">stranger\n0\n"
    fasta, cons = _inputs(tmp_path, text)
    with pytest.raises(ValueError, match="stranger from constraints file is "
                                         "not in the alignment"):
        _run(["-nt", "-noml", "-nosupport", "-constraints", cons], fasta)


def test_goldens_are_current():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_port_constraints_cpu_golden import source_hash

    with open(os.path.join(REPO, "tests", "data",
                           "torch_port_constraints_cpu.json")) as f:
        meta = json.load(f)
    assert meta["source_hash"] == source_hash(), (
        "veryfasttree_tpu/, tests/util.py or tests/torch_constraint_runs.py "
        "changed since the -constraints goldens were written: rerun "
        "python scripts/make_torch_port_constraints_cpu_golden.py")
