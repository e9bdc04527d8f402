"""-intree and -makematrix in the port against the JAX package, both on the
CPU, each package's options made by its own command-line parser from the
same arguments.

* parse_newick (the port's copy) returns what the JAX package's does:
  trifurcating and bifurcating roots, a multifurcation, single-child
  nodes, duplicate sequences, quoted names and a missing leaf's error;
* -intree from a file and from a NEXUS trees block (-intree *name, with a
  translate table): the Newick byte-identical;
* -nome -mllen -intree: the ML lengths of a fixed topology within the ML
  slice's tolerances (tests/test_torch_ml_slice.py): the same topology,
  the final LogLk within 1e-3, lengths within 1e-4 + 2e-3 x length;
* -makematrix with duplicate sequences, nucleotide (dense and two-tier)
  and protein (BLOSUM45): the matrix byte-identical.
"""
import io
import re

import numpy as np
import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu import cli as jax_cli
from veryfasttree_tpu import pipeline as jax_pipeline
from veryfasttree_tpu_torch import cli as torch_cli
from veryfasttree_tpu_torch import pipeline as torch_pipeline

CPU = torch.device("cpu")
AA = "ACDEFGHIKLMNPQRSTVWY"
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")
LENGTH = re.compile(r":(-?[\d.]+(?:e-?\d+)?)")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(argv, path):
    """The Newick (or matrix) and log of each package on `path`."""
    outs = []
    for cli, run, kw in ((jax_cli, jax_pipeline.run_pipeline, {}),
                         (torch_cli, torch_pipeline.run_pipeline,
                          {"device": CPU})):
        opts = cli.args_to_options(cli.build_parser().parse_args(
            [*argv, "-nopr", path]))
        opts.derive_settings()
        out, log = io.StringIO(), io.StringIO()
        with open(path) as f:
            run(opts, f, out, log_fp=log, **kw)
        outs.append((out.getvalue(), log.getvalue()))
    return outs


def _random_tree(names, rng):
    """A random rooted binary Newick over `names`, with lengths and
    bootstrap labels (which the reader skips)."""
    nodes = list(names)
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b = nodes.pop(j)
        a = nodes.pop(i)
        nodes.append(f"({a}:{rng.random():.3f},{b}:{rng.random():.3f})"
                     f"{rng.integers(50, 100)}")
    return nodes[0] + ";"


# ----------------------------------------------------------- parse_newick
def _uniq(pkg, names, seqs):
    import importlib

    aln_mod = importlib.import_module(f"{pkg}.io.alignment")
    return aln_mod.Uniquify.build(aln_mod.Alignment(
        names=names, seqs=seqs, n_pos=len(seqs[0])))


NAMES = ["s0", "s1", "s2", "s3", "s4", "s5", "'q_6'"]
SEQS = ["ACGTA", "ACGTT", "AGGTT", "TCGTA", "ACGTT", "CCCTA", "GGGTA"]


@pytest.mark.parametrize("text,fails", [
    ("(s0:0.1,s1:0.2,((s2:0.1,s3:0.1)0.9:0.05,(s5,'q_6'),s4));", False),
    ("((s0,s1)77:0.1,((s2,s3),(s5,('q_6',s4))));", False),
    ("(s0,s1,(s2,s3,s5,'q_6',s4));", False),
    ("((s0),s1,((s2,s3),s5),('q_6',s4));", False),
    ("((s0,s4),(s1,s2),(s3,(s5,'q_6')));", False),
    ("((s0,s1),(s2,s3));", True),
], ids=["trifurcating", "bifurcating", "multifurcation", "single-child",
        "duplicate", "missing-leaf"])
def test_parse_newick_matches_jax(text, fails):
    """s4 repeats s1's sequence: the reader keeps the first of them it
    meets; 'q_6' is a quoted name; the last tree leaves out s4 .. q_6."""
    from veryfasttree_tpu.io.newick import parse_newick as jparse
    from veryfasttree_tpu_torch.io.newick import parse_newick as tparse

    name_to_idx = {n: i for i, n in enumerate(NAMES)}
    results = []
    for pkg, parse in (("veryfasttree_tpu", jparse),
                       ("veryfasttree_tpu_torch", tparse)):
        try:
            results.append(parse(text, name_to_idx, _uniq(pkg, NAMES, SEQS)))
        except ValueError as err:
            results.append(("ValueError", str(err)))
    assert results[1] == results[0]
    assert (results[0][0] == "ValueError") == fails


# ----------------------------------------------------------------- -intree
@pytest.mark.parametrize("argv", [["-nt", "-noml", "-boot", "100"],
                                  ["-nt", "-noml", "-nosupport",
                                   "-two-tier-min", "0"]],
                         ids=["supports", "two-tier"])
def test_intree_file_identical_to_jax(tmp_path, argv):
    seqs = simulate_alignment(36, 180, seed=9)
    seqs[7] = seqs[3]                           # a duplicate sequence
    names = [f"seq{i:05d}" for i in range(len(seqs))]
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, seqs)
    tree = tmp_path / "start.nwk"
    tree.write_text(_random_tree(names, np.random.default_rng(4)) + "\n")
    (nw_j, _), (nw_t, _) = _run_both([*argv, "-intree", str(tree)], fasta)
    assert nw_t == nw_j
    assert nw_t.count("seq") == len(seqs)


def test_intree_nexus_identical_to_jax(tmp_path):
    """-intree *tree2: the second tree of the NEXUS file's trees block,
    its leaves numbered through a translate table."""
    seqs = simulate_alignment(30, 150, seed=12)
    names = [f"t{i}" for i in range(len(seqs))]
    rng = np.random.default_rng(8)
    trees = [_random_tree([str(i + 1) for i in range(len(seqs))], rng)
             for _ in range(2)]
    text = ("#NEXUS\nbegin data;\n"
            f"  dimensions ntax={len(seqs)} nchar={len(seqs[0])};\n"
            "  format datatype=dna gap=-;\n  matrix\n"
            + "".join(f"    {n} {s}\n" for n, s in zip(names, seqs))
            + "  ;\nend;\nbegin trees;\n  translate\n"
            + "".join(f"    {i + 1} {n},\n" for i, n in enumerate(names))
            + "  ;\n"
            + "".join(f"  tree tree{k + 1} = {t}\n"
                      for k, t in enumerate(trees))
            + "end;\n")
    path = str(tmp_path / "t.nex")
    with open(path, "w") as f:
        f.write(text)
    (nw_j, _), (nw_t, _) = _run_both(
        ["-nt", "-noml", "-nosupport", "-intree", "*tree2"], path)
    assert nw_t == nw_j
    assert nw_t.count("t") >= len(seqs)


def test_nome_mllen_intree_matches_jax(tmp_path):
    """ML lengths (and ML NNIs) from a fixed starting topology, no ME."""
    seqs = simulate_alignment(20, 200, seed=8)
    names = [f"seq{i:05d}" for i in range(len(seqs))]
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, seqs)
    tree = tmp_path / "start.nwk"
    tree.write_text(_random_tree(names, np.random.default_rng(2)) + "\n")
    (nw_j, log_j), (nw_t, log_t) = _run_both(
        ["-nt", "-nome", "-mllen", "-nosupport", "-intree", str(tree)],
        fasta)
    assert LENGTH.sub("", nw_t) == LENGTH.sub("", nw_j)
    assert abs(float(FINAL.findall(log_t)[-1])
               - float(FINAL.findall(log_j)[-1])) <= 1e-3 + 1e-9
    lens_t = [float(x) for x in LENGTH.findall(nw_t)]
    lens_j = [float(x) for x in LENGTH.findall(nw_j)]
    assert len(lens_t) == len(lens_j) == 2 * len(seqs) - 3
    for a, b in zip(lens_t, lens_j):
        assert abs(a - b) <= 1e-4 + 2e-3 * b


# ------------------------------------------------------------- -makematrix
@pytest.mark.parametrize("argv,alphabet", [
    (["-nt"], "ACGT"), (["-nt", "-two-tier-min", "0"], "ACGT"), ([], AA)],
    ids=["nt", "nt-two-tier", "protein"])
def test_makematrix_identical_to_jax(tmp_path, argv, alphabet):
    """Every sequence's row, duplicates included (the port reads the
    alignment without uniquifying it)."""
    seqs = simulate_alignment(14, 90, alphabet=alphabet, seed=3)
    seqs = seqs + seqs[:3]
    fasta = str(tmp_path / "m.fasta")
    write_fasta(fasta, seqs)
    (m_j, _), (m_t, _) = _run_both([*argv, "-makematrix"], fasta)
    assert m_t == m_j
    assert len(m_t.splitlines()) == len(seqs)
