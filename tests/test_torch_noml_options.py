"""The -noml option matrix of the port against the JAX package, both on the
CPU, each package's options made by its own command-line parser from the
same arguments: -slow, -fastest, -2nd, -notop, -pseudo and protein
(BLOSUM45) -noml.  The join log equal and the Newick byte-identical; no
tolerance, as for the default run in tests/test_torch_slice.py.
"""
import io

import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu import cli as jax_cli
from veryfasttree_tpu import pipeline as jax_pipeline
from veryfasttree_tpu_torch import cli as torch_cli
from veryfasttree_tpu_torch import pipeline as torch_pipeline

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cli, run, argv, path, **kw):
    opts = cli.args_to_options(cli.build_parser().parse_args(
        [*argv, "-nopr", path]))
    opts.derive_settings()
    out = io.StringIO()
    with open(path) as f:
        nj, _ = run(opts, f, out, **kw)
    return out.getvalue(), list(nj.join_log)


# -slow compares every pair at each join: a smaller N keeps it to seconds
@pytest.mark.parametrize("flags,n,p,alphabet", [
    (["-nt", "-slow"], 30, 200, "ACGT"),
    (["-nt", "-fastest"], 60, 240, "ACGT"),
    (["-nt", "-2nd"], 60, 240, "ACGT"),
    (["-nt", "-notop"], 60, 240, "ACGT"),
    (["-nt", "-pseudo"], 60, 240, "ACGT"),
    ([], 40, 200, AA),
], ids=["slow", "fastest", "2nd", "notop", "pseudo", "protein-blosum45"])
def test_noml_option_identical_to_jax(tmp_path, flags, n, p, alphabet):
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(n, p, alphabet=alphabet, seed=11))
    argv = [*flags, "-noml", "-nosupport"]
    nw_j, joins_j = _run(jax_cli, jax_pipeline.run_pipeline, argv, fasta)
    nw_t, joins_t = _run(torch_cli, torch_pipeline.run_pipeline, argv, fasta,
                         device=torch.device("cpu"))
    assert len(joins_t) == n - 3
    assert joins_t == joins_j
    assert nw_t == nw_j
