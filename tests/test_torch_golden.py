"""The port on the CPU reproduces the JAX package's committed tree at N=500,
P=500 (tests/data/torch_port_golden_n500_p500.nwk, written by
scripts/make_torch_port_golden.py): the Newick byte-identical, the total
tree length within rtol 1e-12 (float64 sums in different orders)."""
import dataclasses
import io
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from bench_e2e import synth_codes  # noqa: E402
from make_torch_port_golden import (N, P, SEED, STEM, fasta_text,  # noqa: E402
                                    noml_options)

from veryfasttree_tpu_torch.options import Options  # noqa: E402
from veryfasttree_tpu_torch.pipeline import run_pipeline  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The host loops issue tiny ops, on which intra-op threads only
    contend (the N=500 run takes 1.5x longer with 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_reproduces_jax_golden():
    with open(STEM + ".nwk") as f:
        golden = f.read()
    with open(STEM + ".json") as f:
        meta = json.load(f)
    out = io.StringIO()
    # the port's own Options, with the golden run's field values
    opts = Options(**dataclasses.asdict(noml_options()))
    nj, _ = run_pipeline(opts,
                         io.StringIO(fasta_text(synth_codes(N, P, seed=SEED))),
                         out, device=torch.device("cpu"))
    assert out.getvalue() == golden
    assert nj.total_len() == pytest.approx(meta["total_len"], rel=1e-12)
    assert len(nj.join_log) == meta["n_joins"]


def test_port_options_are_the_goldens():
    from veryfasttree_tpu_torch.options import noml_options as port_options

    assert dataclasses.asdict(port_options()) == \
        dataclasses.asdict(noml_options())
    assert port_options(two_tier_min=0).two_tier_min == 0
