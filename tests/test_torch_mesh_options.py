"""The -noml options of the PyTorch port across two gloo ranks on the CPU
(sp = 2): -two-tier-min 0 (the code-only leaves and the code scan's
partial mode), -fastest (the host join loop without the fused step),
-bionj (the serial ME lengths and split test) on the first 24 sequences
of the dry-run alignment, and protein BLOSUM45 -noml with 100 local
bootstrap resamples (N=30, P=120).  Each rank's Newick byte-identical to
the unsharded port's and to the JAX package's (for protein within one
unit of the fifth decimal: tests/torch_mesh_runs.JAX_TOL), each rank its
block of positions.  One 2-rank world a configuration, all side by side."""
import pytest

import torch_mesh_runs as runs

NAMES = ["two_tier", "fastest", "bionj", "protein"]
WORLDS = [(2, [[1, 2, [name]]]) for name in NAMES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    return out, runs.run_worlds(WORLDS, out, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_option_newick_is_the_unsharded_runs(worlds, name):
    out, single = worlds
    runs.check_runs(out, 1, 2, name, single[name], runs.load_golden())
