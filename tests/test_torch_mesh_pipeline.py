"""The -noml pipeline of the PyTorch port across ranks (gloo on the CPU),
on the JAX package's multi-chip dry-run alignment (N=40, P=200): sp = 2
and sp = 4, -noml -nosupport and -noml with its local bootstrap.  Every
rank's Newick is byte-identical to the unsharded port's and to the JAX
package's unsharded run, and every rank holds only its block of positions
(tests/torch_mesh_runs.check_runs).  A world of 2 and one of 4 rank
processes (tests/torch_mesh_runs.py) run side by side while the unsharded
port runs here; the JAX package's Newicks are
tests/data/torch_port_mesh_cpu_golden.json
(scripts/make_torch_port_mesh_cpu_golden.py; test_torch_mesh_2x2.py holds
it to a live run)."""
import pytest

import torch_mesh_runs as runs

NAMES = ["noml_nosupport", "noml"]
WORLDS = [(2, [[1, 2, NAMES]]), (4, [[1, 4, NAMES]])]
CASES = [(dp, sp, name) for _, plan in WORLDS for dp, sp, names in plan
         for name in names]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    return out, runs.run_worlds(WORLDS, out, NAMES)


@pytest.mark.parametrize(("dp", "sp", "name"), CASES,
                         ids=[f"{dp}x{sp}-{n}" for dp, sp, n in CASES])
def test_mesh_newick_is_the_unsharded_runs(worlds, dp, sp, name):
    out, single = worlds
    runs.check_runs(out, dp, sp, name, single[name], runs.load_golden())
