"""The -noml pipeline of the PyTorch port on a dp = 2 x sp = 2 mesh of
gloo ranks on the CPU (the pipeline's store is replicated along dp), on
the JAX package's multi-chip dry-run alignment: -noml -nosupport and
-noml, each rank's Newick byte-identical to the unsharded port's and the
JAX package's (tests/torch_mesh_runs.check_runs); and the JAX package's
golden (tests/data/torch_port_mesh_cpu_golden.json) held to a live run of
the JAX package, and to the configurations' inputs."""
import io

import pytest

import torch_mesh_runs as runs

NAMES = ["noml_nosupport", "noml"]
WORLDS = [(4, [[2, 2, NAMES]])]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    return out, runs.run_worlds(WORLDS, out, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_2x2_newick_is_the_unsharded_runs(worlds, name):
    out, single = worlds
    runs.check_runs(out, 2, 2, name, single[name], runs.load_golden())


def test_golden_is_live():
    from veryfasttree_tpu.options import Options
    from veryfasttree_tpu.pipeline import run_pipeline

    golden = runs.load_golden()
    assert set(golden) == set(runs.CONFIGS)
    for name in runs.CONFIGS:
        assert golden[name]["key"] == runs.key(name), name
    out = io.StringIO()
    run_pipeline(runs.options("noml_nosupport", Options),
                 io.StringIO(runs.fasta("nt")), out, log_fp=None)
    assert out.getvalue() == golden["noml_nosupport"]["newick"]
