"""The PyTorch port imports neither jax nor the JAX package, and its command
line refuses to run without a CUDA device.  Each import check runs in a
fresh interpreter with both blocked (sys.modules['jax'] = None and
sys.modules['veryfasttree_tpu'] = None make any import of them fail).
chip_smoke.py imports only the port and the numpy helpers tests/util.py
and tests/torch_thread_runs.py, and without a CUDA device, or alone in a
directory, it fails and prints no result.

What the port shares with the JAX package it keeps as copies (constants,
options, the model matrices, the Newick printer and reader, the tree
partitioning of the -threads SPR rounds, the command-line parser); these
must equal their originals: the constants and matrices exactly, Options'
fields and defaults (the seed's default is the clock), the Newick
functions' and tree_partitioning's source, and the options that
args_to_options makes of a few command lines (-threads 4 among them).
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = ("import sys; sys.modules['jax'] = None; "
         "sys.modules['veryfasttree_tpu'] = None; ")
NOT_LOADED = ("assert not [m for m, v in sys.modules.items() if v is not None "
              "and m.split('.')[0] in ('jax', 'jaxlib', 'veryfasttree_tpu')]")


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", BLOCK + code, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("module", ["veryfasttree_tpu_torch.pipeline",
                                    "veryfasttree_tpu_torch.cli",
                                    "veryfasttree_tpu_torch.ops.dataflow",
                                    "veryfasttree_tpu_torch.engine.supports",
                                    "veryfasttree_tpu_torch.io.newick",
                                    "veryfasttree_tpu_torch.engine.checkpoint",
                                    "veryfasttree_tpu_torch.engine.fused",
                                    "veryfasttree_tpu_torch.ops.join_kernels",
                                    "veryfasttree_tpu_torch.utils.trace",
                                    "veryfasttree_tpu_torch.parallel",
                                    "veryfasttree_tpu_torch.parallel.mesh",
                                    "veryfasttree_tpu_torch.parallel.multihost",
                                    "veryfasttree_tpu_torch.parallel.sharded"])
def test_imports_without_jax(module):
    res = _run(f"import {module}; {NOT_LOADED}")
    assert res.returncode == 0, res.stderr


def test_every_module_imports_without_jax():
    res = _run("import pkgutil, importlib, veryfasttree_tpu_torch as p; "
               "[importlib.import_module(m.name) for m in "
               "pkgutil.walk_packages(p.__path__, p.__name__ + '.') "
               f"if not m.name.endswith('__main__')]; {NOT_LOADED}")
    assert res.returncode == 0, res.stderr


def test_smoke_imports_without_jax():
    """chip_smoke.py and everything it imports from the port and the tests'
    helpers, with jax and the JAX package blocked."""
    res = _run("sys.path[:0] = ['.', 'tests']; import chip_smoke, util, "
               "torch_thread_runs; "
               "chip_smoke.wrappers(); "
               "from veryfasttree_tpu_torch.options import ml_options, "
               "noml_options; "
               "from veryfasttree_tpu_torch.pipeline import run_pipeline; "
               "from veryfasttree_tpu_torch.models import DistanceMatrix, "
               f"TransitionMatrix; {NOT_LOADED}")
    assert res.returncode == 0, res.stderr


def test_cli_raises_without_cuda(tmp_path):
    fasta = tmp_path / "t.fasta"
    fasta.write_text(">a\nACGT\n>b\nACGA\n>c\nACTT\n>d\nTCGT\n")
    res = _run("import torch; torch.cuda.is_available = lambda: False; "
               "sys.argv[0] = 'veryfasttree_tpu_torch'; "
               "from veryfasttree_tpu_torch.cli import main; "
               "sys.exit(main(sys.argv[1:]))",
               "-nt", "-noml", "-nosupport", str(fasta))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""


def test_smoke_imports_only_the_port():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    top = {alias.name.split(".")[0] for node in ast.walk(tree)
           if isinstance(node, ast.Import) for alias in node.names}
    top |= {node.module.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom)}
    assert top - sys.stdlib_module_names == {
        "numpy", "torch", "veryfasttree_tpu_torch", "util",
        "torch_thread_runs"}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_fails_without_cuda(tmp_path, where):
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    script = os.path.join(REPO if where == "repo" else str(tmp_path),
                          "chip_smoke.py")
    res = _run("import runpy, torch; "
               "torch.cuda.is_available = lambda: False; "
               "sys.argv = [sys.argv[1]]; "
               "runpy.run_path(sys.argv[0], run_name='__main__')", script)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout


# ------------------------------------------------- copies equal originals
def _public(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and not k.startswith("_")}


def _same_arrays(a, b):
    """Every array attribute of two objects equal, names and all."""
    fields = lambda o: {k: v for k, v in vars(o).items()  # noqa: E731
                        if isinstance(v, np.ndarray)}
    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys() and fa
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        assert fa[k].dtype == fb[k].dtype, k


def _copy_constants():
    from veryfasttree_tpu import constants as j
    from veryfasttree_tpu_torch import constants as t
    assert _public(t) == _public(j)


def _copy_matrices_data():
    from veryfasttree_tpu.models import _matrices_data as j
    from veryfasttree_tpu_torch.models import _matrices_data as t
    arrays = lambda m: {k: v for k, v in vars(m).items()  # noqa: E731
                        if isinstance(v, np.ndarray)}
    pj, pt = arrays(j), arrays(t)
    assert pj.keys() == pt.keys() and pj
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
        assert pt[k].dtype == pj[k].dtype, k


def _copy_models():
    from veryfasttree_tpu import models as j
    from veryfasttree_tpu_torch import models as t
    gtr = ([1.2, 3.1, 0.8, 1.1, 2.9, 1.0], [0.3, 0.2, 0.24, 0.26])
    for name, args in (("jtt92", ()), ("wag01", ()), ("lg08", ()),
                       ("gtr", gtr)):
        _same_arrays(getattr(t.TransitionMatrix, name)(*args),
                     getattr(j.TransitionMatrix, name)(*args))
    _same_arrays(t.DistanceMatrix.blosum45(), j.DistanceMatrix.blosum45())
    _same_arrays(
        t.DistanceMatrix.from_transition_matrix(t.TransitionMatrix.jtt92()),
        j.DistanceMatrix.from_transition_matrix(j.TransitionMatrix.jtt92()))


def _copy_options():
    from veryfasttree_tpu.options import Options as J
    from veryfasttree_tpu_torch.options import Options as T
    fj, ft = dataclasses.fields(J), dataclasses.fields(T)
    assert [f.name for f in ft] == [f.name for f in fj]
    for a, b in zip(ft, fj):
        assert a.default == b.default, a.name
        assert (a.default_factory is dataclasses.MISSING) == \
            (b.default_factory is dataclasses.MISSING), a.name
    for precision in (False, True):
        j, t = J(seed=1, double_precision=precision), \
            T(seed=1, double_precision=precision)
        assert dataclasses.asdict(t.derive_settings()) == \
            dataclasses.asdict(j.derive_settings())


ARGV = [
    ["-nt", "-seed", "1", "aln.fasta"],
    ["-nt", "-noml", "-nosupport", "-quiet", "-seed", "7", "aln.fasta"],
    ["-nt", "-gtr", "-gamma", "-mllen", "-boot", "100", "-seed", "3",
     "-out", "tree.nwk", "aln.fasta"],
    ["-gtrrates", "1", "2", "1", "1", "2", "1", "-gtrfreq", "0.2", "0.3",
     "0.3", "0.2", "-cat", "8", "-spr", "4", "-mlacc", "2", "-seed", "5",
     "-threads", "1", "-two-tier-min", "0", "-"],
    ["-fastest", "-no2nd", "-pseudo", "-nj", "-nome", "-seed", "9",
     "-close", "0.5", "-refresh", "0.7", "aln.phy"],
    ["-nt", "-noml", "-threads", "4", "-seed", "2", "aln.fasta"],
]


def _copy_newick():
    """The printer and the reader of -intree, function by function."""
    import inspect

    from veryfasttree_tpu.io import newick as j
    from veryfasttree_tpu_torch.io import newick as t
    for name in ("quote_name", "print_newick", "tokenize_newick",
                 "parse_newick"):
        assert inspect.getsource(getattr(t, name)) == \
            inspect.getsource(getattr(j, name)), name


def _copy_partition():
    """engine/partition.py: tree_partitioning's source."""
    import inspect

    from veryfasttree_tpu.engine import partition as j
    from veryfasttree_tpu_torch.engine import partition as t
    assert inspect.getsource(t.tree_partitioning) == \
        inspect.getsource(j.tree_partitioning)


def _copy_parser():
    from veryfasttree_tpu import cli as j
    from veryfasttree_tpu_torch import cli as t
    for argv in ARGV:
        assert dataclasses.asdict(
            t.args_to_options(t.build_parser().parse_args(argv))) == \
            dataclasses.asdict(
                j.args_to_options(j.build_parser().parse_args(argv))), argv


@pytest.mark.parametrize("check", [_copy_constants, _copy_matrices_data,
                                   _copy_models, _copy_options, _copy_newick,
                                   _copy_partition, _copy_parser],
                         ids=lambda f: f.__name__[len("_copy_"):])
def test_copy_equals_original(check):
    check()


def test_smoke_input_equals_bench_input():
    """chip_smoke.synth_codes is a copy of bench_e2e.synth_codes."""
    sys.path.insert(0, REPO)
    import bench_e2e
    import chip_smoke
    for args in ((2000, 500), (200, 500, 0), (60, 77, 3, 20)):
        np.testing.assert_array_equal(chip_smoke.synth_codes(*args),
                                      bench_e2e.synth_codes(*args))
