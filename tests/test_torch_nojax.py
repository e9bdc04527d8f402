"""The PyTorch port imports no jax, and its command line refuses to run
without a CUDA device.  Each check runs in a fresh interpreter with jax
blocked (sys.modules['jax'] = None makes any import of it fail).
chip_smoke.py imports only the port, bench_e2e and tests/util.py, and
without a CUDA device, or alone in a directory, it fails and prints no
result."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = "import sys; sys.modules['jax'] = None; "


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("module", ["veryfasttree_tpu_torch.pipeline",
                                    "veryfasttree_tpu_torch.cli"])
def test_imports_without_jax(module):
    res = _run(f"import {module}; "
               "assert not [m for m, v in sys.modules.items() "
               "if v is not None and m.split('.')[0] in ('jax', 'jaxlib')]")
    assert res.returncode == 0, res.stderr


def test_every_module_imports_without_jax():
    res = _run("import pkgutil, importlib, veryfasttree_tpu_torch as p; "
               "[importlib.import_module(m.name) for m in "
               "pkgutil.walk_packages(p.__path__, p.__name__ + '.') "
               "if not m.name.endswith('__main__')]")
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
        "numpy", "torch", "veryfasttree_tpu_torch", "bench_e2e", "util"}


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
