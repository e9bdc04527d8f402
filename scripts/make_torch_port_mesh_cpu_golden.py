"""Write tests/data/torch_port_mesh_cpu_golden.json: the JAX package's
unsharded Newick of each configuration of tests/torch_mesh_runs.py (the
multi-GPU port's CPU tests hold every mesh shape's Newick to it), with
the SHA-256 of each configuration's input and fields.  JAX on the CPU,
about a minute.  Rerun it when the JAX package or tests/torch_mesh_runs.py
change.

    python scripts/make_torch_port_mesh_cpu_golden.py
"""
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch_mesh_runs as runs  # noqa: E402
from veryfasttree_tpu.options import Options  # noqa: E402
from veryfasttree_tpu.pipeline import run_pipeline  # noqa: E402


def main():
    golden = {}
    for name in runs.CONFIGS:
        kind, _ = runs.CONFIGS[name]
        out = io.StringIO()
        run_pipeline(runs.options(name, Options), io.StringIO(runs.fasta(kind)),
                     out, log_fp=None)
        golden[name] = {"newick": out.getvalue(), "key": runs.key(name)}
        print(name, out.getvalue()[:60], flush=True)
    with open(runs.GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
