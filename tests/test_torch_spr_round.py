"""The port's SPR round (ops/spr_kernels.spr_round, on the CPU the host loop
engine/spr.run_spr on the per-call twins) against the JAX package's device
SPR round (engine/spr_epoch.run_spr_epoch).

Inputs are those of tests/test_spr_epoch.py (its founder-mutation
alignments, numpy seeds).  The JAX engine builds the NJ tree; its
checkpoint carries tree and store to the port's engine, so both rounds start
from the same arrays.  After one round the tree arrays, n_spr and the ME
profile counters must be equal, and the node rows [:maxnode] (codes, W, U)
bit for bit; under -bionj W too, and U within atol 2e-7 (measured 1.8e-7,
three float32 ulps) with the same topology: the JAX round averages inside
another XLA program than the JAX package's NJ joins, whose CPU build rounds
the weight that scales U and the position totals otherwise (the port
follows the joins' rounding, ops/kernels.py average_profile).  About 70 s
in one process.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_spr_epoch import _synth

from veryfasttree_tpu.engine import spr_epoch
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.engine.profiles import fetch_np
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.ops import spr_kernels
from veryfasttree_tpu_torch.options import Options as TOptions

COUNTERS = ("n_spr", "profile_ops", "profile_avg_ops")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The host loop issues tiny ops, on which intra-op threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(tmp_path, n, p, seed, kw):
    """(JAX engine, port engine) on the same NJ tree and store."""
    opts = Options(n_codes=4, show_progress=False, **kw)
    opts.derive_settings()
    codes = _synth(n, p, seed)
    jnj = JNJ(opts, codes, None, None)
    jnj.fast_nj()
    path = str(tmp_path / "nj.npz")
    save_checkpoint(jnj, path, {"phase": "nj"})
    tnj = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, None)
    with np.load(path) as z:
        tnj.load_state({k: z[k] for k in z.files})
    for name in COUNTERS:          # the rounds' own counts only
        setattr(jnj.debug, name, 0)
        setattr(tnj.debug, name, 0)
    return jnj, tnj


def _same_round(jnj, tnj, bionj):
    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name), err_msg=name)
    for name in COUNTERS:
        assert getattr(tnj.debug, name) == getattr(jnj.debug, name), name
    mh = jnj.tree.maxnode
    lo = tnj.prof._leaf_rows        # float rows of a two-tier store
    np.testing.assert_array_equal(tnj.prof.codes.numpy()[:mh],
                                  fetch_np(jnj.prof.codes)[:mh])
    for name in ("W", "U"):
        t = getattr(tnj.prof, name).numpy()[: mh - lo]
        j = fetch_np(getattr(jnj.prof, name))[: mh - lo]
        if bionj and name == "U":
            np.testing.assert_allclose(t, j, rtol=0, atol=2e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("n,p,seed,kw", [
    (80, 256, 5, {}),
    (80, 256, 5, {"two_tier_min": 0}),
    (150, 300, 2, {}),
    (100, 256, 8, {"bionj": True}),
])
def test_spr_round_matches_jax_epoch(tmp_path, n, p, seed, kw):
    jnj, tnj = _engines(tmp_path, n, p, seed, kw)
    assert tnj.prof.two_tier == ("two_tier_min" in kw)
    spr_epoch.run_spr_epoch(jnj, 0, 2)
    spr_kernels.spr_round(tnj, 0, 2)
    assert tnj.debug.n_spr > 0
    _same_round(jnj, tnj, kw.get("bionj", False))
