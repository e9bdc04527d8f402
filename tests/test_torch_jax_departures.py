"""A departure of the JAX reference that the port does not follow
(ROADMAP.md, "Known departures of the JAX reference"), pinned at its first
differing value.

On tests/torch_mesh_runs.fasta("aa") (N=30, P=120, protein -noml with
BLOSUM45 and 100 resamples) the port prints one branch length 0.14428
where the JAX package prints 0.14427; the trees and supports are the
same.  Traced back from the ME lengths pass (246 of its 252 distances
differ in their last float32 bits) to the NJ phase's first join
(leaves 11 and 23 into node 30): the average profile's rows differ at
positions 40, 57, 83 and 113, each by the normalization's total, the sum
of the 20 products of the averaged rotated vector with eigentot.  The
port sums the products left to right, each rounded (kernels._code_total,
and its CUDA kernels as they repeat it).  The JAX package computes it as
`vec @ eigentot`, whose rounding is XLA's: inside the jitted _join_update
it rounds like a chain of fused multiply-adds, and the same
average_profile run eagerly gives other rows.  So the JAX value depends on
the XLA program around the dot, as the -bionj averages do, and the port
keeps its order (the card's protein runs, phase 7b of chip_smoke.py, are
pinned to it).

The test stops both pipelines where their NJ phase starts and pins, at
position 40: the JAX package's jitted total 0.99999994 (0x3f7fffff) and
the port's 1.0, and the first element of the average there, which is
what the JAX package's NJ phase stores in row 30.  About 15 s.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_runs as runs

from veryfasttree_tpu.engine import nj as jnj_mod
from veryfasttree_tpu.ops import kernels as jk
from veryfasttree_tpu.options import Options as JOptions
from veryfasttree_tpu.pipeline import run_pipeline as jax_run
from veryfasttree_tpu_torch.engine import nj as tnj_mod
from veryfasttree_tpu_torch.ops import kernels as tk

I, J, POS = 11, 23, 40


class _Stop(Exception):
    pass


def _engine_at_nj(cls, run):
    """The NJ engine that run() builds, taken where its NJ phase starts."""
    got = {}
    orig = cls.fast_nj

    def stop(self, *a, **k):
        got["nj"] = self
        raise _Stop

    cls.fast_nj = stop
    try:
        with pytest.raises(_Stop):
            run()
    finally:
        cls.fast_nj = orig
    return got["nj"]


def _bits(x):
    return int(np.asarray(x, dtype=np.float32).view(np.uint32))


def test_protein_first_join_total():
    jnj = _engine_at_nj(jnj_mod.NeighbourJoining, lambda: jax_run(
        runs.options("protein", JOptions), io.StringIO(runs.fasta("aa")),
        io.StringIO(), log_fp=None))
    tnj = _engine_at_nj(tnj_mod.NeighbourJoining,
                        lambda: runs.run_port("protein"))
    jp, tp = jnj.prof, tnj.prof
    rows = [np.asarray(a)[[I, J]] for a in (jp.codes, jp.W, jp.U)]
    np.testing.assert_array_equal(rows[0], tp.codes[[I, J]].numpy())
    np.testing.assert_array_equal(rows[2], tp.U[[I, J]].numpy())
    cf, et = jnp.asarray(jp.code_freq), jnp.asarray(jp.eigentot)
    half = np.float32(0.5)

    def jax_average(c1, w1, u1, c2, w2, u2):
        return jk.average_profile(c1, w1, u1, c2, w2, u2, half, cf, et,
                                  jp.tol)

    args = [jnp.asarray(a[k]) for k in (0, 1) for a in rows]
    jitted = np.asarray(jax.jit(jax_average)(*args)[2])
    eager = np.asarray(jax_average(*args)[2])
    t_args = [torch.from_numpy(np.array(a)) for a in args]
    port = tk.average_profile(*t_args, 0.5, tp.code_freq, tp.eigentot,
                              tp.tol)[2].numpy()
    # the totals at POS: the port's left to right, the jitted JAX one a
    # chain of fused multiply-adds
    acc = (half * rows[2][0, POS] + half * rows[2][1, POS]) \
        .astype(np.float32)
    e = np.asarray(jp.eigentot, dtype=np.float32)
    left = np.float32(acc[0] * e[0])
    chain = left
    for c in range(1, len(e)):
        left = np.float32(left + np.float32(acc[c] * e[c]))
        chain = np.float32(np.float64(acc[c]) * np.float64(e[c])
                           + np.float64(chain))
    assert _bits(left) == 0x3F800000 and _bits(chain) == 0x3F7FFFFF
    assert _bits(port[POS, 0]) == _bits(np.float32(acc[0] / left))
    assert _bits(jitted[POS, 0]) == _bits(np.float32(acc[0] / chain))
    assert _bits(port[POS, 0]) == _bits(np.float32(0.07633174))
    assert _bits(jitted[POS, 0]) == _bits(np.float32(0.07633175))
    # where the rows part: only at the four positions, and the eager JAX
    # average takes neither the jitted rounding nor always the port's
    part = np.flatnonzero((jitted != port).any(-1))
    np.testing.assert_array_equal(part, [40, 57, 83, 113])
    assert not np.array_equal(eager, jitted)
