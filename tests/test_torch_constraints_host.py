"""-constraints on the CPU: the penalty functions against the JAX
package's, the kernels' summation order, and the join epoch's constrained
decider.

* The port's quartet_constraint_penalties, join_penalties_batch and
  split_violates_constraint equal (==) the JAX package's on hypothesis
  cases: 1 to 140 constraint columns, counts with zeros on either side
  (the '-' entries of a constraint alignment), several weights.
* The kernels sum a quartet penalty's relevant terms in numpy's pairwise
  order (csrc/constraints.cuh np_sum): a Python mirror of that order, and
  the C++ itself built as host code (tests/epoch_host/host_epoch.cpp),
  equal np.sum bit for bit on arrays of 0 to 1,200 terms; the C++ quartet
  and join penalties equal the JAX package's.
* The join epoch's decider (csrc/nj_epoch.cuh Master) with the counts of
  a 16-column constraint alignment, built as host C++ (the lanes as
  coroutines, tests/test_torch_epoch_warp.py), gives the host loop's join
  log and counts at N=120, its values within chip_smoke.EPOCH_TWIN_ATOL.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from veryfasttree_tpu.engine import nj as jnj
from veryfasttree_tpu.engine import rearrange as jre
from veryfasttree_tpu.engine import supports as jsup
from veryfasttree_tpu_torch.engine import epoch
from veryfasttree_tpu_torch.engine import nj as tnj
from veryfasttree_tpu_torch.engine import rearrange as tre
from veryfasttree_tpu_torch.engine import supports as tsup
from veryfasttree_tpu_torch.models import DistanceMatrix  # noqa: F401
from veryfasttree_tpu_torch.ops import _build, epoch_kernels
from veryfasttree_tpu_torch.options import Options

HERE = Path(__file__).resolve().parent
N = 120
_P = ctypes.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decider")
    out = tmp_path_factory.mktemp("cons_host") / "libhost_epoch.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{HERE / 'epoch_host' / 'include'}", f"-I{_build.SRC_DIR}",
         "-o", str(out), str(HERE / "epoch_host" / "host_epoch.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.vft_nj_epoch_scratch.argtypes = [ctypes.c_int64] * 3 + [_P]
    lib.vft_nj_epoch_scratch.restype = None
    lib.vft_nj_epoch_cons_host.argtypes = [_P, _P]
    lib.vft_nj_epoch_cons_host.restype = ctypes.c_int
    lib.vft_np_sum_host.argtypes = [_P, ctypes.c_int]
    lib.vft_np_sum_host.restype = ctypes.c_double
    lib.vft_quartet_penalties_host.argtypes = [_P, _P, ctypes.c_int,
                                               ctypes.c_double, _P, _P]
    lib.vft_quartet_penalties_host.restype = None
    lib.vft_join_penalty_host.argtypes = [_P] * 4 + [ctypes.c_int] * 3
    lib.vft_join_penalty_host.restype = ctypes.c_int64
    return lib


def np_sum_mirror(a):
    """numpy's pairwise float64 sum, as csrc/constraints.cuh np_sum adds."""
    n = len(a)
    if n < 8:
        res = 0.0
        for x in a:
            res += x
        return res
    if n <= 128:
        r = [float(x) for x in a[:8]]
        i = 8
        while i < n - n % 8:
            for j in range(8):
                r[j] += a[i + j]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for x in a[i:]:
            res += x
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return np_sum_mirror(a[:n2]) + np_sum_mirror(a[n2:])


@st.composite
def counts(draw, rows=8):
    """(on, off) [rows, n_cons] int64: small counts, zero on either side
    (or both: a '-' entry) at random."""
    n_cons = draw(st.integers(1, 140))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    on = rng.integers(0, 5, (rows, n_cons))
    off = rng.integers(0, 5, (rows, n_cons))
    on[rng.random(on.shape) < draw(st.floats(0.0, 0.9))] = 0
    off[rng.random(off.shape) < draw(st.floats(0.0, 0.9))] = 0
    return on.astype(np.int64), off.astype(np.int64), rng


def _engine(on, off, weight, out=None):
    return SimpleNamespace(n_cons=on.shape[1], con_on=on, con_off=off,
                           options=SimpleNamespace(constraint_weight=weight),
                           con_out_on=None if out is None else out[0],
                           con_out_off=None if out is None else out[1])


WEIGHTS = st.sampled_from([100.0, 1.0, 3.7, 1e-3])


@settings(max_examples=150, deadline=None)
@given(counts(), WEIGHTS)
def test_quartet_penalties_are_the_jax_packages(c, weight):
    on, off, rng = c
    nj = _engine(on, off, weight)
    for _ in range(4):
        n4 = [int(x) for x in rng.choice(len(on), 4, replace=False)]
        want = jre.quartet_constraint_penalties(
            nj, [(on[x], off[x]) for x in n4])
        got = tre.quartet_constraint_penalties(nj, n4)
        assert np.array_equal(got, want)


@settings(max_examples=150, deadline=None)
@given(counts())
def test_join_penalty_and_violations_are_the_jax_packages(c):
    on, off, rng = c
    out = (on.sum(0) + rng.integers(0, 3, on.shape[1]),
           off.sum(0) + rng.integers(0, 3, on.shape[1]))
    nj = _engine(on, off, 100.0, out)
    for _ in range(4):
        i, j = (int(x) for x in rng.choice(len(on), 2, replace=False))
        assert tnj.NeighbourJoining.join_penalties_batch(nj, [i], [j])[0] \
            == jnj.NeighbourJoining.join_constraint_penalty(nj, i, j)
        n4 = [int(x) for x in rng.choice(len(on), 4, replace=False)]
        for c_ in range(on.shape[1]):
            assert tsup.split_violates_constraint(nj, n4, c_) == \
                jsup.split_violates_constraint(nj, n4, c_)


def test_summation_order_is_numpys(host_lib):
    rng = np.random.default_rng(0)
    lengths = list(range(0, 300)) + [int(x) for x in rng.integers(300, 1200, 40)]
    for n in lengths:
        a = rng.random(n) * rng.choice([1.0, 1e3, 1e-3])
        want = np.sum(a)
        assert np_sum_mirror(list(a)) == want, n
        assert host_lib.vft_np_sum_host(a.ctypes.data, n) == want, n


@settings(max_examples=100, deadline=None)
@given(counts(), WEIGHTS)
def test_kernel_penalties_are_the_jax_packages(host_lib, c, weight):
    on, off, rng = c
    n_cons = on.shape[1]
    nj = _engine(on, off, weight, (on.sum(0) + 1, off.sum(0) + 1))
    on32 = np.ascontiguousarray(on, dtype=np.int32)
    off32 = np.ascontiguousarray(off, dtype=np.int32)
    out_on = np.ascontiguousarray(nj.con_out_on, dtype=np.int32)
    out_off = np.ascontiguousarray(nj.con_out_off, dtype=np.int32)
    for _ in range(4):
        n4 = np.array(rng.choice(len(on), 4, replace=False), dtype=np.int32)
        pen = np.zeros(3)
        host_lib.vft_quartet_penalties_host(on32.ctypes.data, off32.ctypes.data,
                                            n_cons, weight, n4.ctypes.data,
                                            pen.ctypes.data)
        want = jre.quartet_constraint_penalties(
            nj, [(on[x], off[x]) for x in n4])
        assert np.array_equal(pen, want)
        i, j = int(n4[0]), int(n4[1])
        assert host_lib.vft_join_penalty_host(
            on32.ctypes.data, off32.ctypes.data, out_on.ctypes.data,
            out_off.ctypes.data, n_cons, i, j) == \
            jnj.NeighbourJoining.join_constraint_penalty(nj, i, j)


def _nj(n):
    opts = Options(n_codes=4, ml_nni=0, n_bootstrap=0, show_progress=False)
    opts.derive_settings()
    cols = chip_smoke.cons_columns(n, chip_smoke.MAIN_P,
                                   chip_smoke.CONS_COLS)
    return tnj.NeighbourJoining(
        opts, chip_smoke.synth_codes(n, chip_smoke.MAIN_P), None, None,
        chip_smoke.cons_counts(cols), device=torch.device("cpu"))


def test_constrained_warp_decider_is_the_host_loop(host_lib, monkeypatch):
    """The decider's launches (ops/epoch_kernels._run_launches on a CPU
    store, each through vft_nj_epoch_cons_host) against the host loop,
    to the join before the last (tests/test_torch_epoch_warp.py)."""
    def launch(state, seg, grid):
        p = state.params
        p.n_hi, p.n_lo, p.resume, p.stop_reset = (int(x) for x in seg)
        for name in ("ctl", "mark", "mark2"):
            state.t[name].zero_()
        assert state.cons is not None
        assert host_lib.vft_nj_epoch_cons_host(ctypes.byref(p),
                                               ctypes.byref(state.cons)) == 0
        return 1

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    monkeypatch.setattr(epoch_kernels, "_launch", launch)
    monkeypatch.setattr(epoch_kernels, "_check_store", lambda codes, W, U, f,
                        lo: (codes.shape[0], codes.shape[1], U.shape[-1]))
    monkeypatch.setattr(epoch, "run_epoch", lambda nj, th, mj=None:
                        epoch_kernels._run_launches(nj, th, mj, None))
    warp = _nj(N)
    warp.fast_nj(N - 4)
    monkeypatch.undo()
    twin = _nj(N)
    twin.fast_nj(N - 4)
    a, b = chip_smoke.epoch_state(warp), chip_smoke.epoch_state(twin)
    assert len(a["join_log"]) == N - 4
    assert np.array_equal(a["join_log"], b["join_log"])
    assert np.array_equal(warp.con_on, twin.con_on)
    assert np.array_equal(warp.con_off, twin.con_off)
    for k in ("branchlength", "diameter", "out_distances"):
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=chip_smoke.EPOCH_TWIN_ATOL)


@settings(max_examples=100, deadline=None)
@given(counts(rows=12))
def test_join_penalties_batch_is_the_pair_loop(c):
    """The port's [K, n_cons] join_penalties_batch over 30 pairs at once:
    each pair's JAX join_constraint_penalty."""
    on, off, rng = c
    out = (on.sum(0) + rng.integers(0, 3, on.shape[1]),
           off.sum(0) + rng.integers(0, 3, on.shape[1]))
    nj = _engine(on, off, 100.0, out)
    iis = rng.integers(0, len(on), 30)
    jjs = rng.integers(0, len(on), 30)
    got = tnj.NeighbourJoining.join_penalties_batch(nj, iis, jjs)
    want = [jnj.NeighbourJoining.join_constraint_penalty(nj, int(i), int(j))
            for i, j in zip(iis, jjs)]
    assert got.dtype == np.float64 and got.tolist() == want
