"""The port's scan kernels and ME functions against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both sides.

* The plain twins of the CUDA scans (nj_scan_ref, nj_scan_codes_ref) are
  held against the Pallas kernels run in TPU interpret mode at rtol 1e-5,
  atol 1e-5: the Pallas kernels compute in float32 over up to 2560 terms of
  order 1.  The best index must be equal.
* The twins are held against the JAX package's float64 paths (nj_scan's jnp
  path, kernels.me_dist_many_codes) at rtol 1e-12: both sum in float64, in
  different orders.
* Each ME function of veryfasttree_tpu_torch.ops.kernels is held against its
  JAX counterpart under jit: float64 contractions at rtol 1e-12; float32
  profile arithmetic exactly in %different mode (the port reproduces the
  reference's rounding there), except the out-profile's sum over rows (rtol
  1e-6: each library sums rows in its own order), and at rtol 1e-5 in matrix
  mode, whose totals
  are float32 dot products over up to 20 signed terms summed in another
  order, and divide every vector.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from veryfasttree_tpu.constants import NOCODE
from veryfasttree_tpu.models.distance_matrix import DistanceMatrix
from veryfasttree_tpu.ops import kernels as jk
from veryfasttree_tpu.ops import pallas_kernels as pk
from veryfasttree_tpu_torch.ops import kernels as tk
from veryfasttree_tpu_torch.ops import scan_kernels as sk

M, P, N_ACTIVE, M_REAL = 512, 128, 300, 500
TIE = (37, 201)       # identical rows: the best join, an exact tie
MASKED = 505          # the most attractive row, but past m_real


def _eigen(C, rng):
    """(eigenval, code_freq) of matrix mode: BLOSUM45 for 20 codes, a
    perturbed identity for 4 (positive totals, as a real rotation has)."""
    if C == 20:
        d = DistanceMatrix.blosum45()
        return d.eigenval, d.code_freq
    return rng.uniform(-1.0, 1.0, C), np.eye(C) + 0.1 * rng.normal(size=(C, C))


def _profiles(rng, C, n=M):
    """Weighted profiles with gaps, fractional weights and an all-gap row."""
    codes = rng.integers(0, C, size=(n, P))
    codes[rng.random((n, P)) < 0.05] = NOCODE
    codes[5] = NOCODE
    W = ((codes != NOCODE) * rng.uniform(0.3, 1.0, (n, P))).astype(np.float32)
    f = rng.random((n, P, C))
    f /= f.sum(-1, keepdims=True)
    U = (W[..., None] * f).astype(np.float32)
    return codes.astype(np.int8), W, U


def _scan_inputs(C, mode, seed=0):
    rng = np.random.default_rng(seed)
    codes, W, U = _profiles(rng, C)
    for r in (TIE[1], MASKED):
        U[r], W[r], codes[r] = U[TIE[0]], W[TIE[0]], codes[TIE[0]]
    outd = rng.uniform(0.0, 1.0, M)
    outd[list(TIE)] = 60.0
    outd[MASKED] = 120.0
    q = 11
    ev, cf = _eigen(C, rng) if mode == "matrix" else (None, np.eye(C))
    return codes, W, U, U[q].astype(np.float64), W[q].astype(np.float64), \
        outd, ev, cf


def _a(uq, ev):
    return (uq * ev[None, :] if ev is not None else uq).reshape(-1)


def _t(x):
    return torch.from_numpy(np.array(x))


MODES = [(4, "pct"), (4, "matrix"), (20, "pct"), (20, "matrix")]


@pytest.mark.parametrize("C,mode", MODES)
def test_dense_twin_vs_pallas_interpret(C, mode):
    codes, W, U, uq, wq, outd, ev, _ = _scan_inputs(C, mode)
    a = _a(uq, ev)
    with pltpu.force_tpu_interpret_mode():
        dist, denom, crit, best = pk._scan_pallas(
            jnp.asarray(U.reshape(M, -1)), jnp.asarray(W),
            jnp.asarray(a.astype(np.float32).reshape(-1, 1)),
            jnp.asarray(wq.astype(np.float32).reshape(-1, 1)),
            jnp.asarray(outd.astype(np.float32)),
            jnp.asarray([N_ACTIVE, M_REAL], dtype=jnp.int32), ev is not None)
    bi, bc, d, w, c = sk.nj_scan_ref(_t(U.reshape(M, -1)), _t(W), _t(a),
                                     _t(wq), _t(outd), N_ACTIVE, M_REAL,
                                     ev is not None)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dist)[:, 0], **tol)
    np.testing.assert_allclose(w.numpy(), np.asarray(denom)[:, 0], **tol)
    np.testing.assert_allclose(c.numpy(), np.asarray(crit)[:, 0], **tol)
    assert int(bi) == int(np.asarray(best)[0]) == TIE[0]
    assert d[5] == 1.0 and w[5] == 0.0          # all-gap row
    assert c[MASKED] == 1e30
    # the CPU wrapper is the twin
    wb = sk.nj_scan_dense(_t(U.reshape(M, -1)), _t(W), _t(a), _t(wq),
                          _t(outd), N_ACTIVE, M_REAL, ev is not None)
    assert int(wb[0]) == int(bi) and torch.equal(wb[4], c)


@pytest.mark.parametrize("C,mode", MODES)
def test_dense_twin_vs_jnp_scan_f64(C, mode):
    codes, W, U, uq, wq, outd, ev, _ = _scan_inputs(C, mode, seed=1)
    outd[MASKED] = outd[TIE[0]]    # this path has no m_real: a third tie
    bj, cj, dj, wj, crj = pk.nj_scan(
        jnp.asarray(U, dtype=jnp.float64), jnp.asarray(W, dtype=jnp.float64),
        jnp.asarray(uq), jnp.asarray(wq), jnp.asarray(outd), N_ACTIVE,
        jnp.asarray(ev) if ev is not None else None)
    bi, bc, d, w, c = sk.nj_scan(_t(U), _t(W), _t(uq), _t(wq), _t(outd),
                                 N_ACTIVE, _t(ev) if ev is not None else None)
    for ours, ref in ((d, dj), (w, wj), (c, crj)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-13)
    assert int(bi) == int(bj) == TIE[0]
    np.testing.assert_allclose(float(bc), float(cj), rtol=1e-12)


def _codes_inputs(C, mode, seed=2):
    codes, W, U, uq, wq, outd, ev, cf = _scan_inputs(C, mode, seed)
    uq = uq * (uq > 0.02)          # an internal-row query: fractional, sparse
    G = ((uq * ev[None, :]) @ cf.T).T if ev is not None else uq.T
    return codes, G, uq, wq, outd, ev, cf


@pytest.mark.parametrize("C,mode", MODES)
def test_codes_twin_vs_pallas_interpret(C, mode):
    codes, G, uq, wq, outd, ev, cf = _codes_inputs(C, mode)
    n_tiles = M // pk.TILE_M
    with pltpu.force_tpu_interpret_mode():
        dist, denom, crit, best = pk._scan_codes_pallas(
            jnp.asarray(codes), jnp.asarray(G.astype(np.float32)),
            jnp.asarray(wq.astype(np.float32).reshape(-1, 1)),
            jnp.asarray(outd.astype(np.float32)),
            jnp.asarray([N_ACTIVE, M_REAL], dtype=jnp.int32), ev is not None,
            C, n_tiles)
    bi, bc, d, w, c = sk.nj_scan_codes_ref(_t(codes), _t(G), _t(wq),
                                           _t(outd), N_ACTIVE, M_REAL,
                                           ev is not None)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dist)[:, 0], **tol)
    np.testing.assert_allclose(w.numpy(), np.asarray(denom)[:, 0], **tol)
    np.testing.assert_allclose(c.numpy(), np.asarray(crit)[:, 0], **tol)
    assert int(bi) == int(np.asarray(best)[0]) == TIE[0]
    assert d[5] == 1.0 and w[5] == 0.0
    assert c[MASKED] == 1e30


@pytest.mark.parametrize("C,mode", MODES)
def test_codes_twin_vs_me_dist_many_codes_f64(C, mode):
    codes, G, uq, wq, outd, ev, cf = _codes_inputs(C, mode, seed=3)
    dj, wj = jk.me_dist_many_codes(
        jnp.asarray(codes), jnp.asarray(uq), jnp.asarray(wq),
        jnp.asarray(ev) if ev is not None else None, jnp.asarray(cf),
        jnp.float64)
    _, _, d, w, _ = sk.nj_scan_codes(_t(codes), _t(G), _t(wq), _t(outd),
                                     N_ACTIVE, M, ev is not None)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-12)


# --------------------------------------------------------------------------
# ME functions of ops/kernels.py, one case each
# --------------------------------------------------------------------------

def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _eq(ours, ref, exact, rtol=1e-5):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    if exact:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * 1e-3)


def _f64_case(rng, C, mode, K=64):
    _, W, U = _profiles(rng, C, K)
    _, W2, U2 = _profiles(rng, C, K)
    ev = _eigen(C, rng)[0] if mode == "matrix" else None
    return [x.astype(np.float64) for x in (U, W, U2, W2)], ev


def _case_me_dist(name, C, mode, rng):
    (U, W, U2, W2), ev = _f64_case(rng, C, mode)
    evj = jnp.asarray(ev) if ev is not None else None
    evt = _t(ev) if ev is not None else None
    if name == "me_dist_many":
        ref = jk.me_dist_many(U, W, U2[3], W2[3], evj)
        ours = tk.me_dist_many(_t(U), _t(W), _t(U2[3]), _t(W2[3]), evt)
    elif name == "me_dist_many_2d":
        ref = jk.me_dist_many_2d(U.reshape(len(U), -1), W, U2[3], W2[3], evj)
        ours = tk.me_dist_many_2d(_t(U.reshape(len(U), -1)), _t(W),
                                  _t(U2[3]), _t(W2[3]), evt)
    elif name == "me_dist_pair":
        ref = jk.me_dist_pair(U[1], W[1], U2[3], W2[3], evj)
        ours = tk.me_dist_pair(_t(U[1]), _t(W[1]), _t(U2[3]), _t(W2[3]), evt)
    else:
        ref = jk.me_dist_rows(U, W, U2, W2, evj)
        ours = tk.me_dist_rows(_t(U), _t(W), _t(U2), _t(W2), evt)
    for o, r in zip(ours, ref):
        _eq(o, r, False, rtol=1e-12)


def _mats(C, mode, rng):
    if mode == "matrix":
        ev, cf = _eigen(C, rng)
        et = cf @ np.ones(C) if C != 20 else DistanceMatrix.blosum45().eigentot
        return cf.astype(np.float32), et.astype(np.float32)
    return np.eye(C, dtype=np.float32), None


def _case_profiles(name, C, mode, rng):
    cf, et = _mats(C, mode, rng)
    etj = jnp.asarray(et) if et is not None else None
    ett = _t(et) if et is not None else None
    exact = mode == "pct"
    tol = 1e-10
    codes, W, U = _profiles(rng, C, 96)
    U[7, :10] = 0.0                        # totals at 0: fallback positions
    if name == "normalize_freq":
        fb = cf[0] if et is not None else np.full(C, 1.0 / C, np.float32)
        ref = _jit(jk.normalize_freq, eigentot=etj, tol=tol)(U, fallback=fb)
        _eq(tk.normalize_freq(_t(U), ett, _t(fb), tol), ref, exact)
    elif name == "average_profile":
        for bw in (0.5, 0.3125, 0.71):
            ref = _jit(jk.average_profile, eigentot=etj, tol=tol)(
                codes[:48], W[:48], U[:48], codes[48:], W[48:], U[48:],
                np.float32(bw), cf)
            ours = tk.average_profile(
                _t(codes[:48]), _t(W[:48]), _t(U[:48]), _t(codes[48:]),
                _t(W[48:]), _t(U[48:]), bw, _t(cf), ett, tol)
            for o, r in zip(ours, ref):
                _eq(o, r, exact)
    elif name == "out_profile":
        mask = rng.random(96) < 0.7
        ref = _jit(jk.out_profile, eigentot=etj, tol=tol)(U, W, mask,
                                                          code_freq=cf)
        ours = tk.out_profile(_t(U), _t(W), _t(mask), _t(cf), ett, tol)
        for o, r in zip(ours, ref):
            _eq(o, r, False, rtol=1e-6 if exact else 1e-5)
    elif name == "update_out_profile":
        w_out, f_out = (np.asarray(x) for x in jk.out_profile(
            U, W, np.ones(96, bool), cf, etj, tol))
        args = (w_out, f_out, U[1], W[1], U[2], W[2], U[3], W[3])
        ref = _jit(jk.update_out_profile, eigentot=etj, tol=tol)(
            *args, 96, cf)
        ours = tk.update_out_profile(*map(_t, args), 96, _t(cf), ett, tol)
        for o, r in zip(ours, ref):
            _eq(o, r, exact)
    else:  # leaf_u
        ref = jk.leaf_u(codes, cf, jnp.float32)
        ours = tk.leaf_u(_t(codes), _t(cf), torch.float32)
        for o, r in zip(ours, ref):
            _eq(o, r, True)


def _case_host_math(name, C, mode, rng):
    if name == "log_correct":
        d = rng.uniform(0.0, 1.2, 256)
        use_matrix = mode == "matrix"
        _eq(tk.log_correct(_t(d), C, use_matrix),
            jk.log_correct(jnp.asarray(d), C, use_matrix), False, rtol=1e-12)
    elif name == "out_distance_from_hit":
        args = [rng.uniform(0.05, 1.0, 128) for _ in range(5)]
        args[3][:5] = 1e3                 # bottom <= 0.01: the fixed 3.0
        ref = jk.out_distance_from_hit(*map(jnp.asarray, args), 2.5, 77)
        _eq(tk.out_distance_from_hit(*map(_t, args), 2.5, 77), ref, False,
            rtol=1e-12)
    else:  # me_dist_many_codes
        codes, G, uq, wq, outd, ev, cf = _codes_inputs(C, mode, seed=4)
        ref = jk.me_dist_many_codes(
            jnp.asarray(codes), jnp.asarray(uq), jnp.asarray(wq),
            jnp.asarray(ev) if ev is not None else None, jnp.asarray(cf),
            jnp.float64)
        ours = tk.me_dist_many_codes(
            _t(codes), _t(uq), _t(wq), _t(ev) if ev is not None else None,
            _t(cf), torch.float64)
        for o, r in zip(ours, ref):
            _eq(o, r, False, rtol=1e-12)


ME_FUNCTIONS = {
    "me_dist_many": _case_me_dist, "me_dist_many_2d": _case_me_dist,
    "me_dist_pair": _case_me_dist, "me_dist_rows": _case_me_dist,
    "log_correct": _case_host_math, "normalize_freq": _case_profiles,
    "average_profile": _case_profiles, "out_profile": _case_profiles,
    "update_out_profile": _case_profiles,
    "out_distance_from_hit": _case_host_math, "leaf_u": _case_profiles,
    "me_dist_many_codes": _case_host_math,
}


@pytest.mark.parametrize("name", sorted(ME_FUNCTIONS))
def test_me_function_matches_jax(name):
    rng = np.random.default_rng(sorted(ME_FUNCTIONS).index(name))
    for C, mode in MODES:
        ME_FUNCTIONS[name](name, C, mode, rng)


# --------------------------------------------------------------------------
# Kernel wrappers: the twin for CPU tensors, the kernel for CUDA tensors,
# and nothing else
# --------------------------------------------------------------------------

def _wrapper_args(which, dev):
    from veryfasttree_tpu_torch.ops import store_kernels as st

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f64 = torch.float64
    if which == "nj_scan_dense":
        return sk.nj_scan_dense, (z(8, 16), z(8, 4), z(16, dtype=f64),
                                  z(4, dtype=f64), z(8, dtype=f64), 5, 8,
                                  False)
    if which == "nj_scan_codes":
        return sk.nj_scan_codes, (z(8, 16, dtype=torch.int8),
                                  z(4, 16, dtype=f64), z(16, dtype=f64),
                                  z(8, dtype=f64), 5, 8, False)
    store = (z(8, 16, dtype=torch.int8), z(8, 16), z(8, 16, 4), z(4, 4))
    if which == "me_dists":
        return st.me_dists, (*store, None, 0, [1], z(16, 4), z(16), [2], [3])
    return st.me_average, (*store, None, 0, [4], [1], [2], 0.5, 1e-10)


@pytest.mark.parametrize("which", ["nj_scan_dense", "nj_scan_codes",
                                   "me_dists", "me_average"])
def test_wrapper_never_falls_back(which):
    """On the CPU a wrapper runs its twin without counting a launch; on a
    device that is neither the CPU nor CUDA it raises."""
    fn, args = _wrapper_args(which, torch.device("cpu"))
    before = fn.launches
    fn(*args)
    assert fn.launches == before
    fn, args = _wrapper_args(which, torch.device("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fn(*args)


def test_me_average_rejects_a_target_read_in_the_same_call():
    """Every row is read before any is written, so a target may not also be
    a source (nor appear twice)."""
    from veryfasttree_tpu_torch.ops import store_kernels as st

    fn, args = _wrapper_args("me_average", torch.device("cpu"))
    store = args[:6]
    for targets, iis, jjs in (([4, 5], [1, 4], [2, 3]), ([4, 4], [1, 2],
                                                         [2, 3])):
        with pytest.raises(ValueError, match="distinct and not sources"):
            st.me_average(*store, targets, iis, jjs, 0.5, 1e-10)
