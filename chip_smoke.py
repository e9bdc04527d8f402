#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script exits 0 only when all
passed):

0. the card (nvidia-smi name and power limit), torch's CUDA version;
1. build the CUDA kernels from veryfasttree_tpu_torch/csrc;
2. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with the median time of 50 runs of each (CUDA events):
   the scans and the pair distances in double (rtol 1e-12, atol 1e-12; best
   index equal), the profile average bit-identical (rtol 1e-6 in BLOSUM45
   matrix mode).
   The ML store's kernels (ml_pair_loglk, ml_posterior, ml_opt_branch)
   against theirs on a store of the N=2000 layout (12008 rows of 512
   positions), Jukes-Cantor and GTR with 4 codes and JTT with 20: ll and
   per-site lk rtol 1e-6, posterior W and V atol 1e-6, line search x rtol
   1e-4 and -loglk at x atol 1e-3;
3. the -noml pipeline at N=500, P=500 against the JAX package's tree
   (tests/data/torch_port_golden_n500_p500.nwk), dense and two-tier: RF 0
   to the golden, and the two layouts give the same Newick; then the same
   input through the command line (python -m veryfasttree_tpu_torch -nt
   -noml -nosupport), RF 0 to the golden;
4. the -noml main path: full -nt -noml -nosupport at N=2000, P=500 (the
   bench.py input) through run_pipeline, cold, then warm, then once more
   with the two-tier store forced on (-two-tier-min 0), which must give the
   same tree.  The kernel launch counts are reset just before the warm run
   and read just after it: each kernel of the dense path must have
   launched.  The codes scan runs only in the two-tier store (N >= 20000,
   or -two-tier-min 0), so its launches are counted apart, in the two-tier
   run, and must be nonzero there;
5. the ML phase against the JAX package's trees at N=200, P=500
   (tests/data/torch_port_ml_golden_n200_p500*): the default -nt run (ML
   NNIs, CAT 20, SH-like supports from 1000 resamples) and -nt -gtr
   -gamma, each RF 0 to its golden and final LogLk within 1e-4 relative,
   with the per-round LogLk differences printed; the default run is traced
   with torch.profiler for the device's busy share; then the default run
   through the command line (python -m veryfasttree_tpu_torch -nt), RF 0
   to its golden;
6. the ML main path: the full default -nt run at N=2000, P=500 through
   run_pipeline (warm: phase 5 ran the same code), with its phase split and
   final LogLk.  The launch counts are reset just before it and read just
   after it: every kernel of the dense path, the ML kernels included, must
   have launched.

The last lines are the card's name and power limit, one JSON line with each
kernel's route, source, main-path launches (the ML main path's for the ML
kernels, the -noml one's for the others, with their ML-path and two-tier
launches apart), error and times, and the result line.  Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import collections  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden_n500_p500")
ML_GOLDEN = os.path.join(REPO, "tests", "data",
                         "torch_port_ml_golden_n200_p500")
MAIN_N, MAIN_P = 2000, 500          # bench.py's input
ML_GOLDEN_N = 200

# name -> (source, what it replaces in the JAX package on the TPU: the two
# Pallas kernels, and the XLA-compiled store functions behind the host loops)
KERNELS = {
    "nj_scan_dense": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                      "veryfasttree_tpu/ops/pallas_kernels.py:38"),
    "nj_scan_codes": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                      "veryfasttree_tpu/ops/pallas_kernels.py:173"),
    "me_dists": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                 "veryfasttree_tpu/engine/profiles.py:244"),
    "me_average": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                   "veryfasttree_tpu/engine/profiles.py:310"),
    "ml_pair_loglk": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                      "veryfasttree_tpu/engine/ml_profiles.py:52"),
    "ml_posterior": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                     "veryfasttree_tpu/engine/ml_profiles.py:77"),
    "ml_opt_branch": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                      "veryfasttree_tpu/engine/ml_profiles.py:743"),
}
ML_KERNELS = ("ml_pair_loglk", "ml_posterior", "ml_opt_branch")
TOL = dict(rtol=1e-12, atol=1e-12)
BEST = 100                      # the row the scan inputs make the best


def TWINS(n):
    """Exact duplicates of row BEST: two in range, one past m_real."""
    return n // 2, 3 * n // 4, n - 10


def wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from veryfasttree_tpu_torch.ops import ml_kernels, scan_kernels, \
        store_kernels

    return {"nj_scan_dense": scan_kernels.nj_scan_dense,
            "nj_scan_codes": scan_kernels.nj_scan_codes,
            "me_dists": store_kernels.me_dists,
            "me_average": store_kernels.me_average,
            "ml_pair_loglk": ml_kernels.ml_pair_loglk,
            "ml_posterior": ml_kernels.ml_posterior,
            "ml_opt_branch": ml_kernels.ml_opt_branch}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, runs=50):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# --------------------------------------------------------------- phase 2
def dense_case(C, use_matrix, gen, dev, M=8192, P=512):
    """Scan inputs at the main path's store shape: gap rows, masked tail,
    and duplicated rows forcing an exact tie for the best."""
    import torch

    from veryfasttree_tpu_torch.models import DistanceMatrix

    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.rand((M, P), generator=gen, **f32) * 0.7 + 0.3
    W[torch.rand((M, P), generator=gen, **f32) < 0.05] = 0.0
    W[5:9] = 0.0
    f = torch.rand((M, P, C), generator=gen, **f32)
    f /= f.sum(-1, keepdim=True)
    U = W[..., None] * f
    outd = torch.rand(M, generator=gen, dtype=torch.float64, device=dev)
    for r in TWINS(M):                       # duplicates of row BEST
        U[r], W[r] = U[BEST], W[BEST]
    outd[[BEST, *TWINS(M)[:2]]] = 60.0
    outd[M - 10] = 120.0                     # the best row, but masked
    a = U[17].double()
    if use_matrix:
        a = a * torch.as_tensor(DistanceMatrix.blosum45().eigenval,
                                device=dev)[None, :]
    return (U.reshape(M, P * C), W, a.reshape(-1), W[17].double(), outd,
            300, M - 64, use_matrix)


def codes_case(C, use_matrix, gen, dev, L=20000, P=512):
    import torch

    from veryfasttree_tpu_torch.models import DistanceMatrix

    codes = torch.randint(0, C, (L, P), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((L, P), generator=gen, device=dev) < 0.05] = 127
    codes[5:9] = 127
    outd = torch.rand(L, generator=gen, dtype=torch.float64, device=dev)
    for r in TWINS(L):
        codes[r] = codes[BEST]
    outd[[BEST, *TWINS(L)[:2]]] = 60.0
    outd[L - 10] = 120.0
    uq = torch.rand((P, C), generator=gen, dtype=torch.float64, device=dev)
    uq /= uq.sum(-1, keepdim=True)
    wq = torch.rand(P, generator=gen, dtype=torch.float64, device=dev)
    uq *= wq[:, None]
    if use_matrix:
        dm = DistanceMatrix.blosum45()
        ev = torch.as_tensor(dm.eigenval, device=dev)
        cf = torch.as_tensor(dm.code_freq, device=dev)
        G = ((uq * ev[None, :]) @ cf.T).T.contiguous()
    else:
        G = uq.T.contiguous()
    return codes, G, wq, outd, 300, L - 64, use_matrix


def store_case(C, use_matrix, leaf_rows, gen, dev, n_rows=8192, P=512):
    """A random profile store in the main path's layout (N=2000: 8192 rows
    of 512 positions); rows below leaf_rows exist only as codes."""
    import torch

    from veryfasttree_tpu_torch.models import DistanceMatrix

    codes = torch.randint(0, C, (n_rows, P), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((n_rows, P), generator=gen, device=dev) < 0.05] = 127
    codes[5:9] = 127
    n_float = -(-(n_rows - leaf_rows) // 256) * 256
    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.rand((n_float, P), generator=gen, **f32) * 0.7 + 0.3
    W[torch.rand((n_float, P), generator=gen, **f32) < 0.05] = 0.0
    f = torch.rand((n_float, P, C), generator=gen, **f32)
    U = W[..., None] * (f / f.sum(-1, keepdim=True))
    if use_matrix:
        dm = DistanceMatrix.blosum45()
        cf = torch.as_tensor(dm.code_freq, **f32)
        ev = torch.as_tensor(dm.eigenval, dtype=torch.float64, device=dev)
        et = torch.as_tensor(dm.eigentot, **f32)
    else:
        cf, ev, et = torch.eye(C, **f32), None, None
    return codes, W, U, cf, ev, et


def check_dists(label, C, use_matrix, leaf_rows, gen, dev):
    """me_dists against its twin: 300 rows against a query (an out-profile
    refresh) and the 6 pairs of an NNI quartet; the time is the quartet's."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import store_kernels as st

    codes, W, U, cf, ev, _ = store_case(C, use_matrix, leaf_rows, gen, dev)
    rng = np.random.default_rng(C + leaf_rows)
    n_rows = codes.shape[0]
    q_rows = rng.choice(n_rows, 300, replace=False)
    quartet = rng.choice(n_rows, 4, replace=False)
    quartet[0] = 6                           # a row with no weight (dist 1)
    ii = quartet[[0, 0, 0, 1, 1, 2]]
    jj = quartet[[1, 2, 3, 2, 3, 3]]
    q = (U[300], W[300])
    store = (codes, W, U, cf, ev, leaf_rows)
    got = st.me_dists(*store, q_rows, *q, ii, jj).cpu().numpy()
    exp = st.me_dists_ref(*store, q_rows, *q, ii, jj).cpu().numpy()
    np.testing.assert_allclose(got, exp, err_msg=f"me_dists {label}", **TOL)
    err = float(np.max(np.abs(got - exp)))
    nni = (*store, (), None, None, ii, jj)
    return err, median_ms(lambda: st.me_dists(*nni)), \
        median_ms(lambda: st.me_dists_ref(*nni))


def check_average(label, C, use_matrix, leaf_rows, gen, dev):
    """me_average against its twin on copies of one store: one join, then
    a level of 200 targets; codes and weights equal, vectors equal in
    %different mode (rtol 1e-6 in matrix mode, whose position total is a
    float32 dot product summed in another order); the time is one join's."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import store_kernels as st

    codes, W, U, cf, _, et = store_case(C, use_matrix, leaf_rows, gen, dev)
    rng = np.random.default_rng(7 + C + leaf_rows)
    n_rows = codes.shape[0]
    rows = rng.permutation(np.arange(max(leaf_rows, 16), n_rows))
    level = (rows[:200], rows[200:400].copy(), rows[400:600])
    if leaf_rows:
        level[1][:100] = rng.choice(leaf_rows, 100)
    level[1][:3] = 5                         # NOCODE rows as sources
    calls = [([rows[500]], [3], [rows[600]], 0.5), (*level, 0.5),
             ([rows[700]], [9], [10], 0.3)]
    stores = []
    for fn in (st.me_average, st.me_average_ref):
        c, w, u = codes.clone(), W.clone(), U.clone()
        for t, i, j, bw in calls:
            fn(c, w, u, cf, et, leaf_rows, t, i, j, bw, 1e-10)
        stores.append((c.cpu().numpy(), w.cpu().numpy(), u.cpu().numpy()))
    (c1, w1, u1), (c2, w2, u2) = stores
    np.testing.assert_array_equal(c1, c2, err_msg=f"me_average {label} codes")
    tol = dict(rtol=1e-6, atol=1e-7) if use_matrix else dict(rtol=0, atol=0)
    np.testing.assert_allclose(w1, w2, err_msg=f"me_average {label} W", **tol)
    np.testing.assert_allclose(u1, u2, err_msg=f"me_average {label} U", **tol)
    err = max(float(np.max(np.abs(w1 - w2))), float(np.max(np.abs(u1 - u2))))
    one = (codes, W, U, cf, et, leaf_rows, [rows[500]], [3], [rows[600]], 0.5,
           1e-10)
    return err, median_ms(lambda: st.me_average(*one)), \
        median_ms(lambda: st.me_average_ref(*one))


def check_kernel(name, kernel, twin, args):
    import numpy as np
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    exp = twin(*args)
    if not int(got[0]) == int(exp[0]) == BEST:
        raise AssertionError(f"{name}: best index {int(got[0])}, twin's "
                             f"{int(exp[0])}, expected the tie's lowest {BEST}")
    err = 0.0
    for label, g, e in zip(("best_crit", "dist", "denom", "crit"), got[1:],
                           exp[1:]):
        g, e = g.cpu().numpy(), e.cpu().numpy()
        np.testing.assert_allclose(g, e, err_msg=f"{name} {label}", **TOL)
        err = max(err, float(np.max(np.abs(g - e))))
    return int(got[0]), err, median_ms(lambda: kernel(*args)), \
        median_ms(lambda: twin(*args))


def ml_store_case(C, model, gen, dev, n_rows=3 * 2 * MAIN_N + 8, P=512,
                  n_pos=MAIN_P, n_leaf=MAIN_N):
    """A random ML store in the N=2000 layout: leaf rows (codes with gaps)
    below n_leaf, posterior rows (NOCODE; weights 0, 1 and a few fractions)
    above, 20 CAT rates.  Returns (codes, W, V, MLModel)."""
    import torch

    from veryfasttree_tpu_torch.models import TransitionMatrix
    from veryfasttree_tpu_torch.ops.ml_kernels import MLModel

    f32 = dict(dtype=torch.float32, device=dev)
    if model == "jc":
        cf = torch.zeros((128, C), **f32)
        cf[:C] = torch.eye(C, **f32)
        cf[127] = 0.25
        ev, ei, si = (torch.zeros(C, **f32), torch.eye(C, **f32),
                      torch.ones(C, **f32))
    else:
        tm = TransitionMatrix.jtt92() if model == "jtt" else \
            TransitionMatrix.gtr([1.2, 3.1, 0.8, 1.1, 2.9, 1.0],
                                 [0.3, 0.2, 0.24, 0.26])
        cf, ev, ei, si = (torch.tensor(a, **f32).contiguous() for a in (
            tm.code_freq, tm.eigenval, tm.eigeninv, tm.statinv))
    codes = torch.randint(0, C, (n_rows, P), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((n_rows, P), generator=gen, **f32) < 0.05] = 127
    codes[n_leaf:] = 127
    codes[:, n_pos:] = 127
    W = (codes != 127).float()
    u = torch.rand((n_rows - n_leaf, P), generator=gen, **f32)
    W[n_leaf:] = torch.where(u < 0.05, 0.0, torch.where(u < 0.1, u * 10, 1.0))
    W[:, n_pos:] = 0.0
    f = torch.rand((n_rows, P, C), generator=gen, **f32) ** 4
    V = torch.where(W[..., None] > 0, (f / f.sum(-1, keepdim=True)) @ cf[:C],
                    cf[127])
    V[:n_leaf] = cf[codes[:n_leaf].long()]
    rates = torch.exp(torch.linspace(-math.log(20), math.log(20), 20, **f32))
    ratecat = torch.randint(0, 20, (P,), generator=gen, device=dev,
                            dtype=torch.int32)
    return codes, W, V, MLModel(model == "jc", cf, ev, ei, si, rates, ratecat,
                                n_pos, 2.5e-4, 1e-10)


def check_ml(label, C, model, gen, dev):
    """The three ML kernels against their twins on one store: a tree level
    of 200 pairs (ll and per-site lk), a level of 200 posteriors (on copies
    of the store) and 16 line searches.  Times are of one call each, the
    shape of the serial quartet loop.  Returns {name: (err, ms, plain_ms)}."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    codes, W, V, m = ml_store_case(C, model, gen, dev)
    store = (codes, W, V, m)
    n_rows = codes.shape[0]
    rng = np.random.default_rng(C + len(model))
    r1, r2 = rng.integers(0, n_rows, 200), rng.integers(0, n_rows, 200)
    lens = rng.uniform(0.0, 0.5, 200)
    lens[:3] = (0.0, 5e-4, 6.0)
    out = {}

    ll, lk = mk.ml_pair_loglk(*store, r1, r2, lens, want_lk=True)
    ll_t, lk_t = mk.ml_pair_loglk_ref(*store, r1, r2, lens, want_lk=True)
    ll, ll_t, lk, lk_t = (t.cpu().numpy() for t in (ll, ll_t, lk, lk_t))
    np.testing.assert_allclose(ll, ll_t, rtol=1e-6,
                               err_msg=f"ml_pair_loglk {label} ll")
    np.testing.assert_allclose(lk, lk_t, rtol=1e-6, atol=1e-30,
                               err_msg=f"ml_pair_loglk {label} lk")
    one = (*store, r1[:1], r2[:1], lens[3:4])
    out["ml_pair_loglk"] = (float(np.max(np.abs(ll - ll_t))),
                            median_ms(lambda: mk.ml_pair_loglk(*one)),
                            median_ms(lambda: mk.ml_pair_loglk_ref(*one)))

    targets = np.arange(n_rows - 200, n_rows)
    post = (targets, r1 % MAIN_N + MAIN_N, r2 % MAIN_N, lens + 5e-4,
            lens[::-1] + 5e-4)
    copies = []
    for fn in (mk.ml_posterior, mk.ml_posterior_ref):
        c, w, v = codes.clone(), W.clone(), V.clone()
        fn(c, w, v, m, *post)
        copies.append([t.cpu().numpy() for t in (c, w, v)])
    (c1, w1, v1), (c2, w2, v2) = copies
    np.testing.assert_array_equal(c1, c2, err_msg=f"ml_posterior {label}")
    np.testing.assert_allclose(w1, w2, rtol=0, atol=1e-6,
                               err_msg=f"ml_posterior {label} W")
    np.testing.assert_allclose(v1, v2, rtol=0, atol=1e-6,
                               err_msg=f"ml_posterior {label} V")
    one = (codes.clone(), W.clone(), V.clone(), m, targets[:1],
           post[1][:1], post[2][:1], post[3][:1], post[4][:1])
    out["ml_posterior"] = (
        max(float(np.max(np.abs(w1 - w2))), float(np.max(np.abs(v1 - v2)))),
        median_ms(lambda: mk.ml_posterior(*one)),
        median_ms(lambda: mk.ml_posterior_ref(*one)))

    guesses = np.concatenate([[5e-4, 9e-4, 0.1, 5.0],
                              rng.uniform(0.01, 1.0, 12)])
    opt = (r1[:16], r2[:16], guesses, 5e-4, 6.0, 1e-3, 1e-4)
    x, fx, n_eval = (t.cpu().numpy() for t in mk.ml_opt_branch(*store, *opt))
    x_t, fx_t, _ = (t.cpu().numpy() for t in mk.ml_opt_branch_ref(*store,
                                                                    *opt))
    np.testing.assert_allclose(x, x_t, rtol=1e-4,
                               err_msg=f"ml_opt_branch {label} x")
    np.testing.assert_allclose(fx, fx_t, rtol=0, atol=1e-3,
                               err_msg=f"ml_opt_branch {label} f(x)")
    one = (*store, r1[:1], r2[:1], guesses[2:3], 5e-4, 6.0, 1e-3, 1e-4)
    out["ml_opt_branch"] = (
        max(float(np.max(np.abs(x - x_t))), float(np.max(np.abs(fx - fx_t)))),
        median_ms(lambda: mk.ml_opt_branch(*one)),
        median_ms(lambda: mk.ml_opt_branch_ref(*one)))
    print(f"  line searches [{label}]: {int(n_eval.min())}..{int(n_eval.max())}"
          " evaluations")
    return out


def phase_kernels(report):
    import torch

    from veryfasttree_tpu_torch.ops import scan_kernels as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [
        ("nj_scan_dense", "M=8192 P*C=2048 %different", sk.nj_scan_dense,
         sk.nj_scan_ref, dense_case(4, False, gen, dev)),
        ("nj_scan_dense", "M=8192 P*C=10240 BLOSUM45", sk.nj_scan_dense,
         sk.nj_scan_ref, dense_case(20, True, gen, dev)),
        ("nj_scan_codes", "L=20000 P=512 C=4 %different", sk.nj_scan_codes,
         sk.nj_scan_codes_ref, codes_case(4, False, gen, dev)),
        ("nj_scan_codes", "L=20000 P=512 C=20 BLOSUM45", sk.nj_scan_codes,
         sk.nj_scan_codes_ref, codes_case(20, True, gen, dev)),
    ]
    def record(name, err, ms, plain_ms):
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if "ms" not in entry:         # the first case is the main path's shape
            entry["ms"], entry["plain_ms"] = ms, plain_ms

    for name, shape, kernel, twin, args in cases:
        best, err, ms, plain_ms = check_kernel(name, kernel, twin, args)
        print(f"  {name} [{shape}]: best {best} (tie, lowest index), max abs "
              f"err {err:.3e}, kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
        record(name, err, ms, plain_ms)
    for name, check in (("me_dists", check_dists),
                        ("me_average", check_average)):
        for C, use_matrix, leaf_rows, label in (
                (4, False, 0, "dense 8192x512 C=4"),
                (4, False, 2000, "two-tier 2000 leaves C=4"),
                (20, True, 0, "dense 8192x512 C=20 BLOSUM45")):
            err, ms, plain_ms = check(label, C, use_matrix, leaf_rows, gen,
                                      dev)
            print(f"  {name} [{label}]: max abs err {err:.3e}, kernel "
                  f"{ms:.4f} ms, twin {plain_ms:.4f} ms")
            record(name, err, ms, plain_ms)
    for C, model, label in ((4, "jc", "12008x512 C=4 JC"),
                            (4, "gtr", "12008x512 C=4 GTR"),
                            (20, "jtt", "12008x512 C=20 JTT")):
        for name, (err, ms, plain_ms) in check_ml(label, C, model, gen,
                                                  dev).items():
            print(f"  {name} [{label}]: max abs err {err:.3e}, kernel "
                  f"{ms:.4f} ms, twin {plain_ms:.4f} ms")
            record(name, err, ms, plain_ms)


# ------------------------------------------------------------- phases 3, 4
def fasta_text(codes) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1} (as bench.py)."""
    from bench_e2e import ALPHA

    return "".join(f">s{i}\n{''.join(ALPHA[c] for c in row)}\n"
                   for i, row in enumerate(codes))


def run_port(fasta, dev, **overrides):
    import torch

    from veryfasttree_tpu_torch.options import noml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    out = io.StringIO()
    t0 = time.perf_counter()
    nj, _ = run_pipeline(noml_options(**overrides), io.StringIO(fasta), out,
                         device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out.getvalue(), nj, time.perf_counter() - t0


def counted_run(fasta, dev, **overrides):
    """One run with every launch count set to 0 just before it; the counts
    read just after it."""
    reset_launches()
    nw, nj, wall = run_port(fasta, dev, **overrides)
    return nw, nj, wall, {name: fn.launches for name, fn in wrappers().items()}


def require_launched(label, counts, names):
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")


DENSE_PATH = ("nj_scan_dense", "me_dists", "me_average")


def phase_golden(dev):
    from bench_e2e import synth_codes
    from util import rf_distance

    with open(GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(GOLDEN + ".json") as f:
        golden_len = json.load(f)["total_len"]
    fasta = fasta_text(synth_codes(500, 500, seed=0))
    trees = {}
    for label, overrides, needed in (("dense", {}, DENSE_PATH),
                                     ("two-tier", {"two_tier_min": 0},
                                      DENSE_PATH + ("nj_scan_codes",))):
        nw, nj, wall, counts = counted_run(fasta, dev, **overrides)
        rf, n_splits = rf_distance(nw, golden)
        print(f"  N=500 {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX "
              f"golden, byte-identical {nw == golden}, tree length "
              f"{nj.total_len():.6f} (golden {golden_len:.6f}), launches "
              f"{counts}")
        if rf != 0:
            raise AssertionError(f"{label}: RF {rf} to the golden tree")
        require_launched(label, counts, needed)
        trees[label] = nw
    if trees["dense"] != trees["two-tier"]:
        raise AssertionError("two-tier and dense Newick differ")

    # the same input through the command line, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "n500.fasta")
        with open(path, "w") as f:
            f.write(fasta)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-noml",
             "-nosupport", "-quiet", path], cwd=REPO, capture_output=True,
            text=True, timeout=600, check=False)
    rf = rf_distance(res.stdout, golden)[0] if res.returncode == 0 else None
    print(f"  N=500 command line: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.2f} s, RF {rf} to the JAX golden, "
          f"byte-identical {res.stdout == golden}")
    if res.returncode != 0 or rf != 0:
        raise AssertionError(f"command line: exit {res.returncode}, RF {rf}"
                             f"\n{res.stderr[-2000:]}")


def phase_main(report, dev):
    """The N=2000 cell: a cold run, the warm run whose launches are the main
    path's, and a two-tier run for the codes scan's launches."""
    from bench_e2e import synth_codes
    from util import newick_splits

    n = MAIN_N
    fasta = fasta_text(synth_codes(n, MAIN_P))
    runs = {}
    for label, overrides in (("cold", {}), ("warm", {}),
                             ("two-tier", {"two_tier_min": 0})):
        nw, nj, wall, counts = counted_run(fasta, dev, **overrides)
        t = nj.timings
        length = nj.total_len()
        print(f"  N={n} P={MAIN_P} {label}: wall {wall:.2f} s; NJ store "
              f"{t['store_s']:.3f} s, top-hits {t['tophits_s']:.3f} s, joins "
              f"{t['joins_s']:.3f} s ({(n - 3) / t['joins_s']:.1f} joins/s); "
              f"NNI+SPR {t['nni_spr_s']:.3f} s, lengths {t['lengths_s']:.3f} "
              f"s, split test {t['splits_s']:.3f} s; tree length "
              f"{length:.6f}; launches {counts}")
        _, leaves = newick_splits(nw)
        if len(leaves) != n or not math.isfinite(length):
            raise AssertionError(f"{label}: {len(leaves)} leaves, length "
                                 f"{length}")
        runs[label] = nw
        if label == "warm":                  # the -noml main path's run
            require_launched(label, counts, DENSE_PATH)
            for name, count in counts.items():
                if name not in ML_KERNELS:
                    report.setdefault(name, {})["launches"] = count
        elif label == "two-tier":
            require_launched(label, counts, ("nj_scan_codes",))
            report["nj_scan_codes"]["two_tier_launches"] = \
                counts["nj_scan_codes"]
    if runs["two-tier"] != runs["cold"] or runs["warm"] != runs["cold"]:
        raise AssertionError("the three runs gave different trees")


# ------------------------------------------------------------- phases 5, 6
ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def run_ml(fasta, dev, **overrides):
    """One ML run through run_pipeline with every launch count set to 0
    just before it.  Returns (newick, nj, wall, counts, per-round
    (LogLk, NNIs), final LogLk); the LogLk values are the run's log
    lines."""
    import torch

    from veryfasttree_tpu_torch.options import ml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    out, log = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    nj, _ = run_pipeline(ml_options(**overrides), io.StringIO(fasta), out,
                         log_fp=log, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    text = log.getvalue()
    rounds = [(float(ll), int(n)) for _, ll, n in ROUND.findall(text)]
    return out.getvalue(), nj, wall, counts, rounds, \
        float(FINAL.findall(text)[-1])


def busy_share(trace, wall):
    """(device-busy seconds, share of wall, event count, top kernels) of a
    CUDA-activity trace."""
    import torch

    count, total = collections.Counter(), collections.Counter()
    for evt in trace.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            count[evt.name] += 1
            total[evt.name] += evt.time_range.elapsed_us()
    busy = sum(total.values()) / 1e6
    return busy, busy / wall, sum(count.values()), \
        [(name[:60], count[name], us / 1e3) for name, us
         in total.most_common(6)]


def phase_ml_golden(dev):
    """The default -nt run and -nt -gtr -gamma at N=200 against the JAX
    package's; the default run is traced for the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from bench_e2e import synth_codes
    from util import rf_distance

    fasta = fasta_text(synth_codes(ML_GOLDEN_N, MAIN_P, seed=0))
    for suffix, overrides in (("", {}), ("_gtr_gamma", {
            "use_gtr": True, "gamma_loglk": True})):
        with open(ML_GOLDEN + suffix + ".nwk") as f:
            golden = f.read()
        with open(ML_GOLDEN + suffix + ".json") as f:
            meta = json.load(f)
        label = f"N={ML_GOLDEN_N} {'-gtr -gamma' if suffix else 'default -nt'}"
        if suffix:
            nw, nj, wall, counts, rounds, final = run_ml(fasta, dev,
                                                         **overrides)
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                nw, nj, wall, counts, rounds, final = run_ml(fasta, dev)
            busy, share, n_events, top = busy_share(trace, wall)
            print(f"  {label} under torch.profiler: device busy {busy:.3f} s "
                  f"of {wall:.2f} s wall ({100 * share:.2f}%), {n_events} "
                  f"device events; top {top}")
        rf, n_splits = rf_distance(nw, golden)
        rel = abs(final - meta["final_loglk"]) / abs(meta["final_loglk"])
        diffs = [round(a[0] - b, 3) for a, b in zip(rounds,
                                                    meta["round_loglk"])]
        print(f"  {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX golden, "
              f"final LogLk {final:.3f} (golden {meta['final_loglk']:.3f}, "
              f"rel diff {rel:.2e}); ML-NNIs per round {[r[1] for r in rounds]}"
              f" (golden {meta['round_nnis']}); per-round LogLk - golden "
              f"{diffs}; launches {counts}")
        if rf != 0 or not rel <= 1e-4:
            raise AssertionError(f"{label}: RF {rf}, final LogLk rel diff "
                                 f"{rel:.2e}")

    # the default run through the command line, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "n200.fasta")
        with open(path, "w") as f:
            f.write(fasta)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-quiet",
             path], cwd=REPO, capture_output=True, text=True, timeout=600,
            check=False)
    with open(ML_GOLDEN + ".nwk") as f:
        golden = f.read()
    rf = rf_distance(res.stdout, golden)[0] if res.returncode == 0 else None
    print(f"  N={ML_GOLDEN_N} command line -nt: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.2f} s, RF {rf} to the JAX golden")
    if res.returncode != 0 or rf != 0:
        raise AssertionError(f"command line: exit {res.returncode}, RF {rf}"
                             f"\n{res.stderr[-2000:]}")


def phase_ml_main(report, dev):
    """The default -nt run at N=2000: the ML main path."""
    from bench_e2e import synth_codes
    from util import newick_splits

    n = MAIN_N
    nw, nj, wall, counts, rounds, final = run_ml(
        fasta_text(synth_codes(n, MAIN_P)), dev)
    t = nj.timings
    nj_s = t["store_s"] + t["tophits_s"] + t["joins_s"]
    print(f"  N={n} P={MAIN_P} default -nt: wall {wall:.2f} s; NJ {nj_s:.3f} "
          f"s, ME NNI+SPR {t['nni_spr_s']:.3f} s, ME lengths "
          f"{t['lengths_s']:.3f} s, ML lengths {t['ml_lengths_s']:.3f} s, ML "
          f"NNI {t['ml_nni_s']:.3f} s ({len(rounds)} rounds), CAT "
          f"{t['cat_s']:.3f} s, SH {t['sh_s']:.3f} s; final LogLk "
          f"{final:.3f}; ML-NNIs per round {[r[1] for r in rounds]}; "
          f"launches {counts}")
    _, leaves = newick_splits(nw)
    if len(leaves) != n or not math.isfinite(final):
        raise AssertionError(f"{len(leaves)} leaves, final LogLk {final}")
    require_launched("ML main path", counts, DENSE_PATH + ML_KERNELS)
    for name, count in counts.items():
        key = "launches" if name in ML_KERNELS else "ml_path_launches"
        report.setdefault(name, {})[key] = count


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "veryfasttree_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (no "
              "veryfasttree_tpu_torch/ beside it)", file=sys.stderr)
        return 2
    for sub in ("", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    from veryfasttree_tpu_torch.ops import _build

    failed = []
    report = {}

    def phase(label, fn, *a):
        print(f"[{label}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*a)
        except Exception:  # noqa: BLE001 -- report, go on, fail at the end
            traceback.print_exc()
            failed.append(label)
        print(f"[{label}] {'FAILED' if label in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def card():
        print(f"  {card_line()}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s)")
        torch.use_deterministic_algorithms(True)

    def build():
        t0 = time.perf_counter()
        path, log = _build.build()
        print(f"  built {os.path.relpath(path, REPO)} in "
              f"{time.perf_counter() - t0:.1f} s")
        print("\n".join("  " + line for line in log.splitlines()
                        if "registers" in line or "Function properties" in line
                        or "Compiling entry" in line))
        _build.library()

    phase("0 card", card)
    phase("1 build", build)
    if "1 build" not in failed:
        phase("2 kernels vs twins", phase_kernels, report)
        cuda = torch.device("cuda")
        phase("3 N=500 vs JAX golden", phase_golden, cuda)
        phase(f"4 main path N={MAIN_N}", phase_main, report, cuda)
        phase(f"5 ML N={ML_GOLDEN_N} vs JAX golden", phase_ml_golden, cuda)
        phase(f"6 ML main path N={MAIN_N}", phase_ml_main, report, cuda)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **report[name]}
               for name, (source, replaces) in KERNELS.items()]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
