"""Likelihood kernels of the ML profile store: the CUDA kernels of
``csrc/ml_lk.cu`` and their plain PyTorch twins.

The ML phase's host loops (quartet NNIs, branch-length passes, split tests)
ask the store for one pair log-likelihood, one posterior profile or one
branch-length optimization at a time, hundreds of thousands of times in a
run.  The JAX package compiles each into one XLA computation
(``veryfasttree_tpu/engine/ml_profiles.py``: ``_pair_loglk``,
``_pair_loglk_rows``, ``_posterior_into``, ``_posterior_rows``,
``_posterior_sweep``, ``_opt_branch_len``); here each is one kernel launch
whose row indices and lengths travel in the launch's parameters:

* ``ml_pair_loglk``: K row pairs at given lengths -> the pair log-likelihood
  (float64 sums of float32 per-site logs) and, on request, the per-site
  likelihoods;
* ``ml_posterior``: K (target, r1, r2, len1, len2) -> the posterior parent
  profile of rows r1 and r2, written into row target in place;
* ``ml_opt_branch``: K row pairs -> the whole bracketing + Brent line search
  over the branch length (``_onedimenmin_device``), one block per branch,
  in float32 with the JAX package's constants and update rules.

Store layout (``engine/ml_profiles.py``): codes int8 [n_rows, P], W float32
[n_rows, P], V float32 [n_rows, P, C] raw (unmixed) rotated vectors.  The
model constants travel in an ``MLModel``.

As for the other kernels, a wrapper runs the twin for tensors on the CPU
and launches its kernel for tensors on a CUDA device; anything else raises
(no fallback), and ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from veryfasttree_tpu.constants import NOCODE

from . import _build, kernels

_C_CODES = (4, 20)
MAX_RATES = 32          # rate categories a kernel takes (CAT uses 20)

F32 = np.float32
_CGOLD = F32(0.3819660)
_ZEPS = F32(1.0e-10)
_BRENT_ITMAX = 100


@dataclass
class MLModel:
    """Model constants of an ML store, on the store's device.  code_freq
    [NOCODE + 1, C]: rows 0..C-1 the rotated one-hots, row NOCODE the gap
    vector (matrix mode); rates [n_rates] float32; ratecat [P] int32."""
    jc: bool
    code_freq: torch.Tensor
    eigenval: torch.Tensor
    eigeninv: torch.Tensor
    statinv: torch.Tensor
    rates: torch.Tensor
    ratecat: torch.Tensor
    n_pos: int
    min_rel_len: float
    tol: float


def _index(rows, device):
    return torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)


def _f32(vals, device):
    return torch.as_tensor(np.asarray(vals, dtype=np.float32), device=device)


def _effective(codes, W, V, rows, m, for_posterior):
    """(effective vectors [K, P, C], weights [K, P]) of rows."""
    w = W[rows]
    return kernels.ml_effective(codes[rows], w, V[rows], m.code_freq,
                                for_posterior, m.jc), w


def _pair_ll(f1, w1, f2, w2, lens, m):
    """(ll [K] float64, lk [K, P]) of effective vectors at lengths [K]."""
    lens = lens[:, None]
    mask = torch.arange(f1.shape[-2], device=f1.device) < m.n_pos
    if m.jc:
        ps, pd = kernels.p_same_diff(lens, m.rates)
        return kernels.pair_loglk_jc(f1, f2, ps, pd, m.ratecat.long(), mask)
    ee = kernels.exp_eigen_rates(lens, m.rates, m.eigenval, m.min_rel_len)
    return kernels.pair_loglk_matrix(f1, f2, w1, w2, ee, m.ratecat.long(),
                                     mask)


# ---------------------------------------------------------------- twins
def ml_pair_loglk_ref(codes, W, V, m, r1s, r2s, lengths, want_lk=False):
    """Plain twin of ml_pair_loglk."""
    dev = codes.device
    f1, w1 = _effective(codes, W, V, _index(r1s, dev), m, False)
    f2, w2 = _effective(codes, W, V, _index(r2s, dev), m, False)
    ll, lk = _pair_ll(f1, w1, f2, w2, _f32(lengths, dev), m)
    return ll, (lk if want_lk else None)


def ml_posterior_ref(codes, W, V, m, targets, r1s, r2s, len1s, len2s):
    """Plain twin of ml_posterior."""
    dev = codes.device
    f1, w1 = _effective(codes, W, V, _index(r1s, dev), m, True)
    f2, w2 = _effective(codes, W, V, _index(r2s, dev), m, True)
    l1 = _f32(len1s, dev)[:, None]
    l2 = _f32(len2s, dev)[:, None]
    rc = m.ratecat.long()
    if m.jc:
        ps1, pd1 = kernels.p_same_diff(l1, m.rates)
        ps2, pd2 = kernels.p_same_diff(l2, m.rates)
        w_out, v_out = kernels.posterior_jc(f1, f2, w1, w2, ps1, pd1, ps2,
                                            pd2, rc)
        gap = torch.full((V.shape[-1],), 0.25, dtype=V.dtype, device=dev)
    else:
        C = V.shape[-1]
        ee1 = kernels.exp_eigen_rates(l1, m.rates, m.eigenval, m.min_rel_len)
        ee2 = kernels.exp_eigen_rates(l2, m.rates, m.eigenval, m.min_rel_len)
        w_out, v_out = kernels.posterior_matrix(
            f1, f2, w1, w2, ee1, ee2, rc, m.code_freq[:C], m.eigeninv,
            m.statinv, m.tol)
        gap = m.code_freq[NOCODE]
    v_out = torch.where(w_out[..., None] > 0, v_out, gap)
    t = _index(targets, dev)
    codes[t] = NOCODE
    W[t] = w_out
    V[t] = v_out


def onedimenmin_f32(neg, guess, xmin, xmax, ftol, atol):
    """Bracketing + Brent in float32, step for step the JAX package's
    ``_onedimenmin_device`` (ref onedimenmin/brent tcc:7024-7178).  `neg`
    maps a float32 length to a float32 value.  Returns (x, f(x),
    evaluations)."""
    guess, xmin, xmax, ftol, atol = (F32(v) for v in
                                     (guess, xmin, xmax, ftol, atol))
    two, half = F32(2.0), F32(0.5)
    n_eval = 0

    def f(x):
        nonlocal n_eval
        n_eval += 1
        return F32(neg(x))

    if guess == xmin:
        ax, bx, cx = xmin, two * guess, F32(10.0) * guess
    elif guess <= two * xmin:
        ax, bx, cx = xmin, guess, F32(5.0) * guess
    else:
        ax, bx, cx = half * guess, guess, two * guess
    cx = min(cx, xmax)
    if bx >= cx:
        bx = half * (ax + cx)
    fa, fb, fc = f(ax), f(bx), f(cx)
    while fa < fb and ax > xmin:
        ax = (ax + xmin) / two
        if ax < two * xmin:
            ax = xmin
        fa = f(ax)
    while fc < fb and cx < xmax:
        cx = (cx + xmax) / two
        if cx > xmax * F32(0.95):
            cx = xmax
        fc = f(cx)

    a, b = min(ax, cx), max(ax, cx)
    x, fx = bx, fb
    if fa < fc:
        w, fw, v, fv = ax, fa, cx, fc
    else:
        w, fw, v, fv = cx, fc, ax, fa
    d = e = F32(0.0)
    for _ in range(_BRENT_ITMAX):
        xm = half * (a + b)
        tol1 = ftol * abs(x)
        tol2 = two * (tol1 + _ZEPS)
        if abs(x - xm) <= (tol2 - half * (b - a)) or abs(a - b) < atol:
            break
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        # one rounding, as the JAX package's compiled line search fuses it
        p = F32(np.float64(x - v) * np.float64(q) - np.float64((x - w) * r))
        q2 = two * (q - r)
        if q2 > 0:
            p = -p
        q2 = abs(q2)
        golden = (abs(p) >= abs(half * q2 * e) or p <= q2 * (a - x)
                  or p >= q2 * (b - x) or abs(e) <= tol1)
        e_gold = a - x if x >= xm else b - x
        if golden:
            d, e = _CGOLD * e_gold, e_gold
        else:
            d_par = p / (q2 if q2 != 0 else F32(1.0))
            u_par = x + d_par
            if u_par - a < tol2 or b - u_par < tol2:
                d_par = tol1 if xm - x >= 0 else -tol1
            d, e = d_par, d
        u = x + d if abs(d) >= tol1 else x + (tol1 if d >= 0 else -tol1)
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, fv, w, fw, x, fx = w, fw, x, fx, u, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv, w, fw = w, fw, u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx, n_eval


def ml_opt_branch_ref(codes, W, V, m, r1s, r2s, guesses, xmin, xmax, ftol,
                      atol):
    """Plain twin of ml_opt_branch: the same line search, driven from the
    host, over the plain pair log-likelihood."""
    dev = codes.device
    f1, w1 = _effective(codes, W, V, _index(r1s, dev), m, False)
    f2, w2 = _effective(codes, W, V, _index(r2s, dev), m, False)
    out = []
    for k, guess in enumerate(np.asarray(guesses, dtype=np.float32)):
        def neg(x, k=k):
            ll, _ = _pair_ll(f1[k:k + 1], w1[k:k + 1], f2[k:k + 1],
                             w2[k:k + 1], _f32([x], dev), m)
            return -F32(ll.item())
        out.append(onedimenmin_f32(neg, guess, xmin, xmax, ftol, atol))
    xs, fxs, evals = zip(*out) if out else ((), (), ())
    return (_f32(xs, dev), _f32(fxs, dev),
            torch.as_tensor(np.asarray(evals, dtype=np.int32), device=dev))


# ---------------------------------------------------------------- kernels
def _check_store(codes, W, V, m):
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"ML kernels run on CPU or CUDA tensors, not {dev}")
    n_rows, P = codes.shape
    C = V.shape[-1]
    if C not in _C_CODES:
        raise ValueError(f"ML kernels take {_C_CODES} codes, got {C}")
    if codes.dtype != torch.int8 or W.dtype != torch.float32 \
            or V.dtype != torch.float32:
        raise ValueError("ML kernels need an int8 code array and a float32 "
                         "store (no -double-precision on CUDA)")
    if tuple(W.shape) != (n_rows, P) or tuple(V.shape) != (n_rows, P, C):
        raise ValueError("store arrays do not share one layout")
    n_rates = m.rates.shape[0]
    if not 1 <= n_rates <= MAX_RATES:
        raise ValueError(f"ML kernels take 1..{MAX_RATES} rate categories, "
                         f"got {n_rates}")
    shapes = ((m.code_freq, torch.float32, (NOCODE + 1, C)),
              (m.eigenval, torch.float32, (C,)),
              (m.eigeninv, torch.float32, (C, C)),
              (m.statinv, torch.float32, (C,)),
              (m.rates, torch.float32, (n_rates,)),
              (m.ratecat, torch.int32, (P,)))
    for t, dtype, shape in shapes:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"model constant: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (codes, W, V) + tuple(s[0] for s in shapes):
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("store and model arrays must be contiguous on "
                             "one device")
    return n_rows, P, C, n_rates


def _store_args(codes, W, V, m):
    n_rows, P, C, n_rates = _check_store(codes, W, V, m)
    return [codes.data_ptr(), W.data_ptr(), V.data_ptr(),
            m.code_freq.data_ptr(), m.eigenval.data_ptr(),
            m.eigeninv.data_ptr(), m.statinv.data_ptr(), m.rates.data_ptr(),
            m.ratecat.data_ptr(), n_rows, P, C, int(m.n_pos), n_rates,
            int(bool(m.jc)), ctypes.c_float(m.min_rel_len)]


def _raise_on(rc, name):
    """The C entries return 0, a cudaError of the launch, or -1 for a row
    index outside the store (checked before anything is launched)."""
    if rc == -1:
        raise IndexError(f"{name}: a row index lies outside the store")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ml_pair_loglk(codes, W, V, m, r1s, r2s, lengths, want_lk=False):
    """Pair log-likelihoods of rows (r1s[k], r2s[k]) at lengths[k] (ref
    pairLogLk tcc:1192-1447; host arrays).  Returns (ll [K] float64, lk
    [K, P] float32 per-site likelihoods, or None without want_lk), on the
    store's device."""
    if codes.device.type == "cpu":
        return ml_pair_loglk_ref(codes, W, V, m, r1s, r2s, lengths, want_lk)
    args = _store_args(codes, W, V, m)
    dev = codes.device
    K = len(r1s)
    if len(r2s) != K or len(lengths) != K:
        raise ValueError("r1s, r2s and lengths differ in length")
    rows = np.concatenate([r1s, r2s]).astype(np.int32)
    lens = np.asarray(lengths, dtype=np.float32)
    ll = torch.empty(K, dtype=torch.float64, device=dev)
    lk = torch.empty((K, codes.shape[1]), dtype=torch.float32, device=dev) \
        if want_lk else None
    if K:
        _raise_on(_build.library().vft_ml_pair_loglk_f32(
            *args, rows.ctypes.data, lens.ctypes.data, K, ll.data_ptr(),
            lk.data_ptr() if want_lk else None, _stream(dev)),
            "ml_pair_loglk")
        ml_pair_loglk.launches += 1
    return ll, lk


ml_pair_loglk.launches = 0


def ml_posterior(codes, W, V, m, targets, r1s, r2s, len1s, len2s):
    """Posterior profiles (ref posteriorProfile tcc:2137-2447) of rows
    (r1s[k], r2s[k]) across lengths (len1s[k], len2s[k]), written into rows
    targets[k] in place: codes NOCODE, weight 0 at both-gap positions (which
    get the gap vector), 1 elsewhere.  Every row is read before any is
    written, so no target may be another item's source.  The matrix path is
    the exact one (no -approxml rough posteriors)."""
    targets = np.asarray(targets, dtype=np.int64)
    if len(targets) > 1 and (len(np.unique(targets)) != len(targets)
                             or np.isin(targets, [r1s, r2s]).any()):
        raise ValueError("ml_posterior: targets must be distinct and not "
                         "sources")
    if codes.device.type == "cpu":
        return ml_posterior_ref(codes, W, V, m, targets, r1s, r2s, len1s,
                                len2s)
    args = _store_args(codes, W, V, m)
    K = len(targets)
    if not len(r1s) == len(r2s) == len(len1s) == len(len2s) == K:
        raise ValueError("targets, rows and lengths differ in length")
    if K == 0:
        return
    rows = np.concatenate([targets, r1s, r2s]).astype(np.int32)
    lens = np.concatenate([len1s, len2s]).astype(np.float32)
    _raise_on(_build.library().vft_ml_posterior_f32(
        *args, ctypes.c_float(m.tol), rows.ctypes.data, lens.ctypes.data, K,
        _stream(codes.device)), "ml_posterior")
    ml_posterior.launches += 1


ml_posterior.launches = 0


def ml_opt_branch(codes, W, V, m, r1s, r2s, guesses, xmin, xmax, ftol, atol):
    """Maximum-likelihood length of the branch between rows r1s[k] and
    r2s[k], from guesses[k]: bracketing + Brent in float32 (ref
    onedimenmin/brent tcc:7024-7178, the JAX package's
    _onedimenmin_device).  Returns (x [K] float32, -loglk at x [K] float32,
    evaluations [K] int32) on the store's device."""
    if codes.device.type == "cpu":
        return ml_opt_branch_ref(codes, W, V, m, r1s, r2s, guesses, xmin,
                                 xmax, ftol, atol)
    args = _store_args(codes, W, V, m)
    dev = codes.device
    K = len(r1s)
    if len(r2s) != K or len(guesses) != K:
        raise ValueError("r1s, r2s and guesses differ in length")
    rows = np.concatenate([r1s, r2s]).astype(np.int32)
    guess = np.asarray(guesses, dtype=np.float32)
    x = torch.empty(K, dtype=torch.float32, device=dev)
    fx = torch.empty(K, dtype=torch.float32, device=dev)
    n_eval = torch.empty(K, dtype=torch.int32, device=dev)
    if K:
        lib = _build.library()
        P, C = codes.shape[1], V.shape[-1]
        scratch = None
        if not lib.vft_ml_opt_branch_fits_smem(P, C):
            # effective vectors in device memory where they exceed shared
            scratch = torch.empty((K, 2, P, C), dtype=torch.float32,
                                  device=dev)
        _raise_on(lib.vft_ml_opt_branch_f32(
            *args, rows.ctypes.data, guess.ctypes.data, K,
            ctypes.c_float(xmin), ctypes.c_float(xmax), ctypes.c_float(ftol),
            ctypes.c_float(atol), x.data_ptr(), fx.data_ptr(),
            n_eval.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            _stream(dev)), "ml_opt_branch")
        ml_opt_branch.launches += 1
    return x, fx, n_eval


ml_opt_branch.launches = 0
