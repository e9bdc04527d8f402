"""Likelihood kernels of the ML profile store: the CUDA kernels of
``csrc/ml_lk.cu`` and their plain PyTorch twins.

The ML phase asks the store for pair log-likelihoods, posterior profiles,
branch-length optimizations and quartet optimizations.  The JAX package
compiles each into one XLA computation (``veryfasttree_tpu/engine/
ml_profiles.py``: ``_pair_loglk``, ``_pair_loglk_rows``, ``_posterior_into``,
``_posterior_rows``, ``_posterior_sweep``, ``_opt_branch_len``); here each
is one kernel launch over a list of any length K: the host's row indices,
lengths and targets reach device memory in one copy, and the grid runs
over the list:

* ``ml_pair_loglk``: K row pairs at given lengths -> the pair log-likelihood
  (float64 sums of float32 per-site logs) and, on request, the per-site
  likelihoods;
* ``ml_posterior``: K (target, r1, r2, len1, len2) -> the posterior parent
  profile of rows r1 and r2, written into row target in place;
* ``ml_opt_branch``: K row pairs -> the whole bracketing + Brent line search
  over the branch length (``_onedimenmin_device``), one block per branch,
  in float32 with the JAX package's constants and update rules;
* ``ml_quartet_opt``: K quartets -> a whole quartet optimization
  (``ml_quartet_optimize``: seven posteriors, five line searches, the star
  test, the closing pair log-likelihoods) per block, its temporaries in
  shared memory, bit for bit the chain of the three calls above
  (``quartet_chain``), with one fetch of its results.

Each item of a list runs the body and thread map it runs alone, so its
bits do not depend on K (the card tests hold K = 300 and K = 200 to K = 1).

``ml_posterior`` and ``ml_opt_branch`` also take lists whose lengths are
read from a float32 tensor of branch lengths on the device (``bl=``), the
line searches writing their results back into it: the -threads > 1
lengths pass (engine/batched.py) keeps its lengths on the card from its
first level to its last.

Two kernels of ``csrc/ml_sweep.cu`` take a whole tree in one launch, over
level tables that reach the device once (``SweepTables``,
``LoglkTables``; engine/ml_profiles.TreeSweep builds them for a tree):

* ``ml_posterior_sweep``: a dependency-ordered sweep of posteriors, level
  after level (the JAX package's ``_posterior_sweep``), each row bit for
  bit what ``ml_posterior``'s per-level launches write;
* ``ml_tree_loglk``: a tree's log-likelihood (treeLogLk): every level's
  pairs, the root's 3-way term, and the float64 total and per-site sums,
  on the device.

Their twins run the per-level twins over the same tables.

Store layout (``engine/ml_profiles.py``): codes int8 [n_rows, P], W float32
[n_rows, P], V float32 [n_rows, P, C] raw (unmixed) rotated vectors.  The
model constants travel in an ``MLModel``.

As for the other kernels, a wrapper runs the twin for tensors on the CPU
and launches its kernel for tensors on a CUDA device; anything else raises
(no fallback), and ``launches`` counts its kernel launches.  A store and its
model are checked once (``_bind``), and the wrappers reuse that binding's
arguments, stream and buffers.
"""
from __future__ import annotations

import collections
import ctypes
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (APPROX_ML_MIN_F, APPROX_ML_MIN_RATIO,
                         CLOSE_LOGLK_LIMIT, NOCODE)

from . import _build, kernels
from .dataflow import (LevelTables, align16, build_chains, check_chains,
                       typed, workspace)

_C_CODES = (4, 20)
MAX_RATES = 32          # rate categories a kernel takes (CAT uses 20)
GROUP_ROWS = 64         # pairs of a tree log-likelihood's level group
# a sweep of more chains than this cuts a chain longer than SPLIT_LEN into
# three segments (at least SEGMENT_MIN items each): its units then outnumber
# the card's resident blocks, and the first segment of the critical path is
# listed (so started) right after the chains it reads
SPLIT_CHAINS, SPLIT_LEN, SEGMENT_MIN = 64, 16, 8
# device scratch a quartet list may take at once where a quartet's
# temporaries leave shared memory (20 codes: 258 KB a quartet at P=512, so
# a launch takes at most 16,644 quartets there)
QUARTET_SCRATCH_BYTES = 4 << 30

F32 = np.float32
_CGOLD = F32(0.3819660)
_ZEPS = F32(1.0e-10)
_BRENT_ITMAX = 100


@dataclass
class MLModel:
    """Model constants of an ML store, on the store's device.  code_freq
    [NOCODE + 1, C]: rows 0..C-1 the rotated one-hots, row NOCODE the gap
    vector (matrix mode); rates [n_rates] float32; ratecat [P] int32.
    near_p, near_freq [C, C] float32: the -approxml rough posteriors'
    tables (TransitionMatrix.near_p, near_freq; zeros by default), taken
    where approx is set; counts int64 [2]: the positions of the posteriors
    computed so far that took the rough and the exact path (ref
    nAAPosteriorRough/Exact; 20 codes only), added to on the device by
    every posterior kernel and twin."""
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
    near_p: torch.Tensor = None
    near_freq: torch.Tensor = None
    approx: bool = False
    counts: torch.Tensor = None

    def __post_init__(self):
        C, dev = self.eigenval.shape[0], self.eigenval.device
        if self.near_p is None:
            self.near_p = torch.zeros((C, C), dtype=self.eigenval.dtype,
                                      device=dev)
        if self.near_freq is None:
            self.near_freq = torch.zeros_like(self.near_p)
        if self.counts is None:
            self.counts = torch.zeros(2, dtype=torch.int64, device=dev)

    def gate(self):
        """posterior_matrix's approx argument: the rough-posterior gate's
        tables and limits, or None for the exact path."""
        if not self.approx:
            return None
        return (self.near_p, self.near_freq, APPROX_ML_MIN_F,
                APPROX_ML_MIN_RATIO)


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


def ml_posterior_ref(codes, W, V, m, targets, r1s, r2s, len1s, len2s,
                     weights=None):
    """Plain twin of ml_posterior; weights [K], the times each item's
    positions count in m.counts (1 each by default)."""
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
        w_out, v_out, n_rough, n_exact = kernels.posterior_matrix(
            f1, f2, w1, w2, ee1, ee2, rc, m.code_freq[:C], m.eigeninv,
            m.statinv, m.tol, m.gate())
        n = torch.stack([n_rough, n_exact], dim=-1)
        if weights is not None:
            n = n * torch.as_tensor(np.asarray(weights, dtype=np.int64),
                                    device=dev)[:, None]
        m.counts += n.sum(0)
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


QUARTET_RECORD = np.dtype([("parts", "<f8", (3,)), ("len", "<f4", (5,)),
                           ("star", "<i4"), ("n_eval", "<i4"),
                           ("pad", "<i4", (3,))])
"""One quartet optimization's result (csrc/ml_lk.cu QuartetOut): parts, the
-log-likelihood of the last line search negated and two pair
log-likelihoods (after a star: those of pairs AB and CD); len, the searched
lengths A, B, C, D, I (only I after a star); star; n_eval, the evaluations
of its line searches."""


def quartet_chain(post, opt, pair, codes, W, V, m, rows4, lengths,
                  scratch_rows, xmin, xmax, ftol, atol, star_test=False,
                  want_site_lk=False):
    """ml_quartet_opt as the chain of single calls it fuses (ref
    MLQuartetOptimize tcc:1650-1788): post, opt and pair are ml_posterior,
    ml_opt_branch and ml_pair_loglk, or their twins; the six temporaries are
    the store rows scratch_rows (S_AB, S_CD, S_BCD, S_ACD, S_ABD, S_ABC),
    which the chain overwrites.  Lengths are float64 and round to float32
    where each call takes them, as in the host loop.  Returns what
    ml_quartet_opt returns."""
    store = (codes, W, V, m)
    s_ab, s_cd, s_bcd, s_acd, s_abd, s_abc = (int(r) for r in scratch_rows)
    lo = F32(xmin)
    K, P = len(rows4), codes.shape[1]
    rec = np.zeros(K, QUARTET_RECORD)
    site = np.zeros((K, 3, P), dtype=np.float32) if want_site_lk else None

    def posterior(t, r1, r2, len1, len2):
        post(*store, [t], [r1], [r2], np.maximum(np.float32([len1]), lo),
             np.maximum(np.float32([len2]), lo))

    def search(r1, r2, guess):
        x, fx, n_eval = opt(*store, [r1], [r2], [guess], xmin, xmax, ftol,
                            atol)
        x, fx, n_eval = torch.stack((x, fx, n_eval.float()))[:, 0].tolist()
        return x, fx, int(n_eval)

    def loglk(r1, r2, length, lk_out=None):
        ll, lk = pair(*store, [r1], [r2], [length], lk_out is not None)
        if lk_out is not None:
            lk_out[:] = lk[0].cpu().numpy()
        return float(ll[0])

    for k in range(K):
        a, b, c, d = (int(r) for r in rows4[k])
        ln = [float(v) for v in lengths[k]]        # A, B, C, D, I
        posterior(s_ab, a, b, ln[0], ln[1])
        posterior(s_cd, c, d, ln[2], ln[3])
        ln[4], fx, n_eval = search(s_ab, s_cd, ln[4])
        star = star_test and loglk(s_ab, s_cd, xmin) < -fx - CLOSE_LOGLK_LIMIT
        if star:
            parts = (-fx, loglk(a, b, ln[0] + ln[1]),
                     loglk(c, d, ln[2] + ln[3]))
        else:
            evals = [n_eval]
            posterior(s_bcd, b, s_cd, ln[1], ln[4])
            ln[0], _, n = search(a, s_bcd, ln[0])
            evals.append(n)
            posterior(s_acd, a, s_cd, ln[0], ln[4])
            ln[1], _, n = search(b, s_acd, ln[1])
            evals.append(n)
            posterior(s_ab, a, b, ln[0], ln[1])
            posterior(s_abd, s_ab, d, ln[4], ln[3])
            ln[2], _, n = search(c, s_abd, ln[2])
            evals.append(n)
            posterior(s_abc, s_ab, c, ln[4], ln[2])
            ln[3], fx, n = search(d, s_abc, ln[3])
            evals.append(n)
            n_eval = sum(evals)
            lk = site[k] if want_site_lk else (None, None, None)
            if want_site_lk:
                loglk(s_abc, d, ln[3], lk[0])
            parts = (-fx, loglk(s_ab, c, ln[4] + ln[2], lk[1]),
                     loglk(a, b, ln[0] + ln[1], lk[2]))
        rec[k] = (parts, ln, int(star), n_eval, (0, 0, 0))
    return rec, site


def ml_quartet_opt_ref(codes, W, V, m, rows4, lengths, scratch_rows, xmin,
                       xmax, ftol, atol, star_test=False, want_site_lk=False):
    """Plain twin of ml_quartet_opt: the chain of the three twins, on the
    store's scratch rows."""
    return quartet_chain(ml_posterior_ref, ml_opt_branch_ref,
                         ml_pair_loglk_ref, codes, W, V, m, rows4, lengths,
                         scratch_rows, xmin, xmax, ftol, atol, star_test,
                         want_site_lk)


# ---------------------------------------------------------- level tables
class SweepTables(LevelTables):
    """A dependency-ordered posterior sweep: per item, the target row, the
    source rows r1, r2 and their lengths len1, len2 (float32, raised to
    the minimum length as the store raises them); and the items of earlier
    levels that write r1 and r2 (prod1, prod2, -1 for none).  Targets are
    distinct and no level reads a row that it or a later level writes
    (checked here), so the level-by-level order and any order that runs
    each item after its producers give the same rows.  weights: the times
    each item's positions count in the model's rough/exact counts (1 each
    by default; the SH pass's up-profiles, which the host loop computes
    again after resets, more).

    chains: the kernel's order (dataflow.build_chains, checked by
    dataflow.check_chains): chains of items each reading the previous
    one's target, a chain reading other chains only where they come before
    it; with more than SPLIT_CHAINS chains, one longer than SPLIT_LEN is
    cut into segments."""

    fields = ("targets", "r1", "r2", "len1", "len2")
    row_fields = fields[:3]

    def __init__(self, offsets, targets, r1, r2, len1, len2, weights=None):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.targets, self.r1, self.r2 = (np.asarray(a, dtype=np.int64)
                                          for a in (targets, r1, r2))
        self.len1, self.len2 = (np.asarray(a, dtype=np.float32)
                                for a in (len1, len2))
        self.weights = np.ones(len(self.targets), dtype=np.int64) \
            if weights is None else np.asarray(weights, dtype=np.int64)
        if self.weights.shape != self.targets.shape:
            raise ValueError("posterior sweep: one weight an item")
        self.prod1, self.prod2 = self.producers_of(
            "posterior sweep", self.targets, self.r1, self.r2)
        self.n_items = len(self.targets)
        self.chains = build_chains(self.offsets, self.prod1, self.prod2)
        longest = int(np.diff(self.chains.starts).max()) \
            if self.n_items else 0
        if self.chains.n_chains > SPLIT_CHAINS and longest > SPLIT_LEN:
            self.chains = build_chains(self.offsets, self.prod1, self.prod2,
                                       max(SEGMENT_MIN, -(-longest // 3)))
        check_chains(self.chains, self.prod1, self.prod2)
        self._on = {}

    def kernel_arrays(self):
        ch = self.chains
        o = ch.order
        return {"rows": np.concatenate([
                    self.targets[o], self.r1[o], self.r2[o], ch.wait1[o],
                    ch.wait2[o], ch.slot[o], ch.side[o], self.weights[o]])
                .astype(np.int32),
                "lens": np.concatenate([self.len1[o], self.len2[o]]),
                "chains": ch.starts.astype(np.int32)}


class LoglkTables(LevelTables):
    """A tree log-likelihood: per level, its pairs of rows r1, r2 at length
    len (float32), in list order; and the root's 3-way term, root = (s_ab,
    c0, c1, c2, l0, l1, l2): the posterior of rows c0, c1 at l0, l1
    (raised to the minimum length) into row s_ab, then the pair of s_ab
    and c2 at l2; or None.  The kernel takes the root's term as a last
    level of one pair (segments), and sums the levels in groups of at most
    GROUP_ROWS pairs (a wider level alone: groups)."""

    fields = ("r1", "r2", "len")
    row_fields = fields[:2]

    def __init__(self, offsets, r1, r2, lens, root=None):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.r1, self.r2 = (np.asarray(a, dtype=np.int64) for a in (r1, r2))
        self.len = np.asarray(lens, dtype=np.float32)
        self.root = root
        self.n_pairs = len(self.r1)
        self._on = {}

    def _rows(self):
        rows = super()._rows()
        return rows if self.root is None else np.concatenate(
            [rows, np.asarray(self.root[:4], dtype=np.int64)])

    def segments(self):
        """The levels' offsets [n_seg + 1], the root's term a last level of
        one pair (row n_pairs)."""
        return self.offsets if self.root is None else np.concatenate(
            [self.offsets, [self.n_pairs + 1]])

    def groups(self):
        """Each level group's first segment [n_groups + 1]: runs of
        segments of at most GROUP_ROWS pairs, a wider segment alone."""
        sizes = np.diff(self.segments())
        at, acc = [0], 0
        for i, size in enumerate(sizes):
            if acc and acc + size > GROUP_ROWS:
                at.append(i)
                acc = 0
            acc += size
        return np.asarray(at + [len(sizes)], dtype=np.int64)

    def kernel_arrays(self):
        return {"seg": self.segments().astype(np.int32),
                "group": self.groups().astype(np.int32),
                "rows": np.concatenate([self.r1, self.r2]).astype(np.int32),
                "lens": self.len}


def ml_posterior_sweep_ref(codes, W, V, m, tables):
    """Plain twin of ml_posterior_sweep: ml_posterior_ref level by level."""
    for a, level in zip(tables.offsets, tables.levels()):
        ml_posterior_ref(codes, W, V, m, *level,
                         weights=tables.weights[a:a + len(level[0])])


def ml_posterior_sweep_chain_ref(codes, W, V, m, tables):
    """ml_posterior_sweep_ref in the kernel's order: chain after chain,
    each item alone (ml_posterior_ref of one item)."""
    for k in tables.chains.order:
        ml_posterior_ref(codes, W, V, m, tables.targets[k:k + 1],
                         tables.r1[k:k + 1], tables.r2[k:k + 1],
                         tables.len1[k:k + 1], tables.len2[k:k + 1],
                         weights=tables.weights[k:k + 1])


def ml_tree_loglk_ref(codes, W, V, m, tables, want_site=False,
                      site_out=None):
    """Plain twin of ml_tree_loglk: ml_pair_loglk_ref level by level, each
    level's sum and per-site logs added to float64 running sums, then the
    root term through ml_posterior_ref and ml_pair_loglk_ref."""
    dev, n_pos = codes.device, m.n_pos
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    site = torch.zeros(n_pos, dtype=torch.float64, device=dev)

    def add(ll, lk):
        nonlocal acc, site
        acc = acc + ll.sum()
        if want_site:
            site = site + torch.log(torch.clamp_min(
                lk[:, :n_pos].double(), 1e-300)).reshape(-1, n_pos).sum(0)

    for r1s, r2s, lens in tables.levels():
        add(*ml_pair_loglk_ref(codes, W, V, m, r1s, r2s, lens, want_site))
    if tables.root is not None:
        s_ab, c0, c1, c2, l0, l1, l2 = tables.root
        ml_posterior_ref(codes, W, V, m, [s_ab], [c0], [c1], [l0], [l1])
        add(*ml_pair_loglk_ref(codes, W, V, m, [s_ab], [c2], [l2],
                               want_site))
    if not want_site:
        return acc, None
    if site_out is not None:
        site_out.copy_(site)
        site = site_out
    return acc, site


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
              (m.ratecat, torch.int32, (P,)),
              (m.near_p, torch.float32, (C, C)),
              (m.near_freq, torch.float32, (C, C)),
              (m.counts, torch.int64, (2,)))
    for t, dtype, shape in shapes:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"model constant: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (codes, W, V) + tuple(s[0] for s in shapes):
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("store and model arrays must be contiguous on "
                             "one device")
    return n_rows, P, C, n_rates


class _Bound:
    """One store (codes, W, V) with its MLModel, checked once: the C
    arguments of the kernels, the stream they launch on (the current stream
    when the store was first seen), and device and pinned host buffers that
    the wrappers reuse from call to call.  The store changes its arrays and
    its model by replacing them (MLProfiles._put, _push_model), never by
    resizing one in place, so a new object is a new binding.  The binding
    holds weak references: it keeps no store alive."""

    def __init__(self, codes, W, V, m):
        n_rows, P, C, n_rates = _check_store(codes, W, V, m)
        self.refs = tuple(weakref.ref(o) for o in (codes, W, V, m))
        self.P, self.C = P, C
        self.args = [codes.data_ptr(), W.data_ptr(), V.data_ptr(),
                     m.code_freq.data_ptr(), m.eigenval.data_ptr(),
                     m.eigeninv.data_ptr(), m.statinv.data_ptr(),
                     m.rates.data_ptr(), m.ratecat.data_ptr(), n_rows, P, C,
                     int(m.n_pos), n_rates, int(bool(m.jc)),
                     ctypes.c_float(m.min_rel_len), m.near_p.data_ptr(),
                     m.near_freq.data_ptr(), int(bool(m.approx)),
                     m.counts.data_ptr()]
        self.device = codes.device
        self.stream = torch.cuda.current_stream(self.device).cuda_stream
        lib = _build.library()
        # floats of device scratch a line search and a quartet need (0:
        # everything fits in shared memory)
        self.opt_scratch = 0 if lib.vft_ml_opt_branch_fits_smem(P, C) \
            else 2 * P * C
        self.quartet_scratch = int(lib.vft_ml_quartet_scratch_floats(P, C))
        self._bufs = {}

    def buffer(self, name, nbytes, pinned=False):
        """The first nbytes of the uint8 buffer `name` (device, or pinned
        host memory), grown by doubling when it is too small."""
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 2 * (0 if buf is None else buf.numel()), 256)
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True) \
                if pinned else torch.empty(size, dtype=torch.uint8,
                                           device=self.device)
            self._bufs[name] = buf
        return buf[:nbytes]


_BOUND = collections.OrderedDict()
_N_BOUND = 4                        # stores bound at once (LRU)


def _bind(codes, W, V, m) -> _Bound:
    objects = (codes, W, V, m)
    key = tuple(map(id, objects))
    bound = _BOUND.get(key)
    # an id is reused only after its object died, which its weak reference
    # shows
    if bound is None or any(r() is not o for r, o in zip(bound.refs,
                                                           objects)):
        bound = _BOUND[key] = _Bound(codes, W, V, m)
    _BOUND.move_to_end(key)
    if len(_BOUND) > _N_BOUND:
        _BOUND.popitem(last=False)
    return bound


def _raise_on(rc, name):
    """The C entries return 0, a cudaError of the launch, or -1 for a row
    index outside the store (checked before anything is launched)."""
    if rc == -1:
        raise IndexError(f"{name}: a row index lies outside the store")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")


def ml_pair_loglk(codes, W, V, m, r1s, r2s, lengths, want_lk=False,
                  keep=False):
    """Pair log-likelihoods of rows (r1s[k], r2s[k]) at lengths[k] (ref
    pairLogLk tcc:1192-1447; host arrays).  Returns (ll [K] float64, lk
    [K, P] float32 per-site likelihoods, or None without want_lk), on the
    store's device; on CUDA they are views of the store's buffers, which the
    next call on the same store overwrites (in stream order), or with keep
    new tensors."""
    if codes.device.type == "cpu":
        return ml_pair_loglk_ref(codes, W, V, m, r1s, r2s, lengths, want_lk)
    bound = _bind(codes, W, V, m)
    K = len(r1s)
    if len(r2s) != K or len(lengths) != K:
        raise ValueError("r1s, r2s and lengths differ in length")
    rows = np.concatenate([r1s, r2s]).astype(np.int32)
    lens = np.asarray(lengths, dtype=np.float32)
    lk_at = align16(8 * K)
    n_bytes = lk_at + (4 * K * bound.P if want_lk else 0)
    buf = torch.empty(n_bytes, dtype=torch.uint8, device=bound.device) \
        if keep else bound.buffer("pair", n_bytes)
    ll = typed(buf, 0, (K,), torch.float64)
    lk = typed(buf, lk_at, (K, bound.P), torch.float32) if want_lk else None
    if K:
        lists = bound.buffer("lists", align16(rows.nbytes) + lens.nbytes)
        _raise_on(_build.library().vft_ml_pair_loglk_f32(
            *bound.args, rows.ctypes.data, lens.ctypes.data, K,
            lists.data_ptr(), ll.data_ptr(),
            lk.data_ptr() if want_lk else None, bound.stream),
            "ml_pair_loglk")
        ml_pair_loglk.launches += 1
    return ll, lk


ml_pair_loglk.launches = 0


def _check_lengths(bl, codes, name):
    if bl.dtype != torch.float32 or bl.dim() != 1 or not bl.is_contiguous() \
            or bl.device != codes.device:
        raise ValueError(f"{name}: the lengths must be a contiguous float32 "
                         "vector on the store's device")


def ml_posterior(codes, W, V, m, targets, r1s, r2s, len1s, len2s, bl=None,
                 lo=0.0):
    """Posterior profiles (ref posteriorProfile tcc:2137-2447) of rows
    (r1s[k], r2s[k]) across lengths (len1s[k], len2s[k]), written into rows
    targets[k] in place: codes NOCODE, weight 0 at both-gap positions (which
    get the gap vector), 1 elsewhere (host arrays).  Every row is read
    before any is written, so no target may be another item's source.  In
    matrix mode the rough-posterior gate applies where m.approx is set,
    and at 20 codes each position that is not both gaps adds one to
    m.counts' rough or exact count.

    With bl, a contiguous float32 tensor of branch lengths on the store's
    device, len1s and len2s are indices into it, and the lengths are
    max(bl[len1s[k]], lo) and max(bl[len2s[k]], lo), read there (the
    -threads > 1 lengths pass, engine/batched.py)."""
    targets = np.asarray(targets, dtype=np.int64)
    if len(targets) > 1 and (len(np.unique(targets)) != len(targets)
                             or np.isin(targets, [r1s, r2s]).any()):
        raise ValueError("ml_posterior: targets must be distinct and not "
                         "sources")
    if bl is not None:
        _check_lengths(bl, codes, "ml_posterior")
    if codes.device.type == "cpu":
        if bl is not None:
            lo = torch.tensor(lo, dtype=torch.float32)
            len1s, len2s = (torch.maximum(bl[_index(n, bl.device)], lo).numpy()
                            for n in (len1s, len2s))
        return ml_posterior_ref(codes, W, V, m, targets, r1s, r2s, len1s,
                                len2s)
    bound = _bind(codes, W, V, m)
    K = len(targets)
    if not len(r1s) == len(r2s) == len(len1s) == len(len2s) == K:
        raise ValueError("targets, rows and lengths differ in length")
    if K == 0:
        return
    if bl is None:
        rows = np.concatenate([targets, r1s, r2s]).astype(np.int32)
        lens = np.concatenate([len1s, len2s]).astype(np.float32)
    else:
        rows = np.concatenate([targets, r1s, r2s, len1s,
                               len2s]).astype(np.int32)
        lens = np.zeros(0, dtype=np.float32)
    lists = bound.buffer("lists", align16(rows.nbytes) + lens.nbytes)
    _raise_on(_build.library().vft_ml_posterior_f32(
        *bound.args, ctypes.c_float(m.tol), rows.ctypes.data,
        lens.ctypes.data if bl is None else None, K, lists.data_ptr(),
        None if bl is None else bl.data_ptr(),
        0 if bl is None else bl.numel(), ctypes.c_float(lo), bound.stream),
        "ml_posterior")
    ml_posterior.launches += 1


ml_posterior.launches = 0


def ml_opt_branch(codes, W, V, m, r1s, r2s, guesses, xmin, xmax, ftol, atol,
                  bl=None):
    """Maximum-likelihood length of the branch between rows r1s[k] and
    r2s[k], from guesses[k]: bracketing + Brent in float32 (ref
    onedimenmin/brent tcc:7024-7178, the JAX package's
    _onedimenmin_device).  Returns (x [K] float32, -loglk at x [K] float32,
    evaluations [K] int32) on the store's device; on CUDA they are views of
    the store's buffers, which the next call on the same store overwrites
    (in stream order).

    With bl, a contiguous float32 tensor of branch lengths on the store's
    device, guesses are distinct indices into it: the searches start from
    max(bl[guesses[k]], xmin), read there, and each x[k] is written back
    into bl[guesses[k]] (the -threads > 1 lengths pass, engine/batched.py;
    nothing is fetched)."""
    if bl is not None:
        _check_lengths(bl, codes, "ml_opt_branch")
        nodes = np.asarray(guesses, dtype=np.int64)
        if len(np.unique(nodes)) != len(nodes):
            raise ValueError("ml_opt_branch: the length indices must be "
                             "distinct")
    if codes.device.type == "cpu":
        if bl is None:
            return ml_opt_branch_ref(codes, W, V, m, r1s, r2s, guesses, xmin,
                                     xmax, ftol, atol)
        idx = _index(nodes, bl.device)
        x, fx, n_eval = ml_opt_branch_ref(
            codes, W, V, m, r1s, r2s,
            torch.maximum(bl[idx], torch.tensor(xmin, dtype=torch.float32))
            .numpy(), xmin, xmax, ftol, atol)
        bl[idx] = x
        return x, fx, n_eval
    bound = _bind(codes, W, V, m)
    K = len(r1s)
    if len(r2s) != K or len(guesses) != K:
        raise ValueError("r1s, r2s and guesses differ in length")
    if bl is None:
        rows = np.concatenate([r1s, r2s]).astype(np.int32)
        guess = np.asarray(guesses, dtype=np.float32)
    else:
        rows = np.concatenate([r1s, r2s, nodes]).astype(np.int32)
        guess = np.zeros(0, dtype=np.float32)
    x, fx, n_eval, scratch = _opt_outputs(bound, K)
    if K:
        lists = bound.buffer("lists", align16(rows.nbytes) + guess.nbytes)
        _raise_on(_build.library().vft_ml_opt_branch_f32(
            *bound.args, rows.ctypes.data,
            guess.ctypes.data if bl is None else None, K, lists.data_ptr(),
            None if bl is None else bl.data_ptr(),
            0 if bl is None else bl.numel(), ctypes.c_float(xmin),
            ctypes.c_float(xmax), ctypes.c_float(ftol), ctypes.c_float(atol),
            x.data_ptr(), fx.data_ptr(), n_eval.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            bound.stream), "ml_opt_branch")
        ml_opt_branch.launches += 1
    return x, fx, n_eval


ml_opt_branch.launches = 0


def _opt_outputs(bound, K):
    """x, fx, n_eval [K] views of the store's buffer "opt", and the device
    scratch of K line searches whose effective vectors exceed shared memory
    (None where they fit)."""
    step = align16(4 * K)
    buf = bound.buffer("opt", 3 * step)
    scratch = bound.buffer("opt_scratch", 4 * K * bound.opt_scratch) \
        if K and bound.opt_scratch else None
    return (typed(buf, 0, (K,), torch.float32),
            typed(buf, step, (K,), torch.float32),
            typed(buf, 2 * step, (K,), torch.int32), scratch)


def ml_quartet_opt(codes, W, V, m, rows4, lengths, scratch_rows, xmin, xmax,
                   ftol, atol, star_test=False, want_site_lk=False,
                   keep_site=False):
    """K quartet optimizations (ref MLQuartetOptimize tcc:1650-1788) in one
    launch, one block each: rows4 [K, 4] store rows (A, B, C, D), lengths
    [K, 5] float64 (A, B, C, D, I), each at least xmin.  In order: the
    posteriors AB and CD, the line search over I, with star_test the star
    test (which ends the optimization when the star topology is worse by
    more than CLOSE_LOGLK_LIMIT), then the posteriors and line searches of
    A, B, C and D, and the closing pair log-likelihoods; with want_site_lk
    also their per-site likelihoods.  The kernel keeps the six temporaries
    in shared memory (at 20 codes in device scratch) and leaves the store
    as it was; the twin computes them in the store rows scratch_rows.  Returns (records [K] of
    QUARTET_RECORD, per-site likelihoods [K, 3, P] float32 or None), both
    on the host, after one fetch; with keep_site the per-site likelihoods
    stay a tensor on the store's device and only the records are
    fetched."""
    rows4 = np.ascontiguousarray(rows4, dtype=np.int32).reshape(-1, 4)
    lengths = np.ascontiguousarray(lengths, dtype=np.float64).reshape(-1, 5)
    if len(lengths) != len(rows4):
        raise ValueError("rows4 and lengths differ in length")
    if codes.device.type == "cpu":
        rec, site = ml_quartet_opt_ref(codes, W, V, m, rows4, lengths,
                                       scratch_rows, xmin, xmax, ftol, atol,
                                       star_test, want_site_lk)
        if keep_site and site is not None:
            site = torch.from_numpy(site)
        return rec, site
    bound = _bind(codes, W, V, m)
    K, P = len(rows4), bound.P
    rec_bytes = K * QUARTET_RECORD.itemsize
    site_at = align16(rec_bytes)
    n_bytes = site_at + (4 * K * 3 * P if want_site_lk else 0)
    out = torch.empty(n_bytes, dtype=torch.uint8, device=bound.device) \
        if keep_site else bound.buffer("quartet", n_bytes)
    # one launch, or chunks of quartets whose device scratch fits in
    # QUARTET_SCRATCH_BYTES, in stream order on one scratch buffer
    chunk = max(1, QUARTET_SCRATCH_BYTES // (4 * bound.quartet_scratch)) \
        if bound.quartet_scratch else max(K, 1)
    scratch = bound.buffer("quartet_scratch",
                           4 * min(K, chunk) * bound.quartet_scratch) \
        if bound.quartet_scratch else None
    for a in range(0, K, chunk):
        b = min(K, a + chunk)
        lists = bound.buffer("lists", align16(rows4[a:b].nbytes)
                             + lengths[a:b].nbytes)
        _raise_on(_build.library().vft_ml_quartet_opt_f32(
            *bound.args, ctypes.c_float(m.tol), rows4[a:b].ctypes.data,
            lengths[a:b].ctypes.data, b - a, lists.data_ptr(),
            ctypes.c_float(xmin), ctypes.c_float(xmax), ctypes.c_float(ftol),
            ctypes.c_float(atol), int(bool(star_test)),
            out.data_ptr() + a * QUARTET_RECORD.itemsize,
            out.data_ptr() + site_at + 4 * a * 3 * P if want_site_lk else None,
            scratch.data_ptr() if scratch is not None else None,
            bound.stream), "ml_quartet_opt")
        ml_quartet_opt.launches += 1
    site = typed(out, site_at, (K, 3, P), torch.float32) \
        if want_site_lk else None
    fetched = out[:rec_bytes] if keep_site else out
    host = bound.buffer("quartet_host", fetched.numel(), pinned=True)
    host.copy_(fetched)                         # the one blocking fetch
    raw = host.numpy()
    rec = raw[:rec_bytes].view(QUARTET_RECORD).copy()
    if want_site_lk and not keep_site:
        site = raw[site_at:].view(np.float32).reshape(K, 3, P).copy()
    return rec, site


ml_quartet_opt.launches = 0


def ml_posterior_sweep(codes, W, V, m, tables):
    """The posteriors of a SweepTables, level after level (the JAX
    package's _posterior_sweep; ref recomputeMLProfiles tcc:3516-3539 and
    the up-profiles of testSplitsML), written into the store in place: one
    launch on CUDA, each row bit for bit ml_posterior's level by level;
    the twin on the CPU."""
    if codes.device.type == "cpu":
        return ml_posterior_sweep_ref(codes, W, V, m, tables)
    bound = _bind(codes, W, V, m)
    tables.check_rows(codes.shape[0], "ml_posterior_sweep")
    if tables.n_items == 0:
        return
    lib = _build.library()
    dev = tables.upload(bound.device)
    ws = workspace(bound.device, bound.stream)
    ch = tables.chains
    ctrl, n_flags = ws.flags(
        lib.vft_ml_posterior_sweep_flags(ch.n_slots, bound.P, bound.C))
    _raise_on(lib.vft_ml_posterior_sweep_f32(
        *bound.args, ctypes.c_float(m.tol), dev["rows"].data_ptr(),
        dev["lens"].data_ptr(), tables.n_items, dev["chains"].data_ptr(),
        ch.n_chains, ch.n_slots, ctrl.data_ptr(), n_flags, ws.next_epoch(),
        bound.stream), "ml_posterior_sweep")
    ml_posterior_sweep.launches += 1


ml_posterior_sweep.launches = 0


def ml_tree_loglk(codes, W, V, m, tables, want_site=False, site_out=None):
    """The log-likelihood of a LoglkTables (ref treeLogLk tcc:5160-5258,
    before its Jukes-Cantor correction): each level's pair log-likelihoods
    summed in list order and added to a float64 total level by level, the
    root term last; with want_site the same for each site's
    log(max(lk, 1e-300)).  Returns (total [] float64, per-site [n_pos]
    float64 or None) on the store's device, the per-site sums in site_out
    when given (a contiguous float64 tensor of n_pos).  One launch on CUDA;
    the root term's posterior is written into its scratch row as the
    twin writes it."""
    if site_out is not None and (
            site_out.dtype != torch.float64 or not site_out.is_contiguous()
            or site_out.numel() != m.n_pos or site_out.device != codes.device):
        raise ValueError("ml_tree_loglk: site_out must be a contiguous "
                         "float64 tensor of n_pos on the store's device")
    if codes.device.type == "cpu":
        return ml_tree_loglk_ref(codes, W, V, m, tables, want_site, site_out)
    bound = _bind(codes, W, V, m)
    tables.check_rows(codes.shape[0], "ml_tree_loglk")
    ll = torch.empty((), dtype=torch.float64, device=bound.device)
    site = None
    if want_site:
        site = site_out if site_out is not None else torch.empty(
            m.n_pos, dtype=torch.float64, device=bound.device)
    K, root = tables.n_pairs, tables.root
    n_seg = tables.n_levels + int(root is not None)
    if n_seg == 0:
        ll.zero_()
        if want_site:
            site.zero_()
        return ll, site
    lib = _build.library()
    if lib.vft_ml_tree_loglk_group_rows() != GROUP_ROWS:
        raise RuntimeError("ml_tree_loglk: the kernel's level groups are "
                           "not GROUP_ROWS pairs")
    dev = tables.upload(bound.device)
    n_groups = len(tables.groups()) - 1
    ws = workspace(bound.device, bound.stream)
    ctrl, n_flags = ws.flags(lib.vft_ml_tree_loglk_units(
        K, n_groups, int(m.n_pos), int(root is not None), int(want_site),
        bound.C))
    n_scratch = lib.vft_ml_tree_loglk_scratch_bytes(
        K, n_seg, bound.P, int(m.n_pos), bound.C, int(want_site))
    if n_scratch <= 0:
        raise RuntimeError("ml_tree_loglk: the card's occupancy could not "
                           "be read")
    scratch = ws.scratch_buffer(n_scratch)
    s_ab, c0, c1, c2, l0, l1, l2 = root if root is not None else \
        (0, -1, 0, 0, 0.0, 0.0, 0.0)
    _raise_on(lib.vft_ml_tree_loglk_f32(
        *bound.args, ctypes.c_float(m.tol), dev["seg"].data_ptr(),
        dev["group"].data_ptr(), dev["rows"].data_ptr(),
        dev["lens"].data_ptr(), K, n_seg, n_groups, int(s_ab),
        int(c0), int(c1), int(c2), ctypes.c_float(l0), ctypes.c_float(l1),
        ctypes.c_float(l2), int(want_site), ll.data_ptr(),
        site.data_ptr() if want_site else None, scratch.data_ptr(),
        scratch.numel(), ctrl.data_ptr(), n_flags, ws.next_epoch(),
        bound.stream), "ml_tree_loglk")
    ml_tree_loglk.launches += 1
    return ll, site


ml_tree_loglk.launches = 0
