"""Profile math on tensors (counterpart of ``veryfasttree_tpu/ops/kernels.py``:
the minimum-evolution functions and the exact ML ones).

Profiles are weighted rotated frequency tensors U[node, P, C] = W[node, P] *
f, so every profile distance is a dot product over the flattened P*C axis
(ref profileDist NeighbourJoining.tcc:1167-1190).  Each function keeps the
reference function's name, arguments and return layout, so the tests hold
one against the other on the same inputs.

Float32 arithmetic follows the reference's rounding where it is fixed by
the algorithm: the four-code position totals run left to right, and the
profile averages and the out-profile update round ``a*b + c`` once, as the
reference's compiled code does (a float32 product is exact in float64, so
``_fma`` rounds once up to a rare double-rounding tie).  Sums over rows
(out_profile) run in the library's order, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import NOCODE

# ---------------------------------------------------------------------------
# ME-space distance scans
# ---------------------------------------------------------------------------


def _piece_dist(top, denom):
    """dist = top/denom, or 1 where there is no shared weight."""
    ok = denom > 0
    return torch.where(ok, top / torch.where(ok, denom, 1.0), 1.0)


def me_dist_many(U, W, u_q, w_q, eigenval):
    """Distance of one query profile against many profiles.

    U:[M,P,C], W:[M,P] weighted rotated profiles; u_q:[P,C], w_q:[P] query.
    eigenval: [C] in matrix (eigen-rotated) mode, None in %different mode.
    Returns (dist[M], denom[M]).
    """
    return me_dist_many_2d(U.reshape(U.shape[0], -1), W, u_q, w_q, eigenval)


def finish_dist(dots, denom, use_matrix):
    """(dist, denom) from a distance's sums: top = dots in matrix mode,
    denom - dots in %different mode."""
    return _piece_dist(dots if use_matrix else denom - dots, denom), denom


def me_dots_many_2d(U2, W, u_q, w_q, eigenval):
    """The sums of me_dist_many_2d, unfinished: (dots[M], denom[M])."""
    denom = W @ w_q
    if eigenval is not None:
        return U2 @ (u_q * eigenval[None, :]).reshape(-1), denom
    return U2 @ u_q.reshape(-1), denom


def me_dist_many_2d(U2, W, u_q, w_q, eigenval):
    """me_dist_many against a pre-flattened store U2 [M, P*C]."""
    return finish_dist(*me_dots_many_2d(U2, W, u_q, w_q, eigenval),
                       eigenval is not None)


def me_dist_pair(u1, w1, u2, w2, eigenval):
    d, w = me_dist_many(u1[None], w1[None], u2, w2, eigenval)
    return d[0], w[0]


def me_dots_rows(U1, W1, U2, W2, eigenval):
    """The sums of me_dist_rows, unfinished: (dots[K], denom[K])."""
    denom = torch.einsum("kp,kp->k", W1, W2)
    if eigenval is not None:
        return torch.einsum("kpc,kpc,c->k", U1, U2, eigenval), denom
    K = U1.shape[0]
    return torch.einsum("kx,kx->k", U1.reshape(K, -1),
                        U2.reshape(K, -1)), denom


def me_dist_rows(U1, W1, U2, W2, eigenval):
    """Row-wise distances of two profile stacks: [K,P,C] x [K,P,C] -> [K]."""
    return finish_dist(*me_dots_rows(U1, W1, U2, W2, eigenval),
                       eigenval is not None)


def log_correct(dist, n_codes, use_matrix):
    """Log-correction of raw distances (ref logCorrect tcc:322-330)."""
    maxscore = 3.0
    if n_codes == 4 and not use_matrix:
        corr = torch.where(
            dist < 0.74,
            -0.75 * torch.log1p(-torch.clamp_max(dist, 0.7399) * 4.0 / 3.0),
            maxscore)
    else:
        corr = torch.where(dist < 0.99,
                           -1.3 * torch.log1p(-torch.clamp_max(dist, 0.9899)),
                           maxscore)
    return torch.clamp_max(corr, maxscore)


# ---------------------------------------------------------------------------
# Profile construction / averaging (ME space)
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """a*b + c with one rounding (float32 tensor a, c and tensor or number
    b; float64 operands as written)."""
    if a.dtype != torch.float32:
        return a * b + c
    bd = b.double() if torch.is_tensor(b) else b
    return (a.double() * bd + c.double()).float()


def _mix(bw: float, x1, x2, fuse_first: bool = False):
    """bw*x1 + (1-bw)*x2 in x1's dtype, rounded as the reference rounds it
    on the CPU: the products are exact when bw is 0.5; otherwise one fused
    multiply-add of one product onto the other, rounded (the second product
    fused, or the first when fuse_first)."""
    if bw == 0.5:
        return 0.5 * x1 + 0.5 * x2
    if x1.dtype != torch.float32:
        return bw * x1 + (1.0 - bw) * x2
    b, omb = _bw32(bw)
    if fuse_first:
        return _fma(x1, b, x2 * omb)
    return _fma(x2, omb, x1 * b)


def _bw32(bw: float):
    """(bw, 1 - bw) as the float32 values the reference multiplies by."""
    b = np.float32(bw)
    return float(b), float(np.float32(1.0) - b)


def _mix_total(bw: float, u1, u2):
    """The position totals of _mix(bw, u1, u2) over the code axis as the
    reference's CPU build sums them (%different mode, bw not 0.5): one
    chain of fused multiply-adds, bw*u1[c] then (1-bw)*u2[c] for each code
    in turn, from 0."""
    b, omb = _bw32(bw)
    total = torch.zeros_like(u1[..., 0])
    for c in range(u1.shape[-1]):
        total = _fma(u1[..., c], b, total)
        total = _fma(u2[..., c], omb, total)
    return total


def _code_total(vec):
    """Sum over the code axis, left to right in vec's dtype."""
    total = vec[..., 0]
    for c in range(1, vec.shape[-1]):
        total = total + vec[..., c]
    return total


def _fallback(code_freq, eigentot, dtype):
    if eigentot is not None:
        return code_freq[0]
    n_codes = code_freq.shape[0]
    return torch.full((code_freq.shape[1],), 1.0 / n_codes, dtype=dtype,
                      device=code_freq.device)


def normalize_freq(vec, eigentot, fallback, tol, total=None):
    """Normalize per-position vectors [..., C] to total (unrotated) frequency
    1; positions with total <= tol get `fallback` (ref normalizeFreq
    tcc:839-871).  The total is summed left to right (in matrix mode of the
    products with eigentot), so the CUDA kernels can repeat it; `total`
    gives it instead."""
    if total is None:
        total = _code_total(vec * eigentot if eigentot is not None else vec)
    ok = total > tol
    scaled = vec / torch.where(ok, total, 1.0)[..., None]
    return torch.where(ok[..., None], scaled, fallback.expand_as(vec))


def average_profile(c1, w1, u1, c2, w2, u2, bionj_weight, code_freq,
                    eigentot, tol):
    """Weighted merge of two profiles for a join (ref averageProfile
    tcc:2063-2135).  Works on any leading batch shape; bionj_weight is a
    float.  Returns (codes, w, U, f).

    With a weight other than 0.5 the reference's CPU build rounds three
    parts apart (one fused multiply-add each): w_out and the accumulator
    fuse the second product, the weight that scales U the first, and the
    %different mode totals chain every product (_mix_total)."""
    w_out = _mix(bionj_weight, w1, w2)

    # keep a child's code where the children agree or the other is absent
    # (ref tcc:2077-2089); otherwise NOCODE (a stored-vector position)
    take1 = (w1 > 0) & (c1 != NOCODE) & ((w2 <= 0) | (c1 == c2))
    take2 = (w1 <= 0) & (w2 > 0) & (c2 != NOCODE)
    nocode = torch.full_like(c1, NOCODE)
    c_out = torch.where(take1, c1, torch.where(take2, c2, nocode))
    c_out = torch.where(w_out > 0, c_out, nocode)

    accum = _mix(bionj_weight, u1, u2)
    chained = (bionj_weight != 0.5 and eigentot is None
               and u1.dtype == torch.float32)
    f_out = normalize_freq(accum, eigentot,
                           _fallback(code_freq, eigentot, u1.dtype), tol,
                           _mix_total(bionj_weight, u1, u2) if chained
                           else None)
    # coded positions are exactly the rotated one-hot of their code
    coded = (c_out != NOCODE) & (w_out > 0)
    safe_c = torch.where(c_out == NOCODE, 0, c_out.long())
    f_out = torch.where(coded[..., None], code_freq[safe_c], f_out)
    w_u = _mix(bionj_weight, w1, w2, fuse_first=True)[..., None]
    u_out = torch.where(w_u > 0, w_u * f_out, 0.0)
    return c_out, w_out, u_out, f_out


def out_profile(U, W, active_mask, code_freq, eigentot, tol):
    """Average profile of all active nodes (ref outProfile tcc:729-815).

    Returns (w_out[P], f_out[P,C]): f_out is the unweighted normalized
    frequency; w_out the mean input weight, floored at 1e-20.
    """
    n = max(int(active_mask.sum()), 1)
    w_out = torch.clamp_min(W[active_mask].sum(0) / n, 1e-20)
    f_out = normalize_freq(U[active_mask].sum(0), eigentot,
                           _fallback(code_freq, eigentot, U.dtype), tol)
    return w_out, f_out


def update_out_profile(w_out, f_out, u_old1, w_old1, u_old2, w_old2, u_new,
                       w_new, n_active_old, code_freq, eigentot, tol):
    """Incremental out-profile update after a join (ref updateOutProfile
    tcc:943-1010)."""
    original_mult = w_out * n_active_old
    new_mult = _fma(w_out, n_active_old, w_new) - w_old1 - w_old2
    w2 = torch.clamp_min(new_mult / (n_active_old - 1), 1e-20)
    accum = _fma(f_out, original_mult[..., None], -u_old1) - u_old2 + u_new
    f2 = normalize_freq(accum, eigentot,
                        _fallback(code_freq, eigentot, f_out.dtype), tol)
    return w2, f2


def out_distance_from_hit(dist, weight, selfdist, selfweight, diameter,
                          totdiam, n_active):
    """outDistance from d(node, outprofile) (ref setOutDistance
    tcc:1012-1083)."""
    top = (n_active - 1) * (dist * weight * n_active - selfweight * selfdist)
    bottom = weight * n_active - selfweight
    ok = bottom > 0.01
    pdist = top / torch.where(ok, bottom, 1.0)
    return torch.where(ok, pdist - diameter * (n_active - 1)
                       - (totdiam - diameter), 3.0)


# ---------------------------------------------------------------------------
# ML space: effective vectors, pair log-likelihood, posterior profiles.  The
# plain twins of the kernels in ops/ml_kernels.py are built from these.
# ---------------------------------------------------------------------------


# Sums over the code axis run left to right (_code_total), as in the CUDA
# kernels, so that a kernel and its twin round alike.


def ml_effective(codes, w, v, code_freq, for_posterior, jukes_cantor):
    """Effective per-position frequency vector under the reference's mixing
    rules.  v holds raw vectors; 0 < w < 1 positions are mixed with the gap
    distribution: matrix pairLogLk mixes every such position (ref
    tcc:1288-1301), matrix posteriorProfile only code-derived ones (ref
    tcc:2281-2299), and Jukes-Cantor only code-derived ones in both uses
    (ref tcc:1235-1251, 2231-2247)."""
    if jukes_cantor:
        gap = torch.full((v.shape[-1],), 0.25, dtype=v.dtype, device=v.device)
    else:
        gap = code_freq[NOCODE]
    stored = (codes == NOCODE) & (w > 0)
    mix = (w > 0) & (w < 1)
    if jukes_cantor or for_posterior:
        mix = mix & ~stored
    wm = torch.where(mix, w, 1.0)[..., None]
    return wm * v + (1.0 - wm) * gap


def pair_loglk_matrix(f1, f2, w1, w2, expeigen, ratecat, pos_mask):
    """Matrix-model pair log-likelihood (ref pairLogLk tcc:1267-1439).

    f1, f2: [..., P, C] effective rotated vectors; expeigen: [..., nRate,
    C]; ratecat: [P] int; pos_mask: [P] bool (leading dimensions batch).
    Both-gap and padding positions contribute lk 1.  Returns (sum of log
    max(lk, 1e-37) in float64, lk [..., P])."""
    lk = _code_total(f1 * f2 * expeigen[..., ratecat, :])
    both_gap = (w1 == 0) & (w2 == 0)
    lk = torch.where(both_gap | ~pos_mask, 1.0, lk)
    return _log_sum(lk), lk


def pair_loglk_jc(f1, f2, psame, pdiff, ratecat, pos_mask):
    """Jukes-Cantor pair log-likelihood (ref pairLogLk tcc:1202-1266):
    lk = pDiff * sum(f2) + (pSame - pDiff) * f1.f2."""
    ps = psame[..., ratecat]
    pd = pdiff[..., ratecat]
    lk = pd * _code_total(f2) + (ps - pd) * _code_total(f1 * f2)
    lk = torch.where(pos_mask, lk, 1.0)
    return _log_sum(lk), lk


def _log_sum(lk):
    """Sum over positions of log max(lk, 1e-37): the logs in lk's dtype, the
    sum in float64 (the CUDA kernels sum in double, in a fixed order)."""
    return torch.log(torch.clamp_min(lk, 1e-37)).double().sum(-1)


def posterior_matrix(f1, f2, w1, w2, expeigen1, expeigen2, ratecat,
                     code_freq_n, eigeninv, statinv, tol, approx=None):
    """Posterior profile of a parent from two children, matrix model (ref
    posteriorProfile tcc:2262-2429).  Returns (w_out [P], v_out [P, C],
    n_rough, n_exact) in rotated space, the counts int64 over the leading
    dimensions; gap-gap positions get weight 0 (the caller puts the gap row
    there).

    approx: None for the exact path, else (near_p [C, C], near_freq [C, C],
    minf, minratio), the -approxml rough-posterior gate (ref
    tcc:2390-2421): where one character ch (the first index of the
    maximum, as jnp.argmax takes it) has fPost[ch] >= minf and the mixture
    w onehot + (1 - w) nearP[ch] under-estimates no other character by more
    than minratio, the output is w statinv[ch] codeFreq[ch] + (1 - w)
    nearFreq[ch], without the rotation back.  n_rough and n_exact count the
    positions that are not both gaps on each branch (ref
    nAAPosteriorRough/Exact); at 20 codes the exact path counts every such
    position as exact, at 4 codes nothing is counted (tcc:2424)."""
    x1 = _rotate(f1 * expeigen1[..., ratecat, :], code_freq_n)
    x2 = _rotate(f2 * expeigen2[..., ratecat, :], code_freq_n)
    fpost = torch.clamp_min(x1 * x2 * statinv, 0.0)
    tot = _code_total(fpost)
    fpost = fpost / torch.where(tot > tol, tot, 1.0)[..., None]
    both_gap = (w1 == 0) & (w2 == 0)
    w_out = torch.where(both_gap, 0.0, 1.0).to(f1.dtype)
    v_out = _rotate(fpost, eigeninv)
    live = ~both_gap
    rough = torch.zeros_like(live)
    if approx is not None:
        near_p, near_freq, minf, minratio = approx
        # the limits in fpost's dtype, as the JAX package's weak-typed
        # scalars and the CUDA body's float constants
        minf, minratio = (fpost.new_tensor(x) for x in (minf, minratio))
        ch = torch.argmax(fpost, dim=-1, keepdim=True)
        fmax = torch.gather(fpost, -1, ch)
        npch = near_p[ch[..., 0]]                               # [..., P, C]
        npdiag = torch.gather(npch, -1, ch)
        w = (fmax - npdiag) / (1.0 - npdiag)
        frough = (1.0 - w) * npch
        onehot = torch.zeros_like(fpost, dtype=torch.bool).scatter_(
            -1, ch, True)
        under = (frough < fpost * minratio) & ~onehot
        rough = (fmax[..., 0] >= minf) & ~under.any(dim=-1)
        v_rough = (w * statinv[ch]) * code_freq_n[ch[..., 0]] \
            + (1.0 - w) * near_freq[ch[..., 0]]
        v_out = torch.where(rough[..., None], v_rough, v_out)
    if approx is None and fpost.shape[-1] != 20:
        zero = torch.zeros(live.shape[:-1], dtype=torch.int64,
                           device=live.device)
        return w_out, v_out, zero, zero
    return w_out, v_out, (rough & live).sum(-1), (~rough & live).sum(-1)


def _rotate(vec, mat):
    """out[..., j] = sum_k vec[..., k] * mat[j, k] in float64, rounded to
    vec's dtype once.  Character-space probabilities near 0 are sums of
    large signed terms, so a float32 sum depends on its order; the double
    sum does not (the CUDA kernel sums the same way)."""
    return (vec.double() @ mat.double().T).to(vec.dtype)


def posterior_jc(f1, f2, w1, w2, psame1, pdiff1, psame2, pdiff2, ratecat):
    """Posterior profile, Jukes-Cantor (ref posteriorProfile tcc:2164-2261):
    f[j] = (f1[j] pS1 + (1-f1[j]) pD1) (f2[j] pS2 + (1-f2[j]) pD2),
    normalized; gap-gap positions get weight 0 and the uniform vector."""
    ps1, pd1 = psame1[..., ratecat, None], pdiff1[..., ratecat, None]
    ps2, pd2 = psame2[..., ratecat, None], pdiff2[..., ratecat, None]
    f = (f1 * ps1 + (1.0 - f1) * pd1) * (f2 * ps2 + (1.0 - f2) * pd2)
    f = f / torch.clamp_min(_code_total(f), 1e-37)[..., None]
    both_gap = (w1 == 0) & (w2 == 0)
    w_out = torch.where(both_gap, 0.0, 1.0).to(f1.dtype)
    return w_out, torch.where(both_gap[..., None], 0.25, f)


def exp_eigen_rates(length, rates, eigenval, min_rel_len):
    """expeigen[iRate, j] = exp(max(length * rate, minRel) * eigenval[j])
    (ref expEigenRates tcc:2020-2038)."""
    rel = torch.clamp_min(length * rates, min_rel_len)
    return torch.exp(rel[..., None] * eigenval)


def p_same_diff(length, rates):
    """JC probability of no change per rate category (ref pSameVector
    tcc:2005-2018)."""
    psame = 0.25 + 0.75 * torch.exp((-4.0 / 3.0) * torch.abs(length * rates))
    return psame, (1.0 - psame) / 3.0


# ---------------------------------------------------------------------------
# Two-tier profile support: leaves live as int8 codes only; their weighted
# rotated one-hots are expanded on the fly (ref seqDist tcc:1601-1624).
# ---------------------------------------------------------------------------


def leaf_u(codes_rows, code_freq, dtype):
    """Expand leaf code rows [K, P] -> (U [K, P, C], W [K, P]); NOCODE
    positions get weight 0."""
    valid = codes_rows != NOCODE
    safe = torch.where(valid, codes_rows.long(), 0)
    W = valid.to(dtype)
    U = code_freq[safe].to(dtype) * W[..., None]
    return U, W


def me_dots_many_codes(leaf_codes, uq, wq, eigenval, code_freq, dtype):
    """The sums of me_dist_many_codes, unfinished: (picks[L], denom[L])."""
    valid = leaf_codes != NOCODE
    safe = torch.where(valid, leaf_codes.long(), 0)
    wl = valid.to(dtype)
    denom = wl @ wq
    G = (uq * eigenval[None, :]) @ code_freq.T if eigenval is not None else uq
    # uq already carries the query weight, so the picks are not weighted
    # by wq again
    picked = torch.zeros(leaf_codes.shape, dtype=dtype, device=uq.device)
    for c in range(G.shape[1]):
        picked = picked + torch.where(safe == c, G[:, c][None, :], 0.0)
    return (picked * wl).sum(-1), denom


def me_dist_many_codes(leaf_codes, uq, wq, eigenval, code_freq, dtype):
    """One query against many code-only leaves: per-position picks from the
    projected query table G[p, c] = (uq * eigenval) . codeFreq[c] (matrix
    mode) or uq itself (%different mode).  Returns (dist[L], denom[L])."""
    return finish_dist(*me_dots_many_codes(leaf_codes, uq, wq, eigenval,
                                           code_freq, dtype),
                       eigenval is not None)
