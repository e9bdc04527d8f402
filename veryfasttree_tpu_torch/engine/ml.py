"""Maximum-likelihood phase on one torch device: Brent branch-length
optimization, ML quartets and NNIs, CAT rate categories, GTR fitting,
Gamma(20) rescaling, SH-like supports (counterpart of the serial path of
``veryfasttree_tpu/engine/ml.py``).

The scalar-sequential pieces (quartet bookkeeping, convergence logic, the
GTR and Gamma line searches -- ref MLQuartetOptimize tcc:1650-1788,
MLQuartetNNI :4885-5004) run on the host as in the reference; every
likelihood, posterior and branch-length line search is one call of the ML
store (engine/ml_profiles.py), whose kernels take their row indices in the
launch parameters.  treeLogLk and recomputeMLProfiles are one launch each
over the level tables of a TreeSweep (ml_profiles.py), which sums on the
device; a CAT fit builds one TreeSweep for its 20 rates and fetches the
rates' per-site log-likelihoods once.  On the card, a whole ML NNI round
and a whole branch-length pass are one kernel launch each
(ops/ml_round.py); their host loops here (rearrange.do_nni with use_ml,
optimize_all_branch_lengths) are the twins that run for a store on the
CPU.  The SH-like supports run as list launches
over all splits at once (ops/ml_round.sh_pass, on the card and on the
CPU); test_splits_ml here is the host loop that pass is held to.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import constants
from ..ops import ml_round

from ..utils.trace import annotate
from . import batched, checkpoint, rearrange
from .ml_profiles import (LEN_A, LEN_B, LEN_C, LEN_D, LEN_I, S_AB, S_CD,
                          S_TMP1, MLProfiles, site_log)
from .rearrange import ABvsCD, ACvsBD, ADvsBC, UpProfiles
from .supports import (SplitCount, resample_columns, resample_count_matrix,
                       split_constraints)

# ---------------------------------------------------------------------------
# 1-D minimization on the host (ref onedimenmin tcc:7024-7081, brent
# :7098-7178), for the GTR rates and the Gamma fit; the branch-length line
# search runs in the ml_opt_branch kernel
# ---------------------------------------------------------------------------

_ITMAX = 100
_CGOLD = 0.3819660
_ZEPS = 1.0e-10


def brent(ax, bx, cx, f, ftol, atol, fax, fbx, fcx):
    a, b = min(ax, cx), max(ax, cx)
    x, fx = bx, fbx
    if fax < fcx:
        w, fw, v, fv = ax, fax, cx, fcx
    else:
        w, fw, v, fv = cx, fcx, ax, fax
    d = 0.0
    e = 0.0
    for _ in range(_ITMAX):
        xm = 0.5 * (a + b)
        tol1 = ftol * abs(x)
        tol2 = 2.0 * (tol1 + _ZEPS)
        if abs(x - xm) <= (tol2 - 0.5 * (b - a)) or abs(a - b) < atol:
            break
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            etemp = e
            e = d
            if abs(p) >= abs(0.5 * q * etemp) or p <= q * (a - x) \
                    or p >= q * (b - x):
                e = a - x if x >= xm else b - x
                d = _CGOLD * e
            else:
                d = p / q
                u = x + d
                if u - a < tol2 or b - u < tol2:
                    d = math.copysign(tol1, xm - x)
        else:
            e = a - x if x >= xm else b - x
            d = _CGOLD * e
        u = x + d if abs(d) >= tol1 else x + math.copysign(tol1, d)
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv = w, fw
                w, fw = u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    xw = x - w
    wv = w - v
    vx = v - x
    denom = v * v * xw + x * x * wv + w * w * vx
    f2x = 2.0 * (fv * xw + fx * wv + fw * vx) / denom if denom != 0 else 0.0
    return x, fx, f2x


def onedimenmin(xmin, xguess, xmax, f, ftol, atol):
    """Bracket then Brent (ref tcc:7024-7081).  Returns (optx, fx, f2x)."""
    if xguess == xmin:
        ax, bx, cx = xmin, 2.0 * xguess, 10.0 * xguess
    elif xguess <= 2.0 * xmin:
        ax, bx, cx = xmin, xguess, 5.0 * xguess
    else:
        ax, bx, cx = 0.5 * xguess, xguess, 2.0 * xguess
    if cx > xmax:
        cx = xmax
    if bx >= cx:
        bx = 0.5 * (ax + cx)
    fa = f(ax)
    fb = f(bx)
    fc = f(cx)
    while fa < fb and ax > xmin:
        ax = (ax + xmin) / 2.0
        if ax < 2.0 * xmin:
            ax = xmin
        fa = f(ax)
    while fc < fb and cx < xmax:
        cx = (cx + xmax) / 2.0
        if cx > xmax * 0.95:
            cx = xmax
        fc = f(cx)
    return brent(ax, bx, cx, f, ftol, atol, fa, fb, fc)


# ---------------------------------------------------------------------------
# pair / quartet optimization
# ---------------------------------------------------------------------------


def ml_pair_optimize(nj, r1, r2, length):
    """ref MLPairOptimize tcc:1790-1803.  Returns (loglk, new_length)."""
    x, fx = nj.ml.opt_branch_length(r1, r2, length)
    return -fx, x


def ml_quartet_optimize(nj, rA, rB, rC, rD, lengths, star_test=False,
                        want_site_lk=False):
    """ref MLQuartetOptimize tcc:1650-1788, in one kernel launch
    (MLProfiles.quartet_optimize).

    lengths: array[5], modified in place.  Returns (quartetloglk,
    star_triggered, site_loglk or None).
    """
    return nj.ml.quartet_optimize([(rA, rB, rC, rD)], [lengths], star_test,
                                  want_site_lk)[0]


def ml_quartet_loglk(nj, rA, rB, rC, rD, lengths, want_site_lk=False):
    """ref MLQuartetLogLk tcc:5410-5427."""
    ml = nj.ml
    s_ab = ml.scratch_row(S_AB)
    s_cd = ml.scratch_row(S_CD)
    ml.posterior_into(s_ab, rA, rB, lengths[0], lengths[1])
    ml.posterior_into(s_cd, rC, rD, lengths[2], lengths[3])
    if want_site_lk:
        ll1, lk1 = ml.pair_loglk(rA, rB, lengths[0] + lengths[1],
                                 want_site_lk=True)
        ll2, lk2 = ml.pair_loglk(rC, rD, lengths[2] + lengths[3],
                                 want_site_lk=True)
        ll3, lk3 = ml.pair_loglk(s_ab, s_cd, lengths[4], want_site_lk=True)
        return ll1 + ll2 + ll3, site_log(lk1) + site_log(lk2) \
            + site_log(lk3)
    return ml.pair_loglk(rA, rB, lengths[0] + lengths[1]) \
        + ml.pair_loglk(rC, rD, lengths[2] + lengths[3]) \
        + ml.pair_loglk(s_ab, s_cd, lengths[4]), None


def ml_quartet_nni(nj, rows4, lengths, nodes4=None):
    """ref MLQuartetNNI tcc:4885-5004: each criterion is the quartet's
    LogLk less the constraint penalty of its topology (the quartet around
    nodes4; none without constraints).  Returns (choice, criteria,
    new_len[5])."""
    opts = nj.options
    len_ab = np.array([lengths[LEN_A], lengths[LEN_B], lengths[LEN_C],
                       lengths[LEN_D], lengths[LEN_I]])
    len_ac = np.array([lengths[LEN_A], lengths[LEN_C], lengths[LEN_B],
                       lengths[LEN_D], lengths[LEN_I]])
    len_ad = np.array([lengths[LEN_A], lengths[LEN_D], lengths[LEN_C],
                       lengths[LEN_B], lengths[LEN_I]])
    consider_ac = True
    consider_ad = True
    n_rounds = 2 if opts.ml_accuracy < 2 else opts.ml_accuracy
    penalty = rearrange.quartet_constraint_penalties(nj, nodes4) \
        if nj.n_cons and nodes4 is not None else np.zeros(3)

    criteria = np.array([-1e20, -1e20, -1e20])
    rA, rB, rC, rD = rows4
    for _ in range(n_rounds):
        ll, star, _ = ml_quartet_optimize(nj, rA, rB, rC, rD, len_ab,
                                          star_test=True)
        criteria[ABvsCD] = ll - penalty[ABvsCD]
        if star:
            nj.debug.n_star_tests += 1
            criteria[ACvsBD] = -1e20
            criteria[ADvsBC] = -1e20
            out = lengths.copy()
            out[LEN_I] = len_ab[LEN_I]
            return ABvsCD, criteria, out
        # AC and AD are independent: one launch for both
        todo = [(k, rows, lens) for k, rows, lens, due in (
            (ACvsBD, (rA, rC, rB, rD), len_ac, consider_ac),
            (ADvsBC, (rA, rD, rC, rB), len_ad, consider_ad)) if due]
        if todo:
            found = nj.ml.quartet_optimize([t[1] for t in todo],
                                           [t[2] for t in todo])
            for (k, _, _), (ll, _, _) in zip(todo, found):
                criteria[k] = ll - penalty[k]
        if opts.ml_accuracy < 2:
            close = constants.CLOSE_LOGLK_LIMIT
            if (criteria[ACvsBD] < criteria[ABvsCD] - close
                    or (len_ac[LEN_I] <= 2.0 * opts.ml_min_branch_length
                        and criteria[ACvsBD] < criteria[ABvsCD])):
                consider_ac = False
            if (criteria[ADvsBC] < criteria[ABvsCD] - close
                    or (len_ad[LEN_I] <= 2.0 * opts.ml_min_branch_length
                        and criteria[ADvsBC] < criteria[ABvsCD])):
                consider_ad = False
            if not consider_ac and not consider_ad:
                break
            if (criteria[ACvsBD] > criteria[ABvsCD] + close
                    and criteria[ACvsBD] > criteria[ADvsBC] + close):
                break
            if (criteria[ADvsBC] > criteria[ABvsCD] + close
                    and criteria[ADvsBC] > criteria[ACvsBD] + close):
                break

    if criteria[ACvsBD] > criteria[ABvsCD] \
            and criteria[ACvsBD] > criteria[ADvsBC]:
        return ACvsBD, criteria, len_ac
    if criteria[ADvsBC] > criteria[ABvsCD] \
            and criteria[ADvsBC] > criteria[ACvsBD]:
        return ADvsBC, criteria, len_ad
    return ABvsCD, criteria, len_ab


# ---------------------------------------------------------------------------
# tree log-likelihood & branch lengths
# ---------------------------------------------------------------------------


def tree_loglk(nj, want_site_loglk=False, sweep=None):
    """ref treeLogLk tcc:5160-5258: one tree log-likelihood launch over the
    tables of `sweep` (a TreeSweep of the current tree and branch lengths,
    or one built here), the sums in float64 on the device, then one fetch
    and the Jukes-Cantor correction."""
    ml = nj.ml
    if nj.n_seqs < 2:
        return (0.0, None) if want_site_loglk else 0.0
    ll, site = ml.tree_loglk(sweep or ml.tree_sweep(), want_site_loglk)
    loglk = float(ll)                   # the one blocking fetch
    site = site.cpu().numpy() if want_site_loglk else None
    loglk, site = _jc_correct(nj, loglk, site)
    return (loglk, site) if want_site_loglk else loglk


def _jc_correct(nj, loglk=None, site=None):
    """The Jukes-Cantor gap/log-4 correction (ref :5236-5257) of a total
    and of per-site log-likelihoods ([P] or [nRate, P], in place), each
    where given; other models' values as they are."""
    if nj.options.n_codes == 4 and nj.ml.jc:
        log4 = math.log(4.0)
        if site is not None:
            site += nj.gaps_per_pos() * log4 - log4
        if loglk is not None:
            loglk -= nj.n_pos * log4
            loglk += int(nj.prof.n_gaps.sum()) * log4
    return loglk, site


def optimize_all_branch_lengths(nj) -> None:
    """ref optimizeAllBranchLengths tcc:5006-5111: the host loop, one store
    call per posterior and line search.  The ML phase goes through
    ops/ml_round.ml_lengths_pass, which runs this loop for a store on the
    CPU and one kernel launch per pass on the card."""
    tree = nj.tree
    ml = nj.ml
    opts = nj.options
    if nj.n_seqs < 2:
        return
    if nj.n_seqs == 2:
        a, b = int(tree.children[tree.root, 0]), int(tree.children[tree.root, 1])
        _, ln = ml_pair_optimize(nj, a, b, 1.0)
        tree.branchlength[a] = ln / 2.0
        tree.branchlength[b] = ln / 2.0
        return
    ups = UpProfiles(nj)
    s_tmp = ml.scratch_row(S_TMP1)
    for node in tree.postorder_nodes():
        n_child = int(tree.n_child[node])
        if n_child == 0:
            continue
        nodes3 = [int(tree.children[node, 0]), int(tree.children[node, 1]),
                  int(tree.children[node, 2]) if n_child == 3 else node]
        rows3 = [nodes3[0], nodes3[1],
                 nodes3[2] if n_child == 3 else ups.get(node, use_ml=True)]
        for _ in range(2):
            for i in range(3):
                b1, b2 = (i + 1) % 3, (i + 2) % 3
                ml.posterior_into(s_tmp, rows3[b1], rows3[b2],
                                  tree.branchlength[nodes3[b1]],
                                  tree.branchlength[nodes3[b2]])
                ln = max(tree.branchlength[nodes3[i]], opts.ml_min_branch_length)
                _, ln = ml_pair_optimize(nj, rows3[i], s_tmp, ln)
                tree.branchlength[nodes3[i]] = ln
        if node != tree.root:
            rearrange.recompute_profile(nj, ups, node, use_ml=True)
            ups.reset(node)


# ---------------------------------------------------------------------------
# CAT rates / GTR / Gamma
# ---------------------------------------------------------------------------


def ml_site_rates(n_cats: int) -> np.ndarray:
    """ref MLSiteRates tcc:5367-5378: log-spaced 1/nCats .. nCats."""
    log_n = math.log(n_cats)
    return np.exp(np.linspace(-log_n, log_n, n_cats))


def ml_site_likelihoods_by_rate(nj, rates: np.ndarray, progress=None,
                                sweep=None):
    """ref MLSiteLikelihoodsByRate tcc:5381-5408 -> site_loglk [nRate, P]:
    per rate one posterior sweep and one tree log-likelihood launch over
    the tables of `sweep` (one TreeSweep for every rate), each rate's
    per-site log-likelihoods into a row of a [nRate, P] tensor on the
    device, fetched once after the last rate."""
    ml = nj.ml
    sweep = sweep or ml.tree_sweep()
    old_rates = ml.rates_np.copy()
    old_cats = ml.ratecat_np.copy()
    out = torch.empty((len(rates), nj.n_pos), dtype=torch.float64,
                      device=ml.device)
    for i, r in enumerate(rates):
        ml.set_rates(np.full_like(old_rates, r), old_cats[: nj.n_pos])
        ml.recompute_ml_profiles(sweep)
        ml.tree_loglk(sweep, want_site=True, site_out=out[i])
        if progress is not None:
            progress.print("Site likelihoods with rate category %d of %d",
                           i + 1, len(rates))
    _, site = _jc_correct(nj, site=out.cpu().numpy())  # the one fetch
    ml.set_rates(old_rates, old_cats[: nj.n_pos])
    ml.recompute_ml_profiles(sweep)
    return site


def log_ml_rates(nj, log) -> None:
    """ref logMLRates tcc:5497-5514: per-site CAT rates into the -log file."""
    if log is None or not nj.options.log_file_name:
        return
    ml = nj.ml
    print(f"NCategories{len(ml.rates_np)}", file=log)
    print("Rates " + " ".join(f"{r:f}" for r in ml.rates_np), file=log)
    print("SiteCategories " + " ".join(
        str(int(c) + 1) for c in ml.ratecat_np[: nj.n_pos]), file=log)


def set_ml_rates(nj, progress=None) -> None:
    """ref setMLRates tcc:5429-5488: per-site argmax rate with a Gamma(3,1/3)
    prior, mean-normalized."""
    opts = nj.options
    ml = nj.ml
    sweep = ml.tree_sweep()
    ml.set_rates(np.ones(1), np.zeros(nj.n_pos, dtype=np.int32))
    if opts.n_rate_cats == 1:
        ml.recompute_ml_profiles(sweep)
        return
    rates = ml_site_rates(opts.n_rate_cats)
    site_loglk = ml_site_likelihoods_by_rate(nj, rates, progress, sweep)
    prior = 2.0 * np.log(rates) - 3.0 * rates
    best = np.argmax(site_loglk + prior[:, None], axis=0)
    rates = rates / rates[best].mean()
    ml.set_rates(rates, best.astype(np.int32))
    ml.recompute_ml_profiles(sweep)


def set_ml_gtr(nj, freq_in=None, progress=None) -> None:
    """ref setMLGtr tcc:6436-6500: optimize the 6 GTR rates by Brent."""
    from ..models import TransitionMatrix

    opts = nj.options
    assert opts.n_codes == 4
    ml = nj.ml
    if freq_in is not None:
        freq = np.asarray(freq_in, dtype=np.float64)
    else:
        counts = np.ones(4, dtype=np.int64)  # pseudocounts
        leaf_codes = nj.prof.codes[: nj.n_seqs, : nj.n_pos].cpu().numpy()
        for c in range(4):
            counts[c] += int((leaf_codes == c).sum())
        freq = counts / counts.sum()

    rates = np.ones(6)
    n_rounds = 2 if opts.ml_accuracy < 2 else opts.ml_accuracy
    sweep = ml.tree_sweep()             # the tree and lengths stay until
                                        # the lengths pass at the end

    def neg_loglk(x, i_rate):
        r = rates.copy()
        r[i_rate] = x
        ml.set_transmat(TransitionMatrix.gtr(r, freq, dtype=ml.dtype))
        ml.recompute_ml_profiles(sweep)
        return -tree_loglk(nj, sweep=sweep)

    for rnd in range(n_rounds):
        for i_rate in range(6):
            if progress is not None:
                progress.print("Optimizing GTR model, step %d of 12",
                               rnd * 6 + i_rate + 1)
            rates[i_rate], _, _ = onedimenmin(
                0.05, rates[i_rate], 20.0, lambda x: neg_loglk(x, i_rate),
                0.001, 0.0001)
    rates = rates / rates[5]
    if nj.log is not None:
        print("GTR Frequencies: %.4f %.4f %.4f %.4f" % tuple(freq), file=nj.log)
        print("GTR rates(ac ag at cg ct gt) %.4f %.4f %.4f %.4f %.4f %.4f"
              % tuple(rates), file=nj.log)
    tm = TransitionMatrix.gtr(rates, freq, dtype=ml.dtype)
    nj.transmat = tm
    ml.set_transmat(tm)
    ml.recompute_ml_profiles(sweep)
    ml_round.ml_lengths_pass(nj)


# --- Gamma(20) rescaling (ref tcc:5261-5359, 7192-7278) ---------------------


def ln_gamma(alpha: float) -> float:
    x = alpha
    f = 0.0
    if x < 7:
        f = 1.0
        z = x - 1
        while z + 1 < 7:
            z += 1
            f *= z
        x = z + 1
        f = -math.log(f)
    z = 1 / (x * x)
    return f + (x - 0.5) * math.log(x) - x + 0.918938533204673 \
        + (((-0.000595238095238 * z + 0.000793650793651) * z
            - 0.002777777777778) * z + 0.083333333333333) / x


def incomplete_gamma(x: float, alpha: float, ln_gamma_alpha: float) -> float:
    p = alpha
    g = ln_gamma_alpha
    accurate = 1e-8
    overflow = 1e30
    if x == 0:
        return 0.0
    if x < 0 or p <= 0:
        return -1.0
    factor = math.exp(p * math.log(x) - x - g)
    if x <= 1 or x < p:  # series expansion
        gin = 1.0
        term = 1.0
        rn = p
        while term > accurate:
            rn += 1
            term *= x / rn
            gin += term
        return gin * factor / p
    # continued fraction
    a = 1 - p
    b = a + x + 1
    term = 0.0
    pn = [1.0, x, x + 1, x * b, 0.0, 0.0]
    gin = pn[2] / pn[3]
    while True:
        a += 1
        b += 2
        term += 1
        an = a * term
        for i in range(2):
            pn[i + 4] = b * pn[i + 2] - an * pn[i]
        if pn[5] != 0:
            rn = pn[4] / pn[5]
            dif = abs(gin - rn)
            if dif <= accurate and dif <= accurate * rn:
                return 1 - factor * gin
            gin = rn
        pn = pn[2:6] + [0.0, 0.0]
        if abs(pn[3]) >= overflow:
            pn = [v / overflow for v in pn]


def p_gamma(x: float, alpha: float) -> float:
    return incomplete_gamma(x * alpha, alpha, ln_gamma(alpha))


def gamma_loglk(rates, site_loglk, mult, alpha, want_sites=False):
    """ref gammaLogLk tcc:5261-5293.  site_loglk: [nRate, P]."""
    n_rate = len(rates)
    d_rate = np.zeros(n_rate)
    for i in range(n_rate):
        p_min = 0.0 if i == 0 else \
            p_gamma(mult * (rates[i - 1] + rates[i]) / 2.0, alpha)
        p_max = 1.0 if i == n_rate - 1 else \
            p_gamma(mult * (rates[i] + rates[i + 1]) / 2.0, alpha)
        d_rate[i] = p_max - p_min
    maxll = site_loglk.max(axis=0)
    rel = (np.exp(site_loglk - maxll[None, :]) * d_rate[:, None]).sum(axis=0)
    sites = maxll + np.log(rel)
    total = float(sites.sum())
    return (total, sites) if want_sites else total


def rescale_gamma_loglk(nj, rates, site_loglk, progress=None):
    """ref rescaleGammaLogLk tcc:5295-5359.  Returns the rescale factor."""
    mult, alpha = 1.0, 1.0
    fx = -gamma_loglk(rates, site_loglk, mult, alpha)
    for i in range(10):
        if progress is not None:
            progress.print("Optimizing alpha round %d", i + 1)
        start = fx
        alpha, fx, _ = onedimenmin(
            0.01, alpha, 10.0,
            lambda a: -gamma_loglk(rates, site_loglk, mult, a), 0.001, 0.001)
        mult, fx, _ = onedimenmin(
            0.01, mult, 10.0,
            lambda m: -gamma_loglk(rates, site_loglk, m, alpha), 0.001, 0.001)
        if fx > start - 0.001:
            break
    total, sites = gamma_loglk(rates, site_loglk, mult, alpha, want_sites=True)
    if nj.log is not None:
        print("Gamma(%d) LogLk = %.3f alpha = %.3f rescaling lengths by %.3f"
              % (nj.options.n_rate_cats, total, alpha, 1 / mult), file=nj.log)
        if nj.options.log_file_name:
            # per-site Gamma log-likelihood table for CONSEL (ref tcc:5341-5357)
            nc = nj.options.n_rate_cats
            print("Gamma%dLogLk\t%.3f\tApproximate\tAlpha\t%.3f\tRescale\t%.3f"
                  % (nc, total, alpha, 1 / mult), file=nj.log)
            print("Gamma%d\tSite\tLogLk" % nc
                  + "".join("\t%.3f" % (r / mult) for r in rates), file=nj.log)
            for i_pos in range(nj.n_pos):
                print("Gamma%d\t%d\t%.3f" % (nc, i_pos, sites[i_pos])
                      + "".join("\t%.3f" % site_loglk[r, i_pos]
                                for r in range(len(rates))), file=nj.log)
    return 1.0 / mult


def branch_length_scale(nj, progress=None) -> None:
    """ref branchlengthScale tcc:298-308."""
    rates = ml_site_rates(nj.options.n_rate_cats)
    site_loglk = ml_site_likelihoods_by_rate(nj, rates, progress)
    scale = rescale_gamma_loglk(nj, rates, site_loglk, progress)
    nj.tree.branchlength[: nj.tree.maxnodes] *= scale


# ---------------------------------------------------------------------------
# SH-like supports (ref testSplitsML tcc:6856-6999, SHSupport :1126-1164)
# ---------------------------------------------------------------------------


def sh_support(loglk3, site_loglk3, counts_pb):
    """Fraction of resamples in which the chosen topology's lead over the
    second best stays below its lead in the data."""
    delta = min(loglk3[0] - loglk3[1], loglk3[0] - loglk3[2])
    resampled = site_loglk3 @ counts_pb - np.asarray(loglk3)[:, None]  # [3, B]
    order = np.sort(resampled, axis=0)
    n_support = int((order[2] - order[1] < delta).sum())
    return n_support / counts_pb.shape[1]


def test_splits_ml(nj, progress=None) -> SplitCount:
    """ref testSplitsML tcc:6856-6999: the host loop, split by split, with
    the constraint counts of the counts the ME phase left.  The ML phase
    runs ops/ml_round.sh_pass, which gives this loop's values over all
    splits at once."""
    sc = SplitCount()
    opts = nj.options
    tree = nj.tree
    if nj.n_seqs <= 3:
        return sc
    counts_pb = None
    if opts.n_bootstrap > 0:
        counts_pb = resample_count_matrix(resample_columns(nj), nj.n_pos)

    ups = UpProfiles(nj)
    i_done = 0
    close = constants.CLOSE_LOGLK_LIMIT
    for node in tree.postorder_nodes():
        if node < nj.n_seqs or node == tree.root:
            continue
        i_done += 1
        if progress is not None and i_done % 20 == 0:
            progress.print("ML split tests for %6d of %6d internal splits",
                           i_done, nj.n_seqs - 3)
        rows4, nodes4 = rearrange.setup_abcd(nj, ups, node, use_ml=True)
        rA, rB, rC, rD = rows4
        lens = [tree.branchlength[nodes4[0]], tree.branchlength[nodes4[1]],
                tree.branchlength[nodes4[2]], tree.branchlength[nodes4[3]],
                tree.branchlength[node]]
        len_ab = np.array(lens)
        len_ac = np.array([lens[0], lens[2], lens[1], lens[3], lens[4]])
        len_ad = np.array([lens[0], lens[3], lens[2], lens[1], lens[4]])
        loglk = np.zeros(3)
        site = np.zeros((3, nj.n_pos))
        loglk[ABvsCD], site[ABvsCD] = ml_quartet_loglk(
            nj, rA, rB, rC, rD, len_ab, want_site_lk=True)
        (loglk[ACvsBD], _, site[ACvsBD]), (loglk[ADvsBC], _, site[ADvsBC]) = \
            nj.ml.quartet_optimize([(rA, rC, rB, rD), (rA, rD, rC, rB)],
                                   [len_ac, len_ad], want_site_lk=True)
        # second pass on the closer alternative (ref :6932-6945)
        if loglk[ACvsBD] > loglk[ADvsBC]:
            if opts.ml_accuracy > 1 or loglk[ACvsBD] > loglk[ABvsCD] - close:
                loglk[ACvsBD], _, site[ACvsBD] = ml_quartet_optimize(
                    nj, rA, rC, rB, rD, len_ac, want_site_lk=True)
        else:
            if opts.ml_accuracy > 1 or loglk[ADvsBC] > loglk[ABvsCD] - close:
                loglk[ADvsBC], _, site[ADvsBC] = ml_quartet_optimize(
                    nj, rA, rD, rC, rB, len_ad, want_site_lk=True)

        if loglk[ABvsCD] >= loglk[ACvsBD] and loglk[ABvsCD] >= loglk[ADvsBC]:
            choice = ABvsCD
        elif loglk[ACvsBD] >= loglk[ABvsCD] and loglk[ACvsBD] >= loglk[ADvsBC]:
            choice = ACvsBD
        else:
            choice = ADvsBC
        bad_split = loglk[choice] > loglk[ABvsCD] + constants.TREE_LOGLK_DELTA
        pen, violated = split_constraints(nj, [nodes4])
        sc.count(np.array([loglk[choice] - loglk[ABvsCD]]),
                 np.array([bad_split]), pen, np.array([choice]), violated)
        if opts.n_bootstrap > 0:
            tree.support[node] = 0.0 if bad_split else sh_support(
                loglk, site, counts_pb)
        for nd in nodes4[:3]:
            ups.reset(nd)
    return sc


# ---------------------------------------------------------------------------
# ML phase orchestration (ref VeryFastTreeImpl.tcc:224-394)
# ---------------------------------------------------------------------------


def _clock(nj) -> float:
    """Host clock after the device's queued work has finished."""
    if nj.ml.device.type == "cuda":
        torch.cuda.synchronize(nj.ml.device)
    return time.perf_counter()


def run_ml_phase(nj, ml_nni_to_do: int, n_uniq: int, progress, log,
                 log_tree=None, resume=None) -> SplitCount:
    """The ML phase: with -threads > 1 its NNI rounds and lengths passes
    are the batched tier's (engine/batched.py), else the round kernels'
    (ops/ml_round.py).  Adds host-clock seconds of its parts to nj.timings
    (ml_lengths_s, ml_nni_s, cat_s, gtr_s, sh_s, gamma_s, ckpt_s), each
    ending after the device is done.

    With -checkpoint the engine's arrays are saved after every ML-NNI
    round (engine/checkpoint.py; each save's fetch and write seconds and
    bytes in nj.checkpoint_saves).  resume: (meta, extra) of
    checkpoint.load_checkpoint, which restarts the ML-NNI loop after the
    saved round with the saved rates, NNI ages and convergence state."""
    opts = nj.options
    ckpt_path = opts.checkpoint_file
    if resume is not None and not resume[0].get("has_ml"):
        resume = None       # saved before the ML phase: start it afresh
    if resume is None:
        nj.ml = MLProfiles(nj, nj.transmat)
    if opts.threads > 1:
        # as the JAX package's run_ml_phase dispatches it
        lengths_pass = batched.optimize_all_branch_lengths_batched

        def nni_round(i, stats):
            return batched.do_nni_batched(nj, i, ml_nni_to_do, True, stats)
    else:
        lengths_pass = ml_round.ml_lengths_pass

        def nni_round(i, stats):
            return ml_round.ml_nni_round(nj, i, ml_nni_to_do, stats)
    reset_gtr = opts.n_codes == 4 and opts.use_gtr and not opts.use_gtr_rates
    stats = rearrange.NNIStats.init(nj)
    t = dict.fromkeys(("ml_lengths_s", "ml_nni_s", "cat_s", "gtr_s", "sh_s",
                       "gamma_s", "ckpt_s"), 0.0)
    nj.checkpoint_saves = []

    def timed(key, fn, *args):
        t0 = _clock(nj)
        with annotate(key[:-2]):
            out = fn(*args)
        t[key] += _clock(nj) - t0
        return out

    def save(i_round, last_loglk, converged, cur):
        """The checkpoint after ML-NNI round i_round (1-based), with the
        NNI ages that the round wrote back to the host."""
        nj.checkpoint_saves.append(timed(
            "ckpt_s", checkpoint.save_checkpoint, nj, ckpt_path,
            {"phase": "ml_nni", "round": i_round, "last_loglk": last_loglk,
             "converged": converged, "ml_nni_to_do": ml_nni_to_do},
            {"stats_age": cur.age, "stats_subtree_age": cur.subtree_age,
             "stats_delta": cur.delta, "stats_support": cur.support}))

    start_round = 0
    last_loglk = -1e20
    converged = False
    if resume is not None and resume[0].get("phase") == "ml_nni":
        meta, extra = resume
        start_round = int(meta["round"])
        last_loglk = float(meta["last_loglk"])
        converged = bool(meta["converged"])
        stats = rearrange.NNIStats(
            extra["stats_age"], extra["stats_subtree_age"],
            extra["stats_delta"], extra["stats_support"])
        if log is not None:
            print(f"Resuming ML-NNI at round {start_round + 1} from "
                  f"checkpoint {ckpt_path}", file=log)

    def rates_and_gtr():
        if reset_gtr:
            timed("gtr_s", set_ml_gtr, nj,
                  opts.gtr_freq if opts.use_gtr_freq else None, progress)
        timed("cat_s", set_ml_rates, nj, progress)
        log_ml_rates(nj, log)

    if opts.ml_len and resume is None:
        max_round = int(0.5 + math.log2(max(n_uniq, 2)))
        len_loglk = -1e20
        for i_round in range(1, max_round + 1):
            old = nj.tree.branchlength.copy()
            timed("ml_lengths_s", lengths_pass, nj)
            if log_tree:
                log_tree("ML_Lengths%d", i_round)
            d_max_change = float(np.abs(
                old[: nj.tree.maxnode]
                - nj.tree.branchlength[: nj.tree.maxnode]).max())
            loglk = timed("ml_lengths_s", tree_loglk, nj)
            len_converged = i_round > 1 and (
                d_max_change < 0.001
                or loglk < len_loglk + constants.TREE_LOGLK_DELTA)
            if log is not None:
                print(f"{i_round} rounds ML lengths: LogLk = {loglk:.3f} "
                      f"Max-change {d_max_change:.4f}"
                      f"{' (converged)' if len_converged else ''}",
                      file=log)
            if i_round == 1:
                rates_and_gtr()
            if len_converged:
                break
            len_loglk = loglk

    if ml_nni_to_do > 0 and start_round == 0:
        timed("ml_lengths_s", lengths_pass, nj)

    for i in range(start_round, ml_nni_to_do):
        t0 = _clock(nj)
        with annotate("ml_nni"):
            changes, max_delta = nni_round(i, stats)
            if log_tree:
                log_tree("ML_NNI%d", i + 1)
            loglk = tree_loglk(nj)
        t["ml_nni_s"] += _clock(nj) - t0
        converged_here = i > 0 and (
            loglk < last_loglk + constants.TREE_LOGLK_DELTA
            or max_delta < constants.TREE_LOGLK_DELTA)
        if log is not None:
            print(f"ML-NNI round {i + 1}: LogLk = {loglk:.3f} NNIs {changes} "
                  f"max delta {max_delta:.2f}"
                  f"{' (final)' if converged else ''}", file=log)
        if progress is not None:
            progress.print("ML-NNI round %d of %d, %d changes", i + 1,
                           ml_nni_to_do, changes)
        if converged:
            break
        if converged_here:
            converged = True
        if converged or i == ml_nni_to_do - 2:
            # final round uses high-accuracy settings (ref :345-354)
            stats = rearrange.NNIStats.init(nj)
        last_loglk = loglk
        if i == 0 and len(nj.ml.rates_np) == 1:
            rates_and_gtr()
        if ckpt_path:
            save(i + 1, last_loglk, converged, stats)

    if ml_nni_to_do > 0:
        timed("ml_lengths_s", lengths_pass, nj)
        if log is not None:
            loglk = tree_loglk(nj)
            print(f"Optimize all lengths: LogLk = {loglk:.3f}", file=log)

    sc = SplitCount()
    if (ml_nni_to_do > 0 and not opts.fastest) or opts.n_bootstrap > 0:
        sc = timed("sh_s", ml_round.sh_pass, nj, progress)

    if opts.gamma_loglk and opts.n_rate_cats > 1:
        timed("gamma_s", branch_length_scale, nj, progress)
    nj.timings.update(t)
    return sc
