"""The sharded kernels of the JAX package's multi-chip tests over a Mesh
(counterpart of ``veryfasttree_tpu/parallel/sharded.py``, whose
shard_map functions these take the inputs and outputs of).

Each function builds a callable that every rank of the mesh calls with
its own shards: positions split on ``sp`` (each rank its block), rows on
``dp``.  A sum over positions is the rank's float64 partial, exchanged and
added in rank order (``Mesh.exchange_sum``, where the JAX package has
psum('sp')); the scan's partial sums and finish are the card's kernels
(``ops/scan_kernels``).  Outputs sharded on dp or sp are the rank's
shard; replicated outputs are the same bits on every rank.
"""
from __future__ import annotations

import torch

from ..ops import kernels, scan_kernels
from ..utils.device import ACCUM_DTYPE


def dist_scan_sharded(mesh, use_matrix: bool):
    """The one-vs-all scan and its best join (JAX sharded.py:22).

    The callable takes U [M, P, C] (rows on dp, positions on sp: the
    rank's [M / dp, P / sp, C]), W [M, P] (dp, sp), the query uq [P, C] and
    wq [P] (sp), out_dists [M] (dp) and n_active, and returns (best_index,
    best_criterion, dist, denom): the global lowest-(criterion, index) row,
    replicated, and the rank's rows' dist and denom.  The partial scan of
    the rank's positions (nj_scan_dense_partial), the exchange along sp,
    nj_scan_finish over the rank's rows (top = dots with use_matrix, as the
    JAX function takes it: the query as given), then the dp ranks' bests:
    the lowest criterion, ties to the lowest global index (JAX :43-50)."""

    def scan(U, W, uq, wq, out_dists, n_active):
        M, P, C = U.shape
        a = uq.to(ACCUM_DTYPE).reshape(-1)
        part = scan_kernels.nj_scan_dense_partial(
            U.reshape(M, P * C).contiguous(), W.contiguous(), a,
            wq.to(ACCUM_DTYPE))
        best, best_crit, dist, denom, _ = scan_kernels.nj_scan_finish(
            mesh.exchange(part), out_dists.to(ACCUM_DTYPE).contiguous(),
            n_active, M, use_matrix)
        cand = torch.stack([best_crit.to(ACCUM_DTYPE),
                            (best + mesh.dp_index * M).to(ACCUM_DTYPE)])
        everyone = mesh.exchange(cand, axis="dp")
        order = sorted(range(mesh.dp), key=lambda d: (
            float(everyone[d, 0]), float(everyone[d, 1])))
        win = everyone[order[0]]
        return win[1].to(torch.int64), win[0], dist, denom

    return scan


def pair_loglk_sharded(mesh):
    """The Jukes-Cantor pair log-likelihood over the positions (JAX
    sharded.py:62): the callable takes f1, f2 [P, C], w1, w2 [P] (sp),
    psame, pdiff [n_cats], ratecat [P] and pos_mask [P] (sp) and returns
    the sum over every rank's positions of log(max(lk, 1e-37)), lk =
    pdiff * sum(f2) + (psame - pdiff) * f1 . f2: the rank's sum of logs is
    its partial, added in rank order."""

    def loglk(f1, f2, w1, w2, psame, pdiff, ratecat, pos_mask):
        rc = ratecat.long()
        ps, pd = psame[rc], pdiff[rc]
        dot = (f1 * f2).sum(-1)
        lk = pd * f2.sum(-1) + (ps - pd) * dot
        lk = torch.where(pos_mask, lk, torch.ones_like(lk))
        part = torch.log(torch.clamp_min(lk, 1e-37)).to(ACCUM_DTYPE).sum()
        return mesh.exchange_sum(part.reshape(1))[0]

    return loglk


def posterior_jc_sharded(mesh):
    """The JC posterior profile, local to each position (JAX
    sharded.py:82): the callable takes the rank's f1, f2 [P, C], w1, w2
    [P], the scalars ps1, pd1, ps2, pd2 and ratecat [P], and returns the
    rank's (w_out [P], f_out [P, C]) of ops/kernels.posterior_jc."""

    def posterior(f1, f2, w1, w2, ps1, pd1, ps2, pd2, ratecat):
        return kernels.posterior_jc(f1, f2, w1, w2, ps1, pd1, ps2, pd2,
                                    ratecat.long())

    return posterior


def out_profile_sharded(mesh):
    """The out-profile (JAX sharded.py:97): the callable takes U [M, P, C]
    and W [M, P] (rows on dp, positions on sp) and the rank's rows' mask
    [M] (dp), and returns the rank's positions' (w_out [P], f_out [P, C]):
    the masked row sums of the rank's rows, added over the dp ranks in
    rank order (the reference's vector_add under omp critical, tcc:780-783),
    divided by the active count, w_out at least 1e-20, f_out normalized
    where its total exceeds 1e-10."""

    def out_profile(U, W, mask):
        m = mask.to(U.dtype)
        n = mesh.exchange_sum(m.sum().reshape(1), axis="dp")[0]
        w_out = mesh.exchange_sum(torch.einsum("m,mp->p", m, W), axis="dp") \
            / torch.clamp_min(n, 1)
        accum = mesh.exchange_sum(torch.einsum("m,mpc->pc", m, U), axis="dp")
        w_out = torch.clamp_min(w_out, 1e-20)
        total = accum.sum(-1)
        ok = total > 1e-10
        f_out = accum / torch.where(ok, total, torch.ones_like(total))[..., None]
        return w_out, f_out

    return out_profile


def training_step(mesh, use_matrix: bool = False):
    """One sharded NJ step of the JAX package's multi-chip dry run (JAX
    sharded.py:120): the scan's best join (dist_scan_sharded), the balanced
    average of the query with the rank's first row, and the JC pair
    log-likelihood of the average against the query over every rank's
    positions.  The callable takes dist_scan_sharded's inputs, then psame,
    pdiff [n_cats], ratecat [P] and pos_mask [P] (sp), and returns (best,
    best_crit, u_new [P, C], w_new [P], ll): u_new and w_new the rank's
    positions and ll its sp row's, from its own first row (the JAX package
    returns those of dp index 0)."""
    scan = dist_scan_sharded(mesh, use_matrix)

    def step(U, W, uq, wq, out_dists, n_active, psame, pdiff, ratecat,
             pos_mask):
        best, best_crit, _, _ = scan(U, W, uq, wq, out_dists, n_active)
        u_new = 0.5 * (U[0] + uq)
        w_new = 0.5 * (W[0] + wq)
        rc = ratecat.long()
        dot = (u_new * uq).sum(-1)
        lk = pdiff[rc] + (psame[rc] - pdiff[rc]) * dot
        lk = torch.where(pos_mask, torch.clamp_min(lk, 1e-6),
                         torch.ones_like(lk))
        part = torch.log(lk).to(ACCUM_DTYPE).sum()
        ll = mesh.exchange_sum(part.reshape(1))[0]
        return best, best_crit, u_new, w_new, ll

    return step
