"""The fused join step: one launch and one fetch per NJ join of the host
join loop (counterpart of ``veryfasttree_tpu/engine/fused.py``).

The join epoch (engine/epoch.py) runs the default top-hits mode on the
card; -fastest and -2nd keep the host join loop
(``NeighbourJoining._join_loop_host``), whose unfused body makes a store
call and a fetch for each step of a join.  Where the JAX package takes its
fused branch (a join that does not reset the out-profile, with top hits
on, and ``USE_FUSED_JOIN``), ``join_step`` packs the join's inputs, makes
one call of ``ops/join_kernels.nj_join_step`` (the CUDA kernel on the card,
its plain twin on the CPU) and one fetch of the packed result, then does
the host bookkeeping of the unfused body with the fetched values:

    out-distances of i, j against the out-profile     (ref tcc:1012-1083)
    the pair distance and criterion of the join       (tcc:1115-1124)
    branch lengths and the BIONJ weight               (tcc:2914-3007)
    the weighted profile average into the new node    (tcc:2055-2135)
    its self-distance, the out-profile update         (tcc:943-1010)
    its out-distance against the updated out-profile
    the top-hits merge candidates' distances          (tcc:4786-4833)
    the prefetch rows' out-profile distances, cached for the host
    (NeighbourJoining.cache_out_raw)

The debug counters are the unfused body's: the JAX package's fused join
counts fewer profile operations than its own unfused loop (ROADMAP.md,
Queue 3 item 1), so the candidates' evaluations that the unfused merge
makes are counted here whether the merge uses them or not.
"""
from __future__ import annotations

import numpy as np

from ..ops import join_kernels


def join_step(nj, join, n_active: int, newnode: int, cand_js=None,
              prefetch=None) -> dict:
    """The join of `join` at n_active into `newnode` with all its host
    bookkeeping.  `cand_js` (or None) is the deduped, ancestor-remapped
    top-hits merge candidate list (TopHits.prepare_join_merge); `prefetch`
    (or None) rows whose distances to the updated out-profile are scanned
    in the same launch and cached for host-only refreshes until the
    out-profile changes.  Returns a dict of the join's scalars
    (join_kernels.OUT) and, with candidates, cand_dist_raw, cand_weight, cand_dout and
    cand_wout, ordered like cand_js."""
    prof = nj.prof
    opts = nj.options
    i, j = join.i, join.j
    cand = np.asarray(cand_js if cand_js is not None else [], dtype=np.int64)
    pref = np.asarray(prefetch if prefetch is not None else [],
                      dtype=np.int64)
    pen = 0.0
    if nj.n_cons:
        pen = opts.constraint_weight * nj.join_penalties_batch([i], [j])[0]
    refresh_i = nj.n_out_dist_active[i] != n_active
    refresh_j = nj.n_out_dist_active[j] != n_active
    scal = np.array([
        n_active, nj.out_distances[i], nj.out_distances[j],
        1.0 if refresh_i else 0.0, 1.0 if refresh_j else 0.0,
        nj.selfdist[i], nj.selfweight[i], nj.selfdist[j], nj.selfweight[j],
        nj.diameter[i], nj.diameter[j],
        nj.var_diameter[i], nj.var_diameter[j], nj.totdiam, pen],
        dtype=np.float64)
    packed = join_kernels.nj_join_step(
        prof.codes, prof.W, prof.U, prof.code_freq, prof._ev, prof._et,
        prof._leaf_rows, prof.w_out, prof.f_out, prof.tol, bool(opts.bionj),
        bool(nj.n_cons), scal, (i, j, newnode), cand, pref)
    prof.out_version += 1   # the out-profile was updated in the launch
    out = packed.cpu().numpy()   # the one fetch
    res = {name: float(out[k]) for k, name in enumerate(join_kernels.OUT)}
    nc, npf = len(cand), len(pref)
    base = len(join_kernels.OUT)
    if nc:
        res["cand_dist_raw"] = out[base: base + nc]
        res["cand_weight"] = out[base + nc: base + 2 * nc]
        res["cand_dout"] = out[base + 2 * nc: base + 3 * nc]
        res["cand_wout"] = out[base + 3 * nc: base + 4 * nc]
        # the candidates' scans double as cache entries
        nj.cache_out_raw(cand, res["cand_dout"], res["cand_wout"])
    if npf:
        base += 4 * nc
        nj.cache_out_raw(pref, out[base: base + npf],
                         out[base + npf: base + 2 * npf])

    # ---- host bookkeeping (the unfused loop body's) --------------------
    tree = nj.tree
    nj.out_distances[i] = res["out_i"]
    nj.out_distances[j] = res["out_j"]
    nj.n_out_dist_active[i] = n_active
    nj.n_out_dist_active[j] = n_active
    tree.branchlength[i] = res["bl_i"]
    tree.branchlength[j] = res["bl_j"]
    nj.diameter[newnode] = res["diam_new"]
    nj.var_diameter[newnode] = res["vard_new"]
    nj.selfdist[newnode] = res["selfdist_new"]
    nj.selfweight[newnode] = res["selfweight_new"]
    nj.totdiam += res["diam_new"] - nj.diameter[i] - nj.diameter[j]
    if nj.n_cons:
        nj.con_on[newnode] = nj.con_on[i] + nj.con_on[j]
        nj.con_off[newnode] = nj.con_off[i] + nj.con_off[j]
    d = nj.debug
    d.profile_avg_ops += 1
    # setOutDistance of i and j, the pair, the BIONJ moments where taken
    d.outprofile_ops += int(refresh_i) + int(refresh_j)
    if i < nj.n_seqs and j < nj.n_seqs:
        d.seq_ops += 1
    else:
        d.profile_ops += 1
    raw_ij = res["dist"] + nj.diameter[i] + nj.diameter[j]
    var_ij = raw_ij - nj.var_diameter[i] - nj.var_diameter[j]
    if opts.bionj and res["weight"] > 0.01 and var_ij > 0.001:
        d.outprofile_ops += 2

    # the new node's out-distance at the next n_active (the unfused merge
    # refreshes it first)
    nj.apply_out_refresh(np.array([newnode]), np.array([res["dout_new"]]),
                         np.array([res["wout_new"]]), n_active - 1)
    d.outprofile_ops += 1
    nj.cache_out_raw([newnode], [res["dout_new"]], [res["wout_new"]])
    return res
