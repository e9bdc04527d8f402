"""The fused NJ join step of the host join loop: the CUDA kernel of
``csrc/nj_join.cu`` and its plain twin.

The modes that the join epoch leaves to the host loop (-fastest, -2nd)
join in ``NeighbourJoining._join_loop_host``.  Its unfused body makes a
store call, and a fetch, for each step of a join; ``engine/fused.py`` (the
JAX package's fused join, ``veryfasttree_tpu/engine/fused.py``) makes one
call of ``nj_join_step`` instead: the chosen pair's and its members'
out-profile distances, the join's scalars (branch lengths, BIONJ weight,
diameters), the weighted average into the new node's row, the incremental
out-profile update, the new node's self- and out-distance, the merge
candidates' distances and the prefetch rows' out-distances, all returned
in one packed float64 vector (``OUT`` scalars, then the candidates' pair
distances and denominators, their out-profile distances and denominators,
then the prefetch rows' out-profile distances and denominators).

The twin computes what the unfused loop body computes, with the same store
calls in its order (``store_kernels`` twins, ``kernels.update_out_profile``)
and its host arithmetic, so that on a CPU store the fused loop is the
unfused loop bit for bit; the kernel reuses the per-call kernels' bodies,
so that on a CUDA store it is too.  A wrapper runs the twin for tensors on
the CPU and launches its kernel, or raises, for tensors on a CUDA device;
``nj_join_step.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, kernels, store_kernels
from .me_round import raise_on
from .store_kernels import _check_store

# the input scalars and the output scalars, in the order of the JAX
# package's fused join (veryfasttree_tpu/engine/fused.py _IN, _SCALARS)
IN = ("n_active", "stored_out_i", "stored_out_j", "refresh_i", "refresh_j",
      "selfdist_i", "selfweight_i", "selfdist_j", "selfweight_j",
      "diam_i", "diam_j", "vard_i", "vard_j", "totdiam", "pen_ij")
OUT = ("dist", "weight", "criterion", "out_i", "out_j", "bl_i", "bl_j",
       "bw", "diam_new", "vard_new", "selfdist_new", "selfweight_new",
       "dout_new", "wout_new")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double


class JoinParams(ctypes.Structure):
    """The kernel's parameters, field for field csrc/nj_join.cu JoinParams
    (every field 8 bytes; scal and rows are set by the C entry)."""
    _fields_ = (
        [(n, _P) for n in ("codes", "W", "U", "code_freq", "ev", "et",
                           "w_out", "f_out", "qU", "scal", "rows", "out",
                           "flag")]
        + [(n, _I) for n in ("n_rows", "leaf_rows", "P", "C", "i", "j", "t",
                             "n_cand", "n_pref", "bionj", "cons")]
        + [("tol", _D), ("seq", _I)])


def join_scalars(scal, pair, out_i, out_j, bionj: bool, cons: bool):
    """The join's scalars from the pair (i, j)'s (dist, denom) and i's and
    j's (dist, denom) to the old out-profile, as the unfused loop body
    computes them (NeighbourJoining.apply_out_refresh, set_dist_criterion,
    the branch lengths and BIONJ weight): OUT's first ten values, and the
    weight of row i in the average."""
    s = dict(zip(IN, (float(x) for x in scal)))
    n = int(s["n_active"])

    def out_distance(raw, who):
        dist, weight = raw
        sd, sw, diam = s["selfdist_" + who], s["selfweight_" + who], \
            s["diam_" + who]
        top = (n - 1) * (dist * weight * n - sw * sd)
        bottom = weight * n - sw
        if not bottom > 0.01:
            return 3.0
        return top / bottom - diam * (n - 1) - (s["totdiam"] - diam)

    o_i = out_distance(out_i, "i") if s["refresh_i"] > 0 else s["stored_out_i"]
    o_j = out_distance(out_j, "j") if s["refresh_j"] > 0 else s["stored_out_j"]
    weight = pair[1] if pair[1] > 0 else 0.01
    dist = pair[0] - (s["diam_i"] + s["diam_j"])
    if cons:
        dist = dist + s["pen_ij"]
    crit = dist - (o_i + o_j) / (n - 2)
    raw_ij = dist + s["diam_i"] + s["diam_j"]
    delta = (o_i - o_j) / (n - 2)
    bl_i = (dist + delta) / 2
    bl_j = (dist - delta) / 2
    bw = 0.5
    vard_i, vard_j = s["vard_i"], s["vard_j"]
    var_ij = raw_ij - vard_i - vard_j
    if bionj and weight > 0.01 and var_ij > 0.001:
        # BIONJ weighting, Gascuel 1997 eq. 9 via out-profile moments
        (do0, wo0), (do1, wo1) = out_i, out_j
        var_i_weight = n * wo0 - s["selfweight_i"] - weight
        var_j_weight = n * wo1 - s["selfweight_j"] - weight
        var_i_top = do0 * wo0 * n - s["selfdist_i"] * s["selfweight_i"] \
            - raw_ij * weight
        var_j_top = do1 * wo1 * n - s["selfdist_j"] * s["selfweight_j"] \
            - raw_ij * weight
        if var_j_weight > 0.01 and var_i_weight > 0.01:
            d_pv_out = (n - 2) * (var_j_top / var_j_weight
                                  - var_i_top / var_i_weight)
            d_var_diam = (n - 2) * (vard_i - vard_j)
            bw = 0.5 + (d_pv_out + d_var_diam) / (2 * (n - 2) * var_ij)
        bw = min(max(bw, 0.0), 1.0)
    diam_new = bw * (bl_i + s["diam_i"]) + (1 - bw) * (bl_j + s["diam_j"])
    vard_new = bw * vard_i + (1 - bw) * vard_j + bw * (1 - bw) * var_ij
    return [dist, weight, crit, o_i, o_j, bl_i, bl_j, bw, diam_new,
            vard_new], (bw if bionj else 0.5)


def nj_join_step_ref(codes, W, U, code_freq, eigenval, eigentot, leaf_rows,
                     w_out, f_out, tol, bionj, cons, scal, ijt, cand, pref):
    """Plain twin of nj_join_step: the unfused loop body's store calls
    (the twins of me_dists and me_average, and update_out_profile), each
    with the rows the body gives it, and its host arithmetic."""
    i, j, t = (int(x) for x in ijt)
    cand = [int(x) for x in cand]
    pref = [int(x) for x in pref]
    n_active = int(scal[0])

    def dists(q_rows=(), query=(None, None), iis=(), jjs=()):
        d = store_kernels.me_dists_ref(codes, W, U, code_freq, eigenval,
                                       leaf_rows, q_rows, *query, iis, jjs)
        return d[0].tolist(), d[1].tolist()

    def out_query():
        return w_out[:, None] * f_out, w_out

    d_o, w_o = dists([i, j], out_query())
    d_p, w_p = dists(iis=[i], jjs=[j])
    head, bw_avg = join_scalars(scal, (d_p[0], w_p[0]), (d_o[0], w_o[0]),
                                (d_o[1], w_o[1]), bionj, cons)
    store_kernels.me_average_ref(codes, W, U, code_freq, eigentot, leaf_rows,
                                 [t], [i], [j], bw_avg, tol)
    d_s, w_s = dists(iis=[t], jjs=[t])
    rows = torch.as_tensor([i, j, t], dtype=torch.int64, device=codes.device)
    _, wg, ug = store_kernels.rows_cwu(codes, W, U, rows, code_freq,
                                       leaf_rows)
    w2, f2 = kernels.update_out_profile(
        w_out, f_out, ug[0], wg[0], ug[1], wg[1], ug[2], wg[2], n_active,
        code_freq, eigentot, tol)
    w_out.copy_(w2)
    f_out.copy_(f2)
    d_q, w_q = dists([t, *cand, *pref], out_query())
    d_c, w_c = dists(iis=[t] * len(cand), jjs=cand) if cand else ([], [])
    nc = len(cand)
    vals = (head + [d_s[0], w_s[0], d_q[0], w_q[0]] + d_c + w_c
            + d_q[1: 1 + nc] + w_q[1: 1 + nc] + d_q[1 + nc:] + w_q[1 + nc:])
    return torch.tensor(vals, dtype=torch.float64, device=codes.device)


class _Scratch:
    """A device's reused buffers: the query, the staged inputs, the flag."""

    def __init__(self, dev):
        self.flag = torch.zeros(1, dtype=torch.int32, device=dev)
        self.seq = 0
        self.qU = torch.empty(0, dtype=torch.float32, device=dev)
        self.inp = torch.empty(0, dtype=torch.uint8, device=dev)


_SCRATCH: dict = {}


def nj_join_step(codes, W, U, code_freq, eigenval, eigentot, leaf_rows, w_out,
                 f_out, tol, bionj, cons, scal, ijt, cand, pref):
    """One join of the host join loop: rows (i, j) = ijt[:2] averaged into
    row t = ijt[2] (at or above leaf_rows) and the out-profile (w_out [P],
    f_out [P, C], float32) updated, in place; scal: the IN scalars
    (float64, numpy); cand, pref: the merge candidates and the prefetch
    rows (host integer arrays); eigenval [C] and eigentot [C] in matrix
    mode, None in %different mode; cons: add pen_ij to the pair's
    distance.  Returns the packed float64 result, len(OUT) + 4 len(cand) +
    2 len(pref) values on the store's device, not fetched.  A row outside
    the store raises IndexError."""
    if codes.device.type == "cpu":
        return nj_join_step_ref(codes, W, U, code_freq, eigenval, eigentot,
                                leaf_rows, w_out, f_out, tol, bionj, cons,
                                scal, ijt, cand, pref)
    n_rows, P, C = _check_store(codes, W, U, code_freq, leaf_rows)
    dev = codes.device
    for name, x, shape in (("w_out", w_out, (P,)), ("f_out", f_out, (P, C))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"nj_join_step: {name} must be contiguous "
                             f"float32 {shape} on the store's device")
    scal = np.asarray(scal, dtype=np.float64)
    if scal.shape != (len(IN),):
        raise ValueError(f"nj_join_step: {len(IN)} input scalars, not "
                         f"{scal.shape}")
    rows = np.concatenate([np.asarray(cand, dtype=np.int64),
                           np.asarray(pref, dtype=np.int64)])
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise IndexError("nj_join_step: a row index lies outside the store")
    # the staged inputs: the scalars, then the rows as int32
    inp = np.concatenate([scal.view(np.uint8),
                          rows.astype(np.int32).view(np.uint8)])
    sc = _SCRATCH.get(dev)
    if sc is None:
        sc = _SCRATCH[dev] = _Scratch(dev)
    if sc.qU.numel() < P * C:
        sc.qU = torch.empty(P * C, dtype=torch.float32, device=dev)
    if sc.inp.numel() < inp.size:
        sc.inp = torch.empty(2 * inp.size, dtype=torch.uint8, device=dev)
    sc.seq = sc.seq % 0x7FFFFFFF + 1
    ev = et = None
    if eigenval is not None:
        ev = eigenval.to(device=dev, dtype=torch.float64).contiguous()
        et = eigentot.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(len(OUT) + 4 * len(cand) + 2 * len(pref),
                      dtype=torch.float64, device=dev)
    i, j, t = (int(x) for x in ijt)
    params = JoinParams(
        codes=codes.data_ptr(), W=W.data_ptr(), U=U.data_ptr(),
        code_freq=code_freq.data_ptr(),
        ev=ev.data_ptr() if ev is not None else None,
        et=et.data_ptr() if et is not None else None,
        w_out=w_out.data_ptr(), f_out=f_out.data_ptr(), qU=sc.qU.data_ptr(),
        out=out.data_ptr(), flag=sc.flag.data_ptr(), n_rows=n_rows,
        leaf_rows=int(leaf_rows), P=P, C=C, i=i, j=j, t=t,
        n_cand=len(cand), n_pref=len(pref), bionj=int(bool(bionj)),
        cons=int(bool(cons)), tol=float(np.float32(tol)), seq=sc.seq)
    used = ctypes.c_int(0)
    rc = _build.library().vft_nj_join_step_f32(
        ctypes.byref(params), inp.ctypes.data, inp.size, sc.inp.data_ptr(),
        ctypes.byref(used), torch.cuda.current_stream(dev).cuda_stream)
    if rc == -1:
        raise IndexError("nj_join_step: a row index lies outside the store, "
                         "or the new row among the code-only leaves")
    raise_on(rc, "nj_join_step")
    nj_join_step.launches += 1
    nj_join_step.grid = used.value
    return out


nj_join_step.launches = 0
nj_join_step.grid = 0
