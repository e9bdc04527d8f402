"""Fused one-vs-all NJ scans: the CUDA kernels of ``csrc/nj_scan.cu`` and
their plain PyTorch twins (counterpart of ``veryfasttree_tpu/ops/
pallas_kernels.py``).

Per candidate row m the scan computes dist[m] and denom[m] of the query
profile against row m, the NJ criterion crit[m] = dist[m] - outd[m] /
(nActive - 2) (1e30 for rows >= m_real), and the best (lowest crit, lowest
index) row (ref setBestHit NeighbourJoining.tcc:3571-3646).

Each kernel wrapper runs the plain twin for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; it raises for anything
else, and nothing falls back.  ``launches`` on each wrapper counts its
kernel launches.  Results are in the accumulation dtype (float64); the best
index is an int64 tensor.
"""
from __future__ import annotations

import torch

from ..constants import NOCODE

from ..utils.device import ACCUM_DTYPE
from . import _build
from .kernels import _piece_dist

# Row alignment of the profile store; the row layout follows the reference
# (tile of its Pallas scan), so row indices mean the same in both packages.
TILE_M = 256


def _criterion(dist, outd, n_active, m_real):
    crit = dist - outd / (n_active - 2.0)
    rows = torch.arange(dist.shape[0], device=dist.device)
    return torch.where(rows < m_real, crit, 1e30)


def _best(crit):
    best = torch.argmin(crit)       # the first of equal minima
    return best, crit[best]


def nj_scan_ref(U2, W, a, wq, outd, n_active, m_real, use_matrix):
    """Plain twin of the dense scan.  U2 [M, P*C], W [M, P] in the store
    dtype; a [P*C] (the query times eigenval in matrix mode), wq [P] and
    outd [M] in the accumulation dtype.  Returns (best_idx, best_crit, dist,
    denom, crit)."""
    dots = U2.to(a.dtype) @ a
    denom = W.to(wq.dtype) @ wq
    dist = _piece_dist(dots if use_matrix else denom - dots, denom)
    crit = _criterion(dist, outd, n_active, m_real)
    return (*_best(crit), dist, denom, crit)


def nj_scan_codes_ref(codes, G, wq, outd, n_active, l_real, use_matrix):
    """Plain twin of the two-tier leaf scan.  codes int8 [L, P]; G [C, P]
    projected query table, wq [P], outd [L] in the accumulation dtype."""
    valid = codes != NOCODE
    wl = valid.to(wq.dtype)
    safe = torch.where(valid, codes.long(), 0)
    denom = wl @ wq
    picked = torch.zeros(codes.shape, dtype=G.dtype, device=G.device)
    for c in range(G.shape[0]):
        picked = picked + torch.where(safe == c, G[c][None, :], 0.0)
    pick = (picked * wl).sum(-1)
    dist = _piece_dist(pick if use_matrix else denom - pick, denom)
    crit = _criterion(dist, outd, n_active, l_real)
    return (*_best(crit), dist, denom, crit)


def _check(name, t, dtype, shape, align16=False):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_device(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"scan kernels run on CPU or CUDA tensors, not {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError("scan kernel inputs must share one device")


def _outputs(n, n_blocks, dev):
    f = dict(dtype=ACCUM_DTYPE, device=dev)
    return (torch.empty(n, **f), torch.empty(n, **f), torch.empty(n, **f),
            torch.empty(n_blocks, **f),
            torch.empty(n_blocks, dtype=torch.int64, device=dev),
            torch.empty((), dtype=torch.int64, device=dev),
            torch.empty((), **f))


def _launch(fn, name, tensors, scalars, outs, dev):
    args = [t.data_ptr() for t in tensors] + list(scalars) \
        + [t.data_ptr() for t in outs] \
        + [torch.cuda.current_stream(dev).cuda_stream]
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")


def nj_scan_dense(U2, W, a, wq, outd, n_active, m_real, use_matrix):
    """Dense scan over float32 store rows (args as in nj_scan_ref)."""
    if U2.device.type == "cpu":
        return nj_scan_ref(U2, W, a, wq, outd, n_active, m_real, use_matrix)
    _check_device(U2, W, a, wq, outd)
    M, K = U2.shape
    P = W.shape[1]
    if K % 4 or P % 4:
        raise ValueError(f"nj_scan_dense needs P*C and P divisible by 4, "
                         f"got {K} and {P}")
    _check("U2", U2, torch.float32, (M, K), align16=True)
    _check("W", W, torch.float32, (M, P), align16=True)
    _check("a", a, ACCUM_DTYPE, (K,))
    _check("wq", wq, ACCUM_DTYPE, (P,))
    _check("outd", outd, ACCUM_DTYPE, (M,))
    lib = _build.library()
    outs = _outputs(M, lib.vft_scan_dense_blocks(M), U2.device)
    _launch(lib.vft_nj_scan_dense_f64, "nj_scan_dense", (U2, W, a, wq, outd),
            (M, int(m_real), K, P, int(n_active), int(bool(use_matrix))),
            outs, U2.device)
    nj_scan_dense.launches += 1
    dist, denom, crit, _, _, best_idx, best_crit = outs
    return best_idx, best_crit, dist, denom, crit


nj_scan_dense.launches = 0


def nj_scan_codes(codes, G, wq, outd, n_active, l_real, use_matrix):
    """Two-tier leaf scan over int8 code rows (args as in
    nj_scan_codes_ref)."""
    if codes.device.type == "cpu":
        return nj_scan_codes_ref(codes, G, wq, outd, n_active, l_real,
                                 use_matrix)
    _check_device(codes, G, wq, outd)
    L, P = codes.shape
    C = G.shape[0]
    if P % 16:
        raise ValueError(f"nj_scan_codes needs P divisible by 16, got {P}")
    _check("codes", codes, torch.int8, (L, P), align16=True)
    _check("G", G, ACCUM_DTYPE, (C, P))
    _check("wq", wq, ACCUM_DTYPE, (P,))
    _check("outd", outd, ACCUM_DTYPE, (L,))
    lib = _build.library()
    outs = _outputs(L, lib.vft_scan_codes_blocks(L), codes.device)
    _launch(lib.vft_nj_scan_codes_f64, "nj_scan_codes", (codes, G, wq, outd),
            (L, int(l_real), P, C, int(n_active), int(bool(use_matrix))),
            outs, codes.device)
    nj_scan_codes.launches += 1
    dist, denom, crit, _, _, best_idx, best_crit = outs
    return best_idx, best_crit, dist, denom, crit


nj_scan_codes.launches = 0


def nj_scan(U, W, uq, wq, outd, n_active, eigenval=None):
    """Fused one-vs-all scan of a dense store.

    U: [M, P, C] weighted profiles; W: [M, P]; uq [P, C] / wq [P]: the query;
    outd: [M] out-distances; eigenval: [C] in matrix mode, None in
    %different mode.  Returns (best_idx, best_crit, dist, denom, crit).
    """
    M, P, C = U.shape
    a = uq.to(ACCUM_DTYPE)
    if eigenval is not None:
        a = a * eigenval.to(ACCUM_DTYPE)[None, :]
    return nj_scan_dense(U.reshape(M, P * C), W, a.reshape(-1),
                         wq.to(ACCUM_DTYPE), outd.to(ACCUM_DTYPE), n_active,
                         M, eigenval is not None)


def project_query(a, code_freq):
    """G[c, p] = sum_k a[p, k] * code_freq[c, k] in the accumulation dtype,
    summed left to right (as the join epoch's refresh scans do, so that the
    two give the same table)."""
    cf = code_freq.to(ACCUM_DTYPE)
    G = a[None, :, 0] * cf[:, None, 0]
    for k in range(1, a.shape[1]):
        G = G + a[None, :, k] * cf[:, None, k]
    return G


def nj_scan_two_tier(codes, W_int, U_int, uq, wq, outd, n_active, n_seqs,
                     eigenval, code_freq):
    """Fused one-vs-all scan of a two-tier store: leaves stream as int8 codes
    (nj_scan_codes), internal rows as dense vectors (nj_scan_dense); results
    concatenate in row order [leaves, internals] and the two bests merge with
    leaves winning ties.

    codes: [rows, P] int8 (the first n_seqs rows are the leaves);
    W_int/U_int: internal float rows (physical index = row - n_seqs); outd:
    [n_seqs + M_int].  Returns (best_idx, best_crit, dist, denom, crit).
    """
    P, C = uq.shape
    M_int = U_int.shape[0]
    use_matrix = eigenval is not None
    a = uq.to(ACCUM_DTYPE)
    wq = wq.to(ACCUM_DTYPE)
    outd = outd.to(ACCUM_DTYPE)
    if use_matrix:
        a = a * eigenval.to(ACCUM_DTYPE)[None, :]
        G = project_query(a, code_freq)
    else:
        G = a.T
    bl, cl, dist_l, den_l, crit_l = nj_scan_codes(
        codes[:n_seqs], G.contiguous(), wq, outd[:n_seqs].contiguous(),
        n_active, n_seqs, use_matrix)
    bi, ci, dist_i, den_i, crit_i = nj_scan_dense(
        U_int.reshape(M_int, P * C), W_int, a.reshape(-1), wq,
        outd[n_seqs: n_seqs + M_int].contiguous(), n_active, M_int,
        use_matrix)
    take_leaf = cl <= ci
    best_idx = torch.where(take_leaf, bl, bi + n_seqs)
    best_crit = torch.where(take_leaf, cl, ci)
    return (best_idx, best_crit, torch.cat([dist_l, dist_i]),
            torch.cat([den_l, den_i]), torch.cat([crit_l, crit_i]))
