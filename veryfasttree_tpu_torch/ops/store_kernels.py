"""Profile-store kernels of the minimum-evolution phases: the CUDA kernels
of ``csrc/me_store.cu`` and their plain PyTorch twins.

The host loops that are left (-slow, -bionj, the unfused join loop) ask the
store for a handful of row-pair distances, or one profile average, at a
time.  The JAX package compiles each such store call into one XLA
computation (``veryfasttree_tpu/engine/profiles.py``: ``_dist_rows``,
``_dist_gather``, ``_refresh_and_pairs``, ``_join_update``); here each is
one launch of ``me_dists`` or ``me_average`` whose row indices travel in
the launch's parameters, so a call costs no host-to-device copy and, for an
average, no synchronisation.

The whole-tree passes (the ME branch lengths, the split test, the bottom-up
recompute) take two kernels over tables sent to the card once:

* ``me_average_sweep``: every balanced average of a dependency-ordered
  ``AverageTables`` in one launch (the JAX package's ``_avg_sweep_impl``),
  each row bit for bit what ``me_average``'s per-level launches write;
* ``me_dists_list``: the distances of a list of row pairs of any length in
  one launch, each pair bit for bit what ``me_dists`` gives it;
* ``me_dist_pieces_list``: the local bootstrap's per-position pieces and
  weights of a list of row pairs in one launch (the JAX package's
  ``_dist_pieces``), float32 rounded as that package's CPU build rounds
  them.

Store layout: codes int8 [n_rows, P] for every row, W [n_float, P] and U
[n_float, P, C] for the float rows; rows below ``leaf_rows`` (the leaves of
a two-tier store, 0 for a dense one) are expanded from their codes, and a
float row's physical index is ``row - leaf_rows``.

As for the scan kernels, a wrapper runs the twin for tensors on the CPU and
launches its kernel for tensors on a CUDA device, and ``launches`` counts
its kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils.device import ACCUM_DTYPE
from . import _build, dataflow, kernels

_C_CODES = (4, 20)


def rows_cwu(codes, W, U, rows, code_freq, leaf_rows: int):
    """(codes, W, U) of arbitrary rows (an int64 index tensor); rows below
    leaf_rows are expanded from their codes."""
    c = codes[rows]
    if not leaf_rows:
        return c, W[rows], U[rows]
    is_leaf = rows < leaf_rows
    phys = torch.clamp_min(rows - leaf_rows, 0)
    u_l, w_l = kernels.leaf_u(c, code_freq, U.dtype)
    return (c, torch.where(is_leaf[:, None], w_l, W[phys]),
            torch.where(is_leaf[:, None, None], u_l, U[phys]))


def _index(rows, device):
    return torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)


def me_dists_ref(codes, W, U, code_freq, eigenval, leaf_rows, q_rows, qU, qW,
                 iis, jjs):
    """Plain twin of me_dists: me_dists_partial_ref's sums, finished."""
    return me_pair_finish_ref(me_dists_partial_ref(
        codes, W, U, code_freq, eigenval, leaf_rows, q_rows, qU, qW, iis,
        jjs)[None], eigenval is not None)


def _check_store(codes, W, U, code_freq, leaf_rows):
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"store kernels run on CPU or CUDA tensors, not {dev}")
    n_rows, P = codes.shape
    n_float, C = U.shape[0], U.shape[-1]
    if C not in _C_CODES:
        raise ValueError(f"store kernels take {_C_CODES} codes, got {C}")
    if codes.dtype != torch.int8 or W.dtype != torch.float32 \
            or U.dtype != torch.float32 or code_freq.dtype != torch.float32:
        raise ValueError("store kernels need an int8 code array and a float32 "
                         "store (no -double-precision on CUDA)")
    if tuple(W.shape) != (n_float, P) or tuple(U.shape) != (n_float, P, C) \
            or tuple(code_freq.shape) != (C, C):
        raise ValueError("store arrays do not share one layout")
    for t in (codes, W, U, code_freq):
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("store arrays must be contiguous on one device")
    if leaf_rows + n_float < n_rows:
        raise ValueError("float rows do not cover the rows above leaf_rows")
    return n_rows, P, C


def _raise_on(rc, name):
    """The C entries return 0, a cudaError of the launch, or -1 for a row
    index outside the store or an average's target below leaf_rows (checked
    before anything is launched)."""
    if rc == -1:
        raise IndexError(f"{name}: a row index lies outside the store, or a "
                         "target among the code-only leaves")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")


def me_dists(codes, W, U, code_freq, eigenval, leaf_rows, q_rows, qU, qW, iis,
             jjs):
    """Row distances in one call: the query (qU [P, C], qW [P]) against each
    of q_rows, then the pairs (iis[k], jjs[k]).  Row indices are host
    integer arrays; eigenval is [C] in matrix mode, None in %different mode.
    Returns [2, len(q_rows) + len(iis)] float64: dist, then denom.  An
    index outside the store raises IndexError."""
    if codes.device.type == "cpu":
        return me_dists_ref(codes, W, U, code_freq, eigenval, leaf_rows,
                            q_rows, qU, qW, iis, jjs)
    out = _pair_dists(codes, W, U, code_freq, eigenval, leaf_rows, q_rows, qU,
                      qW, iis, jjs, "me_dists")
    if out.shape[1]:
        me_dists.launches += 1
    return out


def _pair_dists(codes, W, U, code_freq, eigenval, leaf_rows, q_rows, qU, qW,
                iis, jjs, name, partial=False):
    """The launch of me_dists (or, partial, me_dists_partial) on CUDA."""
    n_rows, P, C = _check_store(codes, W, U, code_freq, leaf_rows)
    R, K = len(q_rows), len(iis)
    if len(jjs) != K:
        raise ValueError("iis and jjs differ in length")
    dev = codes.device
    qu = qw = None
    if R:
        if qU.dtype != torch.float32 or tuple(qU.shape) != (P, C) \
                or tuple(qW.shape) != (P,) or qW.dtype != torch.float32 \
                or qU.device != dev or qW.device != dev:
            raise ValueError("the query must be float32 [P, C] and [P] on "
                             "the store's device")
        qu, qw = qU.contiguous(), qW.contiguous()
    ev = None
    if eigenval is not None:
        ev = eigenval.to(device=dev, dtype=ACCUM_DTYPE).contiguous()
    # pair k is (rows[k], rows[R + K + k]); -1 is the query
    rows = np.concatenate([np.full(R, -1), iis, q_rows, jjs]).astype(np.int32)
    out = torch.empty((2, R + K), dtype=ACCUM_DTYPE, device=dev)
    if R + K == 0:
        return out
    lib = _build.library()
    _raise_on(lib.vft_me_pair_dists_partial_f32(
        codes.data_ptr(), W.data_ptr(), U.data_ptr(), code_freq.data_ptr(),
        n_rows, int(leaf_rows), P, C, qu.data_ptr() if R else None,
        qw.data_ptr() if R else None, ev.data_ptr() if ev is not None else None,
        rows.ctypes.data, R + K, int(partial), out[0].data_ptr(),
        out[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream), name)
    return out


me_dists.launches = 0


# ----------------------------------------------------- partial sums (mesh)
# Under a mesh (parallel/) each rank's store holds a block of the positions:
# the partial calls write each pair's sums over the block unfinished, [2, n]
# float64 (den, then dots), the ranks exchange them (parallel.mesh.Mesh.
# exchange: [k, 2, n] in rank order), and me_pair_finish adds them in rank
# order and divides.  At k = 1 a pair's (dist, denom) is me_dists' and
# me_dists_list's bit for bit.

def me_dists_partial_ref(codes, W, U, code_freq, eigenval, leaf_rows, q_rows,
                         qU, qW, iis, jjs):
    """Plain twin of me_dists_partial: me_dists_ref's sums."""
    dev = codes.device
    ev = eigenval.to(ACCUM_DTYPE) if eigenval is not None else None
    parts = []
    if len(q_rows):
        _, Wr, Ur = rows_cwu(codes, W, U, _index(q_rows, dev), code_freq,
                             leaf_rows)
        parts.append(kernels.me_dots_many_2d(
            Ur.to(ACCUM_DTYPE).reshape(len(q_rows), -1), Wr.to(ACCUM_DTYPE),
            qU.to(ACCUM_DTYPE), qW.to(ACCUM_DTYPE), ev))
    if len(iis):
        _, W1, U1 = rows_cwu(codes, W, U, _index(iis, dev), code_freq,
                             leaf_rows)
        _, W2, U2 = rows_cwu(codes, W, U, _index(jjs, dev), code_freq,
                             leaf_rows)
        parts.append(kernels.me_dots_rows(
            U1.to(ACCUM_DTYPE), W1.to(ACCUM_DTYPE), U2.to(ACCUM_DTYPE),
            W2.to(ACCUM_DTYPE), ev))
    if not parts:
        return torch.empty((2, 0), dtype=ACCUM_DTYPE, device=dev)
    return torch.stack([torch.cat([p[1] for p in parts]),
                        torch.cat([p[0] for p in parts])])


def me_dists_partial(codes, W, U, code_freq, eigenval, leaf_rows, q_rows, qU,
                     qW, iis, jjs):
    """me_dists' pairs, each pair's sums over the store's positions with no
    finish: [2, len(q_rows) + len(iis)] float64, den then dots (args as
    me_dists')."""
    if codes.device.type == "cpu":
        return me_dists_partial_ref(codes, W, U, code_freq, eigenval,
                                    leaf_rows, q_rows, qU, qW, iis, jjs)
    out = _pair_dists(codes, W, U, code_freq, eigenval, leaf_rows, q_rows,
                      qU, qW, iis, jjs, "me_dists_partial", partial=True)
    if out.shape[1]:
        me_dists_partial.launches += 1
    return out


me_dists_partial.launches = 0


def me_dists_list_partial(codes, W, U, code_freq, eigenval, leaf_rows, iis,
                          jjs):
    """me_dists_list's pairs, each pair's sums with no finish: [2, K]
    float64, den then dots (args as me_dists_list's)."""
    iis = np.asarray(iis, dtype=np.int64)
    jjs = np.asarray(jjs, dtype=np.int64)
    if len(iis) != len(jjs):
        raise ValueError("iis and jjs differ in length")
    if codes.device.type == "cpu":
        return me_dists_partial_ref(codes, W, U, code_freq, eigenval,
                                    leaf_rows, (), None, None, iis, jjs)
    out = _pair_list(codes, W, U, code_freq, eigenval, leaf_rows, iis, jjs,
                     "me_dists_list_partial", partial=True)
    if len(iis):
        me_dists_list_partial.launches += 1
    return out


me_dists_list_partial.launches = 0


def me_pair_finish_ref(parts, use_matrix):
    """Plain twin of me_pair_finish."""
    den, dots = parts[0, 0], parts[0, 1]
    for r in range(1, parts.shape[0]):
        den = den + parts[r, 0]
        dots = dots + parts[r, 1]
    return torch.stack(kernels.finish_dist(dots, den, use_matrix))


def me_pair_finish(parts, use_matrix):
    """(dist, denom) of n pairs from k ranks' partial sums: parts [k, 2, n]
    float64 (each rank's den, then dots, in rank order); use_matrix: top =
    dots, else den - dots.  Returns [2, n] float64: dist, then denom."""
    if parts.device.type == "cpu":
        return me_pair_finish_ref(parts, use_matrix)
    if parts.device.type != "cuda":
        raise ValueError(f"me_pair_finish runs on CPU or CUDA tensors, not "
                         f"{parts.device}")
    if parts.dim() != 3 or parts.shape[1] != 2 or parts.shape[0] < 1 \
            or parts.dtype != ACCUM_DTYPE or not parts.is_contiguous():
        raise ValueError(f"me_pair_finish: parts must be contiguous float64 "
                         f"[k, 2, n], got {parts.dtype} {tuple(parts.shape)}")
    k, _, n = parts.shape
    out = torch.empty((2, n), dtype=ACCUM_DTYPE, device=parts.device)
    if n == 0:
        return out
    _raise_on(_build.library().vft_me_pair_finish_f64(
        parts.data_ptr(), k, n, int(bool(use_matrix)), out.data_ptr(),
        torch.cuda.current_stream(parts.device).cuda_stream),
        "me_pair_finish")
    me_pair_finish.launches += 1
    return out


me_pair_finish.launches = 0


def me_average_ref(codes, W, U, code_freq, eigentot, leaf_rows, targets, iis,
                   jjs, bw, tol):
    """Plain twin of me_average."""
    dev = codes.device
    k = len(targets)
    c, w, u = rows_cwu(codes, W, U, _index(np.concatenate([iis, jjs]), dev),
                       code_freq, leaf_rows)
    c, w, u, _ = kernels.average_profile(c[:k], w[:k], u[:k], c[k:], w[k:],
                                         u[k:], bw, code_freq, eigentot, tol)
    if k == 1:
        t = int(targets[0])
        codes[t], W[t - leaf_rows], U[t - leaf_rows] = c[0], w[0], u[0]
    else:
        t = _index(targets, dev)
        codes[t], W[t - leaf_rows], U[t - leaf_rows] = c, w, u


def me_average(codes, W, U, code_freq, eigentot, leaf_rows, targets, iis, jjs,
               bw, tol):
    """averageProfile (weight bw on the first row) of rows (iis[k], jjs[k])
    into row targets[k], in place, for every k at once: every row is read
    before any is written, so no target may be a source, and targets are
    distinct and at or above leaf_rows.  Row indices are host integer arrays;
    eigentot is [C] in matrix mode, None in %different mode.  An index
    outside the store, or a target below leaf_rows, raises IndexError."""
    targets = np.asarray(targets, dtype=np.int64)
    iis = np.asarray(iis, dtype=np.int64)
    jjs = np.asarray(jjs, dtype=np.int64)
    if len(targets) > 1 and (len(np.unique(targets)) != len(targets)
                             or np.isin(targets, [iis, jjs]).any()):
        raise ValueError("me_average: targets must be distinct and not "
                         "sources")
    if codes.device.type == "cpu":
        return me_average_ref(codes, W, U, code_freq, eigentot, leaf_rows,
                              targets, iis, jjs, bw, tol)
    n_rows, P, C = _check_store(codes, W, U, code_freq, leaf_rows)
    n = len(targets)
    if len(iis) != n or len(jjs) != n:
        raise ValueError("targets, iis and jjs differ in length")
    if n == 0:
        return
    et = None
    if eigentot is not None:
        et = eigentot.to(device=codes.device, dtype=torch.float32).contiguous()
    rows = np.concatenate([targets, iis, jjs]).astype(np.int32)
    lib = _build.library()
    _raise_on(lib.vft_me_average_f32(
        codes.data_ptr(), W.data_ptr(), U.data_ptr(), code_freq.data_ptr(),
        n_rows, int(leaf_rows), P, C, et.data_ptr() if et is not None else None,
        rows.ctypes.data, n, ctypes.c_float(bw), int(bw == 0.5),
        ctypes.c_float(tol), torch.cuda.current_stream(codes.device).cuda_stream),
        "me_average")
    me_average.launches += 1


me_average.launches = 0


# --------------------------------------------------------- whole-tree passes
class AverageTables(dataflow.LevelTables):
    """A dependency-ordered sweep of balanced (0.5) profile averages: per
    item, the target row and the source rows iis, jjs; and the items of
    earlier levels that write iis and jjs (prod_i, prod_j, -1 for none),
    which the kernel waits on.  Targets are distinct and no level reads a
    row that it or a later level writes (checked here), so the
    level-by-level order and the kernel's order of waits give the same
    rows."""

    fields = ("targets", "iis", "jjs")
    row_fields = fields

    def __init__(self, offsets, targets, iis, jjs):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.targets, self.iis, self.jjs = (np.asarray(a, dtype=np.int64)
                                            for a in (targets, iis, jjs))
        self.prod_i, self.prod_j = self.producers_of(
            "average sweep", self.targets, self.iis, self.jjs)
        self.n_items = len(self.targets)
        self._on = {}

    def kernel_arrays(self):
        return {"rows": np.concatenate([self.targets, self.iis, self.jjs,
                                        self.prod_i, self.prod_j])
                .astype(np.int32)}


def me_average_sweep_ref(codes, W, U, code_freq, eigentot, leaf_rows, tables,
                         tol):
    """Plain twin of me_average_sweep: me_average_ref level by level."""
    for t, i, j in tables.levels():
        me_average_ref(codes, W, U, code_freq, eigentot, leaf_rows, t, i, j,
                       0.5, tol)


def me_average_sweep(codes, W, U, code_freq, eigentot, leaf_rows, tables,
                     tol):
    """The balanced averages (weight 0.5) of an AverageTables, level after
    level, written into the store in place: one launch on CUDA, each row
    bit for bit me_average's level by level; the twin on the CPU.  A row
    outside the store, or a target below leaf_rows, raises IndexError
    before anything is launched."""
    if codes.device.type == "cpu":
        return me_average_sweep_ref(codes, W, U, code_freq, eigentot,
                                    leaf_rows, tables, tol)
    n_rows, P, C = _check_store(codes, W, U, code_freq, leaf_rows)
    tables.check_rows(n_rows, "me_average_sweep")
    if tables.n_items == 0:
        return
    if tables.targets.min() < leaf_rows:
        raise IndexError("me_average_sweep: a target among the code-only "
                         "leaves")
    et = None
    if eigentot is not None:
        et = eigentot.to(device=codes.device, dtype=torch.float32).contiguous()
    dev = tables.upload(codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    ws = dataflow.workspace(codes.device, stream)
    lib = _build.library()
    ctrl, n_flags = ws.flags(lib.vft_me_average_sweep_units(tables.n_items,
                                                            P))
    _raise_on(lib.vft_me_average_sweep_f32(
        codes.data_ptr(), W.data_ptr(), U.data_ptr(), code_freq.data_ptr(),
        int(leaf_rows), P, C, et.data_ptr() if et is not None else None,
        dev["rows"].data_ptr(), tables.n_items, ctypes.c_float(tol),
        ctrl.data_ptr(), n_flags, ws.next_epoch(), stream),
        "me_average_sweep")
    me_average_sweep.launches += 1


me_average_sweep.launches = 0


def me_dists_list_ref(codes, W, U, code_freq, eigenval, leaf_rows, iis,
                      jjs):
    """Plain twin of me_dists_list: me_dists_ref's pairs."""
    if len(iis) == 0:
        return torch.empty((2, 0), dtype=ACCUM_DTYPE, device=codes.device)
    return me_dists_ref(codes, W, U, code_freq, eigenval, leaf_rows, (),
                        None, None, iis, jjs)


def me_dists_list(codes, W, U, code_freq, eigenval, leaf_rows, iis, jjs):
    """The distances of the row pairs (iis[k], jjs[k]) of a list of any
    length (host integer arrays): one launch on CUDA over the list sent in
    one copy, each pair bit for bit what me_dists gives it; the twin on
    the CPU.  Returns [2, K] float64 on the store's device: dist, then
    denom.  An index outside the store raises IndexError before anything
    is launched."""
    iis = np.asarray(iis, dtype=np.int64)
    jjs = np.asarray(jjs, dtype=np.int64)
    if len(iis) != len(jjs):
        raise ValueError("iis and jjs differ in length")
    if codes.device.type == "cpu":
        return me_dists_list_ref(codes, W, U, code_freq, eigenval, leaf_rows,
                                 iis, jjs)
    out = _pair_list(codes, W, U, code_freq, eigenval, leaf_rows, iis, jjs,
                     "me_dists_list")
    if len(iis):
        me_dists_list.launches += 1
    return out


def _pair_list(codes, W, U, code_freq, eigenval, leaf_rows, iis, jjs, name,
               partial=False):
    """The launch of me_dists_list (or, partial, me_dists_list_partial) on
    CUDA."""
    n_rows, P, C = _check_store(codes, W, U, code_freq, leaf_rows)
    K = len(iis)
    rows = np.concatenate([iis, jjs])
    if K and (rows.min() < 0 or rows.max() >= n_rows):
        raise IndexError(f"{name}: a row index lies outside the store")
    dev = codes.device
    out = torch.empty((2, K), dtype=ACCUM_DTYPE, device=dev)
    if K == 0:
        return out
    ev = None
    if eigenval is not None:
        ev = eigenval.to(device=dev, dtype=ACCUM_DTYPE).contiguous()
    rows = dataflow.to_device({"rows": rows.astype(np.int32)}, dev)["rows"]
    _raise_on(_build.library().vft_me_pair_list_partial_f32(
        codes.data_ptr(), W.data_ptr(), U.data_ptr(), code_freq.data_ptr(),
        int(leaf_rows), P, C, ev.data_ptr() if ev is not None else None,
        rows.data_ptr(), K, int(partial), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), name)
    return out


me_dists_list.launches = 0


def fma_f32(a, b, c):
    """a * b + c of float32 tensors, rounded once to float32 (a fused
    multiply-add).  The product is exact in float64 and TwoSum gives the
    float64 sum's error, which decides the sums that land on a midpoint
    between two floats (where rounding twice would go astray)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    f = s.float()
    up = torch.nextafter(f, torch.full_like(f, math.inf))
    dn = torch.nextafter(f, torch.full_like(f, -math.inf))
    fd = f.double()
    f = torch.where((s == (fd + up.double()) * 0.5) & (err > 0), up, f)
    return torch.where((s == (fd + dn.double()) * 0.5) & (err < 0), dn, f)


def me_dist_pieces_list_ref(codes, W, U, code_freq, eigenval, leaf_rows,
                            n_pos, iis, jjs):
    """Plain twin of me_dist_pieces_list, each operation in the kernel's
    order (csrc/me_store.cuh pieces_pos)."""
    dev = codes.device
    _, W1, U1 = rows_cwu(codes, W, U, _index(iis, dev), code_freq, leaf_rows)
    _, W2, U2 = rows_cwu(codes, W, U, _index(jjs, dev), code_freq, leaf_rows)
    W1, W2, U1, U2 = W1[:, :n_pos], W2[:, :n_pos], U1[:, :n_pos], \
        U2[:, :n_pos]
    # a float64 store (-double-precision, CPU only) takes plain operations
    fma = fma_f32 if U.dtype == torch.float32 else \
        (lambda a, b, c: a * b + c)
    if eigenval is not None:
        U1 = U1 * eigenval.to(U.dtype)
    dot = U1[..., 0] * U2[..., 0]
    for c in range(1, U1.shape[-1]):
        dot = dot + U1[..., c] * U2[..., c] if c < 8 else \
            fma(U1[..., c], U2[..., c], dot)
    weights = W1 * W2
    if eigenval is not None:
        pieces = dot
    else:
        pieces = weights - dot if leaf_rows else fma(W1, W2, -dot)
    return pieces.contiguous(), weights.contiguous()


def me_dist_pieces_list(codes, W, U, code_freq, eigenval, leaf_rows, n_pos,
                        iis, jjs):
    """The local bootstrap's pieces and weights of the row pairs (iis[k],
    jjs[k]) of a list of any length (host integer arrays) at positions
    [0, n_pos): weight = W_i * W_j and piece = weight - U_i . U_j, or in
    matrix mode (eigenval [C]) U_i . U_j weighted by eigenval, per
    position in float32.  One launch on CUDA over the list sent in one
    copy; the twin on the CPU.  Returns (pieces, weights), float32 [K,
    n_pos] each on the store's device.  An index outside the store raises
    IndexError before anything is launched."""
    iis = np.asarray(iis, dtype=np.int64)
    jjs = np.asarray(jjs, dtype=np.int64)
    if len(iis) != len(jjs):
        raise ValueError("iis and jjs differ in length")
    K = len(iis)
    if codes.device.type == "cpu":
        return me_dist_pieces_list_ref(codes, W, U, code_freq, eigenval,
                                       leaf_rows, n_pos, iis, jjs)
    n_rows, P, C = _check_store(codes, W, U, code_freq, leaf_rows)
    if not 0 < n_pos <= P:
        raise ValueError(f"me_dist_pieces_list: n_pos {n_pos} outside "
                         f"(0, {P}]")
    rows = np.concatenate([iis, jjs])
    if K and (rows.min() < 0 or rows.max() >= n_rows):
        raise IndexError("me_dist_pieces_list: a row index lies outside the "
                         "store")
    dev = codes.device
    pieces = torch.empty((K, n_pos), dtype=torch.float32, device=dev)
    weights = torch.empty((K, n_pos), dtype=torch.float32, device=dev)
    if K == 0:
        return pieces, weights
    ev = None
    if eigenval is not None:
        ev = eigenval.to(device=dev, dtype=torch.float32).contiguous()
    rows = dataflow.to_device({"rows": rows.astype(np.int32)}, dev)["rows"]
    _raise_on(_build.library().vft_me_pieces_list_f32(
        codes.data_ptr(), W.data_ptr(), U.data_ptr(), code_freq.data_ptr(),
        int(leaf_rows), P, int(n_pos), C,
        ev.data_ptr() if ev is not None else None, rows.data_ptr(), K,
        pieces.data_ptr(), weights.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "me_dist_pieces_list")
    me_dist_pieces_list.launches += 1
    return pieces, weights


me_dist_pieces_list.launches = 0
