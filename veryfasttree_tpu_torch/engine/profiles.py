"""Minimum-evolution profile store on one torch device (counterpart of
``veryfasttree_tpu/engine/profiles.py``).

The store keeps the reference's layout, so row indices and return shapes
mean the same in both packages:

    codes   int8 [n_rows, p_pad]      NOCODE marks stored-vector / gap positions
    W       f32  [n_float, p_pad]     non-gap weights
    U       f32  [n_float, p_pad, C]  weight * rotated frequency vector

with n_rows = roundup(2*maxnodes, 256) and p_pad = roundup(P,
position_align).  Rows [0, maxnodes) hold node profiles, [maxnodes,
2*maxnodes) up-profile slots.  In two-tier mode leaves exist only as codes;
W and U cover the rows >= n_seqs (physical index = row - n_seqs).

The host loop passes numpy index arrays and receives numpy float64 arrays;
distance contractions accumulate in float64 (utils/device.py).  Profile
writes update W, U and codes in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import NOCODE

from ..ops import kernels, scan_kernels, store_kernels
from ..utils.device import ACCUM_DTYPE

_ACC = ACCUM_DTYPE


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


# what a store may take of one H100's 80 GB (79.1 GiB as torch sees it),
# leaving the rest for the run's other tensors and the CUDA context
CARD_STORE_BYTES = 75 * 2**30


def hbm_plan(n_seqs: int, n_pos: int, n_codes: int = 4,
             double_precision: bool = False, two_tier: bool | None = None,
             n_sp: int = 1, position_align: int = 128,
             tile_m: int = scan_kernels.TILE_M) -> dict:
    """Device-memory budget of the ME store for (N, P, C, sp) (the JAX
    package's hbm_plan, veryfasttree_tpu/engine/profiles.py:483-522, the
    fit formula in place of the reference's DiskMemory spill planning).

    Rows: n_rows = 4N (node and up-profile slots); two-tier leaves live as
    int8 codes only, the float rows cover the rest.  Position sharding over
    sp ranks gives each rank a block of p_pad / sp positions (rounded up to
    parallel.mesh.BLOCK_ALIGN), so per_device_bytes, the bytes of one
    rank's store (ShardedMEProfiles), is total_bytes / sp where sp divides
    p_pad / 16; fits_h100 says whether that fits one 80 GB card
    (CARD_STORE_BYTES).  At N = 1,000,000, P = 1,300, nucleotide, float32,
    two-tier: total 90.1 GB, which no one card holds; 45.1 GB a card at
    sp = 2, 22.5 GB at sp = 4."""
    from ..parallel.mesh import block_width

    if two_tier is None:
        two_tier = n_seqs >= 20000
    esz = 8 if double_precision else 4
    p_pad = ((n_pos + position_align - 1) // position_align) * position_align
    width = block_width(p_pad, n_sp)
    maxnodes = 2 * n_seqs
    n_rows = ((2 * maxnodes + tile_m - 1) // tile_m) * tile_m
    n_float = n_rows
    if two_tier:
        n_float = ((n_rows - n_seqs + tile_m - 1) // tile_m) * tile_m

    def store_bytes(p):
        return (n_rows * p + n_float * p * esz * (1 + n_codes)
                + p * (n_codes + 1) * esz)

    total = store_bytes(p_pad)
    per_device = store_bytes(width)
    return {
        "n_rows": n_rows, "p_pad": p_pad, "two_tier": two_tier,
        "codes_bytes": n_rows * p_pad, "w_bytes": n_float * p_pad * esz,
        "u_bytes": n_float * p_pad * n_codes * esz, "total_bytes": total,
        "block_positions": width,
        "per_device_bytes": per_device,
        "fits_h100": per_device < CARD_STORE_BYTES,
    }


class MEProfiles:
    _LEAF_CHUNK = 4096   # leaf rows expanded at once by the out-profile sum

    def __init__(self, leaf_codes: np.ndarray, options, dmat, maxnodes: int,
                 two_tier: bool | None = None, device=torch.device("cpu")):
        n_seqs, n_pos = leaf_codes.shape
        self._setup(options, dmat, n_seqs, n_pos, maxnodes, two_tier, device)
        codes = np.full((self.n_rows, self.p_pad), NOCODE, dtype=np.int8)
        codes[:n_seqs, :n_pos] = leaf_codes
        n_float = self._n_float_rows()
        W = np.zeros((n_float, self.p_pad), dtype=self.dtype)
        U = np.zeros((n_float, self.p_pad, self.n_codes), dtype=self.dtype)
        if not self.two_tier:
            present = leaf_codes != NOCODE
            W[:n_seqs, :n_pos] = present
            safe = np.where(present, leaf_codes, 0).astype(np.int64)
            U[:n_seqs, :n_pos] = _np(self.code_freq)[safe] * present[..., None]
        self._put(codes, W, U)
        self.n_gaps = (leaf_codes == NOCODE).sum(axis=1).astype(np.int64)
        self.w_out = None
        self.f_out = None

    @classmethod
    def from_numpy(cls, arrays: dict, options, dmat, n_seqs: int, n_pos: int,
                   maxnodes: int, two_tier: bool | None = None,
                   device=torch.device("cpu")):
        """A store holding given arrays, under the names the reference's
        checkpoints use: me_codes, me_W, me_U, me_w_out, me_f_out."""
        self = cls.__new__(cls)
        self._setup(options, dmat, n_seqs, n_pos, maxnodes, two_tier, device)
        codes = np.asarray(arrays["me_codes"])
        if codes.shape != (self.n_rows, self.p_pad) or \
                arrays["me_W"].shape[0] != self._n_float_rows():
            raise ValueError("arrays do not match the store layout of "
                             f"n_seqs={n_seqs}, n_pos={n_pos}")
        self._put(codes, arrays["me_W"], arrays["me_U"])
        self.n_gaps = (codes[:n_seqs, :n_pos] == NOCODE).sum(axis=1) \
            .astype(np.int64)
        self.w_out = self._tensor(arrays["me_w_out"])
        self.f_out = self._tensor(arrays["me_f_out"])
        return self

    def _setup(self, options, dmat, n_seqs, n_pos, maxnodes, two_tier,
               device) -> None:
        self.options = options
        self.device = torch.device(device)
        self.n_seqs = n_seqs
        self.n_pos = n_pos
        self.p_pad = self._p_pad(n_pos, options.position_align)
        self.n_codes = options.n_codes
        self.use_matrix = dmat is not None
        self.dmat = dmat
        self.dtype = np.float64 if options.double_precision else np.float32
        self.tdtype = torch.float64 if options.double_precision \
            else torch.float32
        self.tol = float(options.f_post_total_tolerance)
        if two_tier is None:
            tt_min = getattr(options, "two_tier_min", 20000)
            two_tier = tt_min >= 0 and n_seqs >= tt_min
        self.two_tier = bool(two_tier)
        if self.use_matrix:
            self.code_freq = self._tensor(dmat.code_freq)
            self.eigenval = self._tensor(dmat.eigenval)
            self.eigentot = self._tensor(dmat.eigentot)
        else:
            self.code_freq = self._tensor(np.eye(self.n_codes))
            self.eigenval = self._tensor(np.zeros(self.n_codes))
            self.eigentot = self._tensor(np.ones(self.n_codes))
        self.maxnodes = maxnodes
        tm = scan_kernels.TILE_M
        self.n_rows = ((2 * maxnodes + tm - 1) // tm) * tm
        # moves whenever the out-profile does (the host's cache of raw
        # out-profile distances, NeighbourJoining.cache_out_raw, holds for
        # one version)
        self.out_version = 0

    @staticmethod
    def _p_pad(n_pos: int, align: int) -> int:
        return ((n_pos + align - 1) // align) * align

    def _n_float_rows(self) -> int:
        if not self.two_tier:
            return self.n_rows
        # two-tier float rows stay TILE_M-aligned, as in the reference
        tm = scan_kernels.TILE_M
        return ((self.n_rows - self.n_seqs + tm - 1) // tm) * tm

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=self.device,
                               dtype=dtype or self.tdtype)

    def _put(self, codes, W, U) -> None:
        self.codes = torch.as_tensor(np.asarray(codes, dtype=np.int8),
                                     device=self.device)
        self.W = self._tensor(W)
        self.U = self._tensor(U)

    def _idx(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, dtype=np.int64),
                               device=self.device)

    @property
    def _ev(self):
        return self.eigenval if self.use_matrix else None

    @property
    def _et(self):
        return self.eigentot if self.use_matrix else None

    def up_row(self, node: int) -> int:
        """Row index of a node's up-profile slot."""
        return self.maxnodes + node

    # -- row access ----------------------------------------------------------
    @property
    def _leaf_rows(self) -> int:
        """Rows below this exist only as codes (the two-tier leaves)."""
        return self.n_seqs if self.two_tier else 0

    def _rows_cwu(self, rows):
        """(codes, W, U) of arbitrary rows; two-tier leaves are expanded from
        their codes."""
        return store_kernels.rows_cwu(self.codes, self.W, self.U, rows,
                                      self.code_freq, self._leaf_rows)

    def row_query(self, i: int):
        """(u, w) of a single row (expanding leaves on the fly)."""
        _, w, u = self._rows_cwu(self._idx([i]))
        return u[0], w[0]

    def out_query(self):
        """Out-profile as a (u, w) query for distance scans."""
        return self.w_out[:, None] * self.f_out, self.w_out

    # -- out-profile ---------------------------------------------------------
    def recompute_outprofile(self, active_mask: np.ndarray) -> None:
        self.out_version += 1
        full = np.zeros(max(self.n_rows, self.n_seqs + self.U.shape[0]),
                        dtype=bool)
        full[: len(active_mask)] = active_mask
        if not self.two_tier:
            self.w_out, self.f_out = kernels.out_profile(
                self.U, self.W,
                torch.as_tensor(full[: self.U.shape[0]], device=self.device),
                self.code_freq, self._et, self.tol)
            return
        # internal rows, then the leaves expanded from their codes in chunks
        n_int = self.U.shape[0]
        int_mask = torch.as_tensor(full[self.n_seqs: self.n_seqs + n_int],
                                   device=self.device)
        accum = self.U[int_mask].sum(0)
        w_sum = self.W[int_mask].sum(0)
        leaves = np.nonzero(full[: self.n_seqs])[0]
        n = len(leaves) + int(int_mask.sum())
        for start in range(0, len(leaves), self._LEAF_CHUNK):
            rows = self._idx(leaves[start: start + self._LEAF_CHUNK])
            u_l, w_l = kernels.leaf_u(self.codes[rows], self.code_freq,
                                      self.U.dtype)
            accum = accum + u_l.sum(0)
            w_sum = w_sum + w_l.sum(0)
        self.w_out = torch.clamp_min(w_sum / max(n, 1), 1e-20)
        self.f_out = kernels.normalize_freq(
            accum, self._et,
            kernels._fallback(self.code_freq, self._et, self.U.dtype),
            self.tol)

    def update_outprofile(self, i: int, j: int, newnode: int,
                          n_active_old: int) -> None:
        self.out_version += 1
        _, wg, ug = self._rows_cwu(self._idx([i, j, newnode]))
        self.w_out, self.f_out = kernels.update_out_profile(
            self.w_out, self.f_out, ug[0], wg[0], ug[1], wg[1], ug[2], wg[2],
            n_active_old, self.code_freq, self._et, self.tol)

    # -- distance scans ------------------------------------------------------
    def dist_one_vs_all(self, i: int):
        """Row i against every row -> (dist, denom) numpy arrays, through the
        fused scan kernels."""
        uq, wq = self.row_query(i)
        n_out = (self.n_seqs if self.two_tier else 0) + self.U.shape[0]
        outd = torch.zeros(n_out, dtype=_ACC, device=self.device)
        if self.two_tier:
            _, _, d, w, _ = scan_kernels.nj_scan_two_tier(
                self.codes, self.W, self.U, uq, wq, outd, 3, self.n_seqs,
                self._ev, self.code_freq)
        else:
            _, _, d, w, _ = scan_kernels.nj_scan(self.U, self.W, uq, wq, outd,
                                                 3, self._ev)
        return _np(d), _np(w)

    def _dots_many_vs_leaves(self, rows):
        """K query rows vs all leaves -> the distances' sums (dots, denom),
        tensors [K, n_seqs]."""
        _, wq, uq = self._rows_cwu(rows)
        uq, wq = uq.to(_ACC), wq.to(_ACC)
        ev = self._ev.to(_ACC) if self.use_matrix else None
        if self.two_tier:
            leaves = self.codes[: self.n_seqs]
            cf = self.code_freq.to(_ACC)
            pairs = [kernels.me_dots_many_codes(leaves, u, w, ev, cf, _ACC)
                     for u, w in zip(uq, wq)]
            return (torch.stack([p[0] for p in pairs]),
                    torch.stack([p[1] for p in pairs]))
        K = uq.shape[0]
        Wl = self.W[: self.n_seqs].to(_ACC)
        Ul = self.U[: self.n_seqs].to(_ACC).reshape(self.n_seqs, -1)
        denom = wq @ Wl.T
        if ev is not None:
            return (uq * ev[None, None, :]).reshape(K, -1) @ Ul.T, denom
        return uq.reshape(K, -1) @ Ul.T, denom

    def _dist_many_vs_leaves(self, rows):
        """K query rows vs all leaves -> (dist, denom) tensors [K, n_seqs]."""
        return kernels.finish_dist(*self._dots_many_vs_leaves(rows),
                                   self.use_matrix)

    def dist_many_vs_leaves(self, rows: np.ndarray):
        """Wave seed scan: [K] query rows vs all leaves -> (dist, weight)
        numpy arrays of shape [K, n_seqs]."""
        d, w = self._dist_many_vs_leaves(self._idx(rows))
        return _np(d), _np(w)

    def dist_leaves_topk(self, rows: np.ndarray, od: np.ndarray, k: int):
        """Wave seed scan with the best k leaves per seed by NJ criterion,
        ties to the lowest index.  Valid while every leaf out-distance is
        fresh at n_active == n_seqs (the caller checks).  Returns (idx [K,k] int64, dist [K,k], weight [K,k])."""
        rows_t = self._idx(rows)
        dist, denom = self._dist_many_vs_leaves(rows_t)
        odc = torch.as_tensor(np.asarray(od, dtype=np.float64),
                              device=self.device)
        crit = dist - (odc[rows_t][:, None] + odc[None, :]) / (self.n_seqs - 2)
        idx = torch.sort(crit, dim=1, stable=True).indices[:, :k]
        return (_np(idx), _np(torch.gather(dist, 1, idx)),
                _np(torch.gather(denom, 1, idx)))

    def _dists(self, q_rows=(), query=None, iis=(), jjs=()):
        """The query (u, w) against q_rows, then the pairs (iis, jjs), in one
        store call and one fetch -> (dist, denom) numpy arrays."""
        qU, qW = query if query is not None else (None, None)
        out = _np(store_kernels.me_dists(
            self.codes, self.W, self.U, self.code_freq, self._ev,
            self._leaf_rows, q_rows, qU, qW, iis, jjs))
        return out[0], out[1]

    def dist_one_vs_set(self, i: int, js: np.ndarray):
        return self._dists(js, self.row_query(i))

    def dist_set_vs_out(self, idx: np.ndarray):
        """profileDist(node, outprofile) for a set of nodes -> (dist, weight)."""
        return self._dists(idx, self.out_query())

    def dist_pairs(self, iis: np.ndarray, jjs: np.ndarray):
        return self._dists(iis=iis, jjs=jjs)

    def dist_pair_list(self, iis: np.ndarray, jjs: np.ndarray):
        """dist_pairs of a whole-tree list: one launch of the list kernel
        and one fetch -> (dist, denom) numpy arrays, each pair's value
        dist_pairs' bit for bit."""
        out = _np(store_kernels.me_dists_list(
            self.codes, self.W, self.U, self.code_freq, self._ev,
            self._leaf_rows, iis, jjs))
        return out[0], out[1]

    def dist_pieces_list(self, iis: np.ndarray, jjs: np.ndarray):
        """The local bootstrap's per-position pieces and weights of the row
        pairs (iis[k], jjs[k]) at the alignment's positions: one launch of
        store_kernels.me_dist_pieces_list.  Returns (pieces, weights),
        float32 [K, n_pos] tensors on the store's device, not fetched."""
        return store_kernels.me_dist_pieces_list(
            self.codes, self.W, self.U, self.code_freq, self._ev,
            self._leaf_rows, self.n_pos, iis, jjs)

    def refresh_and_pairs(self, rrows: np.ndarray, iis: np.ndarray,
                          jjs: np.ndarray):
        """Out-profile distances of `rrows` plus pair distances of (iis,
        jjs).  Returns (d_out, w_out_, d_pair, w_pair)."""
        d, w = self._dists(rrows, self.out_query(), iis, jjs)
        r = len(rrows)
        return d[:r], w[:r], d[r:], w[r:]

    # -- profile construction ------------------------------------------------
    def _average_into(self, targets, iis, jjs, bw) -> None:
        """averageProfile of rows (iis, jjs) into rows `targets` (all read
        before any is written)."""
        store_kernels.me_average(self.codes, self.W, self.U, self.code_freq,
                                 self._et, self._leaf_rows, targets, iis, jjs,
                                 bw, self.tol)

    def join(self, i: int, j: int, newnode: int, bionj_weight: float):
        """averageProfile into newnode; returns (selfdist, selfweight)."""
        self.set_from_average(newnode, i, j, bionj_weight)
        # self-distance with double accumulation (ref profileDist)
        d, wt = self.dist_pairs([newnode], [newnode])
        return float(d[0]), float(wt[0])

    def set_from_average(self, node: int, i: int, j: int,
                         bionj_weight: float) -> None:
        bw = 0.5 if bionj_weight < 0 else bionj_weight
        assert node >= self.n_seqs
        self._average_into([node], [i], [j], bw)

    def average_sweep(self, levels) -> None:
        """Balanced-average level sweep: `levels` is a dependency-ordered
        list of (targets, iis, jjs); level k+1 reads rows level k wrote."""
        self.sweep_averages(store_kernels.AverageTables.from_levels(levels))

    def sweep_averages(self, tables) -> None:
        """The sweep of an AverageTables: one launch
        (store_kernels.me_average_sweep), each row what the per-level
        averages write."""
        store_kernels.me_average_sweep(
            self.codes, self.W, self.U, self.code_freq, self._et,
            self._leaf_rows, tables, self.tol)


class ShardedMEProfiles(MEProfiles):
    """The store of one rank of a mesh (parallel/mesh.py): the same layout
    over the rank's block of positions (Mesh.block: contiguous, p_pad / sp
    wide, padded with NOCODE and W = 0), every row present.

    Averages, the out-profile and leaf expansion are local to each
    position and run unchanged on the block.  Every distance is a sum over
    positions: the rank's float64 partial (the partial kernels, or the
    twins' sums), the exchange along sp (every rank ends with every rank's
    partial), then the finish on the sums added in rank order
    (me_pair_finish, nj_scan_finish, or the seed waves' finish_dist).
    Every rank gets the same bits, and the host loops above the store run
    as on one card.  n_pos stays the alignment's; n_local and lo are the
    block's real positions and the first of them.  The local bootstrap's
    pieces are the block's (engine/supports.LocalBootstrap exchanges their
    sums)."""

    def __init__(self, leaf_codes: np.ndarray, options, dmat, maxnodes: int,
                 two_tier: bool | None = None, device=torch.device("cpu")):
        self.mesh = options.mesh
        n_seqs, n_pos = leaf_codes.shape
        self.lo, width, self.n_local = self.mesh.block(
            n_pos, options.position_align)
        block = np.full((n_seqs, width), NOCODE, dtype=np.int8)
        block[:, : self.n_local] = \
            leaf_codes[:, self.lo: self.lo + self.n_local]
        super().__init__(block, options, dmat, maxnodes, two_tier, device)
        self.n_pos = n_pos
        self.n_gaps = (leaf_codes == NOCODE).sum(axis=1).astype(np.int64)

    @staticmethod
    def _p_pad(n_pos: int, align: int) -> int:
        return n_pos      # the block's width, aligned by Mesh.block

    @classmethod
    def from_numpy(cls, *args, **kwargs):
        raise NotImplementedError(
            "-checkpoint under a mesh is not ported yet (ROADMAP Queue 1, "
            "the multi-GPU slices: -threads, -constraints, -makematrix and "
            "-checkpoint under a mesh)")

    def _finish_pairs(self, part):
        return _np(store_kernels.me_pair_finish(self.mesh.exchange(part),
                                                self.use_matrix))

    def dist_one_vs_all(self, i: int):
        """Row i against every row: the partial scans of the block, one
        exchange, nj_scan_finish."""
        uq, wq = self.row_query(i)
        n_out = (self.n_seqs if self.two_tier else 0) + self.U.shape[0]
        outd = torch.zeros(n_out, dtype=_ACC, device=self.device)
        if self.two_tier:
            _, _, d, w, _ = scan_kernels.nj_scan_two_tier(
                self.codes, self.W, self.U, uq, wq, outd, 3, self.n_seqs,
                self._ev, self.code_freq, exchange=self.mesh.exchange)
        else:
            _, _, d, w, _ = scan_kernels.nj_scan(
                self.U, self.W, uq, wq, outd, 3, self._ev,
                exchange=self.mesh.exchange)
        return _np(d), _np(w)

    def _dist_many_vs_leaves(self, rows):
        dots, denom = self.mesh.exchange_sum(
            torch.stack(self._dots_many_vs_leaves(rows)))
        return kernels.finish_dist(dots, denom, self.use_matrix)

    def _dists(self, q_rows=(), query=None, iis=(), jjs=()):
        qU, qW = query if query is not None else (None, None)
        out = self._finish_pairs(store_kernels.me_dists_partial(
            self.codes, self.W, self.U, self.code_freq, self._ev,
            self._leaf_rows, q_rows, qU, qW, iis, jjs))
        return out[0], out[1]

    def dist_pair_list(self, iis: np.ndarray, jjs: np.ndarray):
        out = self._finish_pairs(store_kernels.me_dists_list_partial(
            self.codes, self.W, self.U, self.code_freq, self._ev,
            self._leaf_rows, iis, jjs))
        return out[0], out[1]

    def dist_pieces_list(self, iis: np.ndarray, jjs: np.ndarray):
        """The pieces and weights at the block's n_local real positions
        (float32 [K, n_local] each, not fetched)."""
        if self.n_local == 0:
            empty = torch.empty((len(iis), 0), dtype=torch.float32,
                                device=self.device)
            return empty, empty.clone()
        return store_kernels.me_dist_pieces_list(
            self.codes, self.W, self.U, self.code_freq, self._ev,
            self._leaf_rows, self.n_local, iis, jjs)


def make_store(leaf_codes: np.ndarray, options, dmat, maxnodes: int,
               device=torch.device("cpu")):
    """The engine's ME store: a rank's ShardedMEProfiles under a mesh
    (options.mesh), else MEProfiles."""
    cls = ShardedMEProfiles if getattr(options, "mesh", None) is not None \
        else MEProfiles
    return cls(leaf_codes, options, dmat, maxnodes, device=device)
