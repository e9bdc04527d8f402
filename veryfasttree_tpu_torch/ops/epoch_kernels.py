"""The NJ join phase on the card: the CUDA kernel of ``csrc/nj_epoch.cu``
and its plain twin.

The host join loop (``engine/nj.py`` ``NeighbourJoining._join_loop_host``)
makes a store call with a blocking fetch for every step of every join, some
fourteen thousand at N=2000.  One launch of the kernel runs the joins from
one out-profile reset to the next (``engine/epoch.reset_plan``): it stops
the reset join just before its out-profile step, the host recomputes the
out-profile from the active rows as the host loop does
(``MEProfiles.recompute_outprofile``), and the next launch carries on.  A
join phase at N=2000 takes about a dozen launches, each ending in one small
fetch.

The twin is the host loop itself: ``join_epoch`` runs it for a store on the
CPU and launches the kernel, or raises, for a store on a CUDA device.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..engine.epoch import reset_plan
from . import _build, me_round
from .scan_kernels import codes_table_len
from .store_kernels import _check_store

# the kernel's int64 words, in its order (csrc/nj_epoch.cuh)
WORDS = ("outprofile_ops", "profile_ops", "seq_ops", "profile_avg_ops",
         "n_hill_better", "n_visible_update", "n_refresh_tophits", "scans",
         "scan_rows", "phases", "fault", "fault_at", "maxnode", "tv_age", "joins")
COUNTERS = WORDS[:7]                 # the nj.debug counters among them
FAULTS = {1: "a hit list without a valid entry, or no search candidate",
          2: "an active node without a hit list",
          3: "no visible entry to rebuild the top-visible set from",
          4: "a phase larger than the scratch",
          5: "a join or hill-climb node already joined"}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double


class EpochParams(ctypes.Structure):
    """The kernel's parameters, field for field csrc/nj_epoch.cuh
    EpochParams (every field 8 bytes)."""
    _fields_ = (
        [(n, _P) for n in ("codes", "W", "U", "code_freq", "ev", "et", "w_out",
                           "f_out", "qU", "qa", "qw", "qg")]
        + [(n, _I) for n in ("n_rows", "leaf_rows", "P", "C", "use_matrix")]
        + [("tol", _D)]
        + [(n, _P) for n in ("od", "noda", "selfdist", "selfweight", "diam",
                             "vard", "bl", "parent", "kids", "hits_j",
                             "hits_d", "age", "vis_j", "vis_d", "tv",
                             "join_i", "join_j", "totdiam", "words", "pa",
                             "pb", "rd", "rw", "li", "lj", "ld", "lc",
                             "iscr", "dscr", "mark", "mark2", "partner",
                             "cmd", "ctl")]
        + [(n, _I) for n in ("cap", "n_seqs", "M", "m", "ntv", "bionj")]
        + [("stale_limit", _D)]
        + [(n, _I) for n in ("refresh_thresh", "age_limit", "n_hi", "n_lo",
                             "resume", "stop_reset", "smem_state",
                             "smem_lists")])


class ConParams(ctypes.Structure):
    """The constrained kernel's second parameter, field for field
    csrc/nj_epoch.cuh EpochCons (every field 8 bytes)."""
    _fields_ = ([(n, _P) for n in ("on", "off", "out_on", "out_off")]
                + [("n_cons", _I), ("weight", _D)])


def segments(n_seqs: int, options, max_joins=None):
    """The launches of a join phase: (n_hi, n_lo, resume, stop_reset) each,
    the joins at n_active = n_hi down to n_lo; resume: first finish the
    reset join at n_hi + 1; stop_reset: the join at n_lo resets the
    out-profile and ends the launch before that step."""
    last = 4 if max_joins is None else max(4, n_seqs - max_joins + 1)
    if last > n_seqs:
        return []
    out = []
    hi, resume = n_seqs, False
    for r in reset_plan(n_seqs, options, max_joins):
        out.append((hi, r, resume, True))
        hi, resume = r - 1, True
    if hi >= last or resume:
        out.append((hi, last, resume, False))
    return out


class EpochState:
    """The join phase's state on the store's device, built from the host
    engine and top-hits state (the layout of the JAX package's EpochState,
    veryfasttree_tpu/engine/epoch.py:61-104); new profile rows go straight
    into the store."""

    def __init__(self, nj, tophits, state_in_smem=True, lists_in_smem=True):
        prof, tree, opts = nj.prof, nj.tree, nj.options
        dev = self.dev = prof.codes.device
        n_rows, P, C = _check_store(prof.codes, prof.W, prof.U,
                                    prof.code_freq, prof._leaf_rows)
        M, m = nj.maxnodes, tophits.m
        ntv = len(tophits.topvisible)
        if (tophits.hit_source >= 0).any():
            raise ValueError("nj_join_epoch: second-level top hits are not "
                             "taken (epoch_supported)")

        def f64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

        def i32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

        def i64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        t = self.t = {}
        t["od"], t["selfdist"] = f64(nj.out_distances), f64(nj.selfdist)
        t["selfweight"], t["diam"] = f64(nj.selfweight), f64(nj.diameter)
        t["vard"], t["bl"] = f64(nj.var_diameter), f64(tree.branchlength)
        t["noda"], t["age"] = i64(nj.n_out_dist_active), i64(tophits.age)
        t["parent"], t["kids"] = i32(tree.parent), i32(tree.children[:, :2])
        hj, hd = tophits.pack_state()
        t["hits_j"], t["hits_d"] = i32(hj), f64(hd)
        t["vis_j"], t["vis_d"] = i32(tophits.visible_j), f64(tophits.visible_dist)
        t["tv"] = i32(tophits.topvisible)
        n_joins = max(nj.n_seqs - 3, 1)
        t["join_i"], t["join_j"] = i32(np.full(n_joins, -1)), i32(np.full(n_joins, -1))
        t["totdiam"] = f64([nj.totdiam])
        words = np.zeros(len(WORDS), dtype=np.int64)
        words[WORDS.index("maxnode")] = tree.maxnode
        words[WORDS.index("tv_age")] = tophits.topvisible_age
        t["words"] = i64(words)
        cap = self.cap = 2 * M + 3 * m * (2 * m + 2) + 64
        for name in ("pa", "pb", "li", "lj"):
            t[name] = torch.empty(cap, dtype=torch.int32, device=dev)
        for name in ("rd", "rw", "ld", "lc"):
            t[name] = torch.empty(cap, dtype=torch.float64, device=dev)
        lens = (ctypes.c_int64 * 2)()
        lib = _build.library()
        lib.vft_nj_epoch_scratch(M, m, ntv, lens)
        t["iscr"] = torch.empty(lens[0], dtype=torch.int32, device=dev)
        t["dscr"] = torch.empty(lens[1], dtype=torch.float64, device=dev)
        for name in ("mark", "mark2", "partner"):
            t[name] = torch.zeros(M, dtype=torch.int32, device=dev)
        t["cmd"] = torch.zeros(8, dtype=torch.int64, device=dev)
        t["ctl"] = torch.zeros(2, dtype=torch.int32, device=dev)
        t["qU"] = torch.empty(P * C, dtype=torch.float32, device=dev)
        t["qa"] = torch.empty(P * C, dtype=torch.float64, device=dev)
        t["qw"] = torch.empty(P, dtype=torch.float64, device=dev)
        # the query's projection and weights in the code scan's layout
        # (csrc/nj_scan.cuh codes_table_len)
        t["qg"] = torch.empty((C + 1) * codes_table_len(P, C),
                              dtype=torch.float64, device=dev)
        self.ev = self.et = None
        if prof.use_matrix:
            self.ev = prof.eigenval.to(dtype=torch.float64).contiguous()
            self.et = prof.eigentot.to(dtype=torch.float32).contiguous()
        # the constraint counts, int32 in device memory (beside the
        # kernel's shared-memory layouts); none without constraints
        self.cons = None
        if nj.n_cons:
            t["con_on"], t["con_off"] = i32(nj.con_on), i32(nj.con_off)
            t["con_out_on"] = i32(nj.con_out_on)
            t["con_out_off"] = i32(nj.con_out_off)
            self.cons = ConParams(
                on=t["con_on"].data_ptr(), off=t["con_off"].data_ptr(),
                out_on=t["con_out_on"].data_ptr(),
                out_off=t["con_out_off"].data_ptr(), n_cons=nj.n_cons,
                weight=float(opts.constraint_weight))
        self.params = EpochParams(
            n_rows=n_rows, leaf_rows=int(prof._leaf_rows), P=P, C=C,
            use_matrix=int(prof.use_matrix), tol=float(np.float32(prof.tol)),
            cap=cap, n_seqs=nj.n_seqs, M=M, m=m,
            ntv=ntv, bionj=int(opts.bionj), smem_state=int(state_in_smem),
            smem_lists=int(lists_in_smem),
            stale_limit=float(opts.stale_out_limit),
            refresh_thresh=int(0.5 + m * opts.tophits_refresh),
            age_limit=max(1, int(0.5 + math.log2(m))),
            ev=self.ev.data_ptr() if self.ev is not None else None,
            et=self.et.data_ptr() if self.et is not None else None,
            **{k: v.data_ptr() for k, v in t.items()
               if not k.startswith("con_")})
        self.store(prof)

    def store(self, prof) -> None:
        """Point the parameters at the store's arrays and out-profile (the
        kernel updates both in place)."""
        for name in ("w_out", "f_out"):
            x = getattr(prof, name)
            if x.dtype != torch.float32 or not x.is_contiguous() \
                    or x.device != self.dev:
                raise ValueError(f"nj_join_epoch: the out-profile's {name} "
                                 "must be contiguous float32 on the store's "
                                 "device")
        p = self.params
        p.codes, p.W, p.U = (prof.codes.data_ptr(), prof.W.data_ptr(),
                             prof.U.data_ptr())
        p.code_freq = prof.code_freq.data_ptr()
        p.w_out, p.f_out = prof.w_out.data_ptr(), prof.f_out.data_ptr()

    def words(self) -> dict:
        """One fetch: the kernel's words by name."""
        return dict(zip(WORDS, self.t["words"].cpu().tolist()))

    def host(self, name) -> np.ndarray:
        return self.t[name].cpu().numpy()


def _launch(state, seg, grid) -> int:
    p = state.params
    p.n_hi, p.n_lo, p.resume, p.stop_reset = (int(x) for x in seg)
    for name in ("ctl", "mark", "mark2"):
        state.t[name].zero_()
    used = ctypes.c_int(0)
    lib = _build.library()
    stream = torch.cuda.current_stream(state.dev).cuda_stream
    if state.cons is None:
        rc = lib.vft_nj_epoch_f32(ctypes.byref(p), int(grid or 0),
                                  ctypes.byref(used), stream)
    else:
        rc = lib.vft_nj_epoch_cons_f32(ctypes.byref(p),
                                       ctypes.byref(state.cons),
                                       int(grid or 0), ctypes.byref(used),
                                       stream)
    me_round.raise_on(rc, "nj_join_epoch")
    join_epoch.launches += 1
    join_epoch.cons_launches += state.cons is not None
    return used.value


def join_epoch(nj, tophits, max_joins=None, grid=None,
               state_in_smem=True, lists_in_smem=True) -> None:
    """The join phase of fast_nj from the leaf top-hits on (at most
    max_joins joins; the caller roots the three last nodes): the host loop
    for a store on the CPU, the epoch kernel's launches for a store on a
    CUDA device.  nj (tree, join log, branch lengths, per-node arrays,
    totdiam, store rows, out-profile, debug counters, constraint counts)
    and tophits (lists, visible and top-visible sets, ages) come out as the
    host loop leaves them; under -constraints the constrained kernel
    (nj_epoch_cons_kernel) adds the join penalties.  grid: blocks of the
    cooperative launch (None: one per SM).  state_in_smem=False keeps the
    decisions' per-node arrays in device memory, as the kernel does anyway
    where they would not fit in shared memory (N above about 2,300);
    lists_in_smem=False the deciding warp's small lists (hit-list remaps,
    merges, selections), as it does where they would not fit beside the
    per-node arrays."""
    if nj.prof.codes.device.type == "cpu":
        nj._join_loop_host(tophits, None, max_joins)
        return
    _run_launches(nj, tophits, max_joins, grid, state_in_smem, lists_in_smem)


def _run_launches(nj, tophits, max_joins, grid, state_in_smem=True,
                  lists_in_smem=True) -> None:
    segs = segments(nj.n_seqs, nj.options, max_joins)
    if not segs:
        return
    state = EpochState(nj, tophits, state_in_smem, lists_in_smem)
    prof = nj.prof
    n_total = nj.n_seqs - 3
    for seg in segs:
        join_epoch.totals["grid"] = _launch(state, seg, grid)
        w = state.words()
        if w["fault"]:
            raise RuntimeError(
                f"nj_join_epoch: {FAULTS.get(w['fault'], w['fault'])} "
                f"(at {w['fault_at']})")
        if seg[3]:
            # the reset join: its out-profile from the active rows, as the
            # host loop recomputes it
            parent = state.host("parent")
            active = parent < 0
            active[w["maxnode"]:] = False
            nj.totdiam = float(state.host("diam")[active].sum())
            state.t["totdiam"].fill_(nj.totdiam)
            prof.recompute_outprofile(active)
            state.store(prof)
            join_epoch.totals["resets"] += 1
        if nj.progress is not None and w["joins"]:
            nj.progress.print("Joined %6d of %6d", w["joins"], n_total)
    _write_back(nj, tophits, state, w)
    for k in COUNTERS + ("joins", "phases", "scans", "scan_rows"):
        join_epoch.totals[k] += w[k]


def _write_back(nj, tophits, state, w) -> None:
    tree = nj.tree
    n = w["joins"]
    ji, jj = state.host("join_i")[:n], state.host("join_j")[:n]
    for i, j in zip(ji.tolist(), jj.tolist()):
        node = tree.maxnode
        tree.maxnode += 1
        tree.set_children(node, [min(i, j), max(i, j)])
        nj.join_log.append((i, j))
    if tree.maxnode != w["maxnode"]:
        raise RuntimeError("nj_join_epoch: the join log does not match the "
                           "kernel's node count")
    tree.branchlength[:] = state.host("bl")
    nj.out_distances[:] = state.host("od")
    nj.n_out_dist_active[:] = state.host("noda")
    nj.selfdist[:] = state.host("selfdist")
    nj.selfweight[:] = state.host("selfweight")
    nj.diameter[:] = state.host("diam")
    nj.var_diameter[:] = state.host("vard")
    nj.totdiam = float(state.host("totdiam")[0])
    for name in COUNTERS:
        setattr(nj.debug, name, getattr(nj.debug, name) + w[name])
    if nj.n_cons:
        nj.con_on[:] = state.host("con_on")
        nj.con_off[:] = state.host("con_off")
    tophits.unpack_state(state.host("hits_j"), state.host("hits_d"))
    tophits.visible_j[:] = state.host("vis_j")
    tophits.visible_dist[:] = state.host("vis_d")
    tophits.topvisible[:] = state.host("tv")
    tophits.topvisible_age = w["tv_age"]
    tophits.age[:] = state.host("age")


join_epoch.launches = 0
# the launches of the constrained kernel (nj_epoch_cons_kernel) among them
join_epoch.cons_launches = 0
# the work of the launches: the debug counts of their joins, the joins,
# phases (wide steps handed to the grid), refresh scans and the rows they
# read, out-profile resets, and the last launch's grid
join_epoch.totals = dict.fromkeys(COUNTERS + ("joins", "phases", "scans",
                                              "scan_rows", "resets", "grid"), 0)
