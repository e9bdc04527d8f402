#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script exits 0 only when all
passed):

0. the card (nvidia-smi name and power limit), torch's CUDA version;
1. build the CUDA kernels from veryfasttree_tpu_torch/csrc; ptxas must
   report no stack frame and no spill store for the ML and ME round
   kernels, at most 32 bytes of stack for ml_quartet_opt and at most the
   deciding warp's 616 bytes for nj_join_epoch (_build.resource_faults);
2. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with the median time of 50 runs of each (CUDA events):
   the scans and the pair distances in double (rtol 1e-12, atol 1e-12; best
   index equal), the profile average bit-identical (rtol 1e-6 in BLOSUM45
   matrix mode).
   The ML store's kernels (ml_pair_loglk, ml_posterior, ml_opt_branch)
   against theirs on a store of the N=2000 layout (12008 rows of 512
   positions), Jukes-Cantor and GTR with 4 codes and JTT with 20: ll and
   per-site lk rtol 1e-6, posterior W and V atol 1e-6, line search x rtol
   1e-4 and -loglk at x atol 1e-3; a list of 300 pairs and one of 200
   posteriors (past the old caps of a launch, 256 and 128) also bit for bit
   their K=1 launches, and both timed at the SH pass's list shapes
   (3 x 1997 pairs, 2 x 1997 posteriors).  The quartet kernel (ml_quartet_opt) on
   200 quartets of that layout, Jukes-Cantor and GTR, with the star test
   and with per-site likelihoods: bit for bit the chain of the three
   single-call kernels it fuses (ml_kernels.quartet_chain), and against
   its twin on 24 of them the star decisions equal, lengths within 2e-3 +
   2e-2 x length and the quartet LogLk within 1e-4 relative, as the
   final LogLk of phase 5 (the float32 objective of a search, a sum near
   -2000, has an ulp of 1.2e-4, and its flat bottom spans about 1e-3 in
   x: the last-bit differences of the Jukes-Cantor per-site logs move
   where Brent stops within it, and the posteriors and searches after it
   carry that on).  Each
   kernel's device time per launch comes from torch.profiler (CUDA
   activity) over 50 launches, apart from the launch-to-launch time, and
   its bound from the bytes and operations of the timed call;
2b. one SPR round at N=500 from one NJ start, dense, two-tier and protein
   (20 codes, BLOSUM45 matrix mode): the round kernel (me_spr_round)
   against the host loop through the per-call kernels, tree, counters and
   node rows bit for bit, and dense once more with the kernel's tree in
   device memory (its layout above about 4,000 nodes); dense, also against
   the plain twin (the host loop on the per-call twins, on the CPU): the
   same tree and counters, rows within 1e-6; both walls, the launches, the
   kernel's device time per node and per chain step (torch.profiler), and
   its bound from the
   distinct rows the round reads and writes and its operations;
2c. one ME NNI round at N=500 from the same NJ starts, in the same cases:
   the round kernel (me_nni_round) against the host loop
   engine/rearrange.do_nni through the per-call kernels, tree, NNIStats
   ages, counters and node rows bit for bit, deltas and supports within
   1e-13 (log1p's last bit), one launch per round; dense, also
   against the plain twin on the CPU (rows within 1e-6, deltas and supports
   within 1e-9); the walls, the device time per quartet, the rows averaged
   per quartet and the bound;
2d. the NJ phase at N=500 (dense, two-tier, protein) and N=2000 (dense,
   with the decisions' per-node arrays in shared and in device memory):
   its joins through the join epoch kernel (nj_join_epoch, one launch per
   out-profile reset) against the host loop through the per-call kernels,
   every array bit for bit (join log, tree, branch lengths, diameters,
   self- and out-distances, store rows, out-profile, top-hits lists,
   visible and top-visible sets, ages, debug counters); N=500 dense also
   against the plain twin (the host loop on the CPU): the same join log,
   values within 1e-4 (its out-profile weights round otherwise); both
   walls, the launches, the device time in all and per join of each dense
   case and the bound;
2e. one ML lengths pass, then one ML NNI round, at N=500 from one NJ start
   with an ML store (Jukes-Cantor with one rate, Jukes-Cantor and GTR with
   fitted CAT 20 rates): the round kernels (ml_lengths_pass, ml_nni_round,
   one launch each) against the host loops
   engine/ml.optimize_all_branch_lengths and engine/rearrange.do_nni
   through the per-call kernels, tree, branch lengths, NNIStats, counters
   and the ML store's node and up-profile rows bit for bit; the first case
   also with the kernels' tree in device memory, and against the plain
   twins on the CPU (the tree LogLk after the pass and the round within
   1e-5 relative, quartet decisions equal up to a flip on a near tie); the
   walls, the device time per quartet optimization, line search and node
   beside the host loop's kernels', the round's speculative AC and AD
   optimizations (started beside AB on the cluster's other blocks, then
   discarded), and the bound;
2f. the SH-like supports at N=500 from one start after an ML lengths pass
   and NNI round (JC and GTR, CAT 20, 1000 resamples): the list pass
   (ops/ml_round.sh_pass: the counts, a posterior launch per up-profile
   level, one launch each of the AB posteriors, the AB pairs and the AC/AD
   quartets, one more for the second pass) against the host loop
   engine/ml.test_splits_ml with the per-call kernels: per-split
   log-likelihoods, per-site likelihoods, choices, bad splits, supports,
   SplitCount, counters and store rows bit for bit; its launches, walls,
   device time and bound; the bootstrap counts kernel (sh_resample_counts)
   equal to its twin at B=1000, P=500;
2g. the CAT fit and the tree log-likelihood as whole-tree launches
   (ml_posterior_sweep, ml_tree_loglk) against the per-level launches of
   ml_posterior and ml_pair_loglk, at N=2000, P=500 from the port's NJ
   tree (Jukes-Cantor and GTR): the 20 rates' per-site log-likelihoods
   within 1e-12 relative (the per-level path's sums take torch's
   reduction orders), the categories equal, the store's rows after the
   fit bit for bit; then one sweep and one tree log-likelihood at the
   fitted categories, and on a caterpillar of 600 leaves (599 levels):
   the sweep's rows bit for bit the per-level launches', the sums within
   1e-12 relative, and against the twins on the card within the ML store
   tolerances (rows rtol 1e-6, atol 1e-4; per-site sums rtol 1e-5, atol
   1e-4); each kernel's device time, launch-to-launch time, the per-level
   launches' time, the twin's and the bound;
3. the -noml pipeline at N=500, P=500 against the JAX package's tree
   (tests/data/torch_port_golden_n500_p500.nwk), dense and two-tier: RF 0
   to the golden, and the two layouts give the same Newick; then the same
   input through the command line (python -m veryfasttree_tpu_torch -nt
   -noml -nosupport), RF 0 to the golden;
4. the -noml main path: full -nt -noml -nosupport at N=2000, P=500 (the
   bench.py input) through run_pipeline, cold, then warm, then once more
   with the two-tier store forced on (-two-tier-min 0), which must give the
   same tree.  The kernel launch counts are reset just before the warm run
   and read just after it: each kernel of the dense path must have
   launched.  The scans run inside the join epoch's refreshes, so its
   refresh scans must be nonzero there (and in the two-tier run, where the
   leaf rows take the codes scan's body);
5. the ML phase against the JAX package's trees at N=200, P=500
   (tests/data/torch_port_ml_golden_n200_p500*): the default -nt run (ML
   NNIs, CAT 20, SH-like supports from 1000 resamples) and -nt -gtr
   -gamma, each RF 0 to its golden and final LogLk within 1e-4 relative,
   with the per-round LogLk differences printed; the default run is traced
   with torch.profiler for the device's busy share; then the default run
   through the command line (python -m veryfasttree_tpu_torch -nt), RF 0
   to its golden;
6. the ML main path: the full default -nt run at N=2000, P=500 through
   run_pipeline (warm: phase 5 ran the same code), with its phase split and
   final LogLk.  The launch counts are reset just before it and read just
   after it: every kernel of the dense path, the ML kernels included, must
   have launched (but ml_opt_branch, whose body runs inside the round
   kernels: its count, 0, is printed), the ML NNI rounds must have kept the
   tree in shared memory with no device scratch, the SH pass must have run
   on the card in its list launches (sh_launches: the counts once, one pair
   launch, one or two quartet launches, one sweep of the up-profiles and
   one posterior launch), and the final LogLk and the ML-NNIs per round must
   be the ones recorded in PERF.md for this input (the kernels' arithmetic
   does not change the tree).  The CAT fit (cat_launches) must launch 22
   sweeps and 20 tree log-likelihoods and nothing else, and the whole run
   ml_posterior and ml_pair_loglk only once each (the SH pass's lists).

The last lines are the card's name and power limit, one JSON line with each
kernel's route, source, main-path launches (the ML main path's for the ML
kernels, the -noml one's for the others, with their ML-path and two-tier
launches apart), error, times and bound, and the result line.  Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import collections  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden_n500_p500")
ML_GOLDEN = os.path.join(REPO, "tests", "data",
                         "torch_port_ml_golden_n200_p500")
MAIN_N, MAIN_P = 2000, 500          # bench.py's input
ML_GOLDEN_N = 200

# name -> (source, what it replaces in the JAX package on the TPU: the two
# Pallas kernels, and the XLA-compiled store functions behind the host loops)
KERNELS = {
    "nj_scan_dense": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                      "veryfasttree_tpu/ops/pallas_kernels.py:38"),
    "nj_scan_codes": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                      "veryfasttree_tpu/ops/pallas_kernels.py:173"),
    "me_dists": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                 "veryfasttree_tpu/engine/profiles.py:244"),
    "me_average": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                   "veryfasttree_tpu/engine/profiles.py:310"),
    "ml_pair_loglk": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                      "veryfasttree_tpu/engine/ml_profiles.py:52"),
    "ml_posterior": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                     "veryfasttree_tpu/engine/ml_profiles.py:77"),
    "ml_opt_branch": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                      "veryfasttree_tpu/engine/ml_profiles.py:743"),
    "ml_quartet_opt": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                       "veryfasttree_tpu/engine/ml.py:146"),
    "me_spr_round": ("veryfasttree_tpu_torch/csrc/me_spr.cu",
                     "veryfasttree_tpu/engine/spr_epoch.py:97"),
    "me_nni_round": ("veryfasttree_tpu_torch/csrc/me_nni.cu",
                     "veryfasttree_tpu/engine/rearrange.py:246"),
    "nj_join_epoch": ("veryfasttree_tpu_torch/csrc/nj_epoch.cu",
                      "veryfasttree_tpu/engine/epoch.py:131"),
    "ml_nni_round": ("veryfasttree_tpu_torch/csrc/ml_round.cu",
                     "veryfasttree_tpu/engine/rearrange.py:246"),
    "ml_lengths_pass": ("veryfasttree_tpu_torch/csrc/ml_round.cu",
                        "veryfasttree_tpu/engine/ml.py:380"),
    "sh_resample_counts": ("veryfasttree_tpu_torch/csrc/sh_resample.cu",
                           "veryfasttree_tpu/engine/supports.py:37"),
    "ml_posterior_sweep": ("veryfasttree_tpu_torch/csrc/ml_sweep.cu",
                           "veryfasttree_tpu/engine/ml_profiles.py:123"),
    "ml_tree_loglk": ("veryfasttree_tpu_torch/csrc/ml_sweep.cu",
                      "veryfasttree_tpu/engine/ml.py:299"),
}
ML_KERNELS = ("ml_pair_loglk", "ml_posterior", "ml_opt_branch",
              "ml_quartet_opt", "ml_nni_round", "ml_lengths_pass",
              "sh_resample_counts", "ml_posterior_sweep", "ml_tree_loglk")
# the ML kernels the default run launches: ml_opt_branch's one search per
# launch came only from the lengths passes, whose kernel runs its body
# (line_search) instead; its count (0) is printed and reported all the same
ML_PATH = tuple(k for k in ML_KERNELS if k != "ml_opt_branch")
# the CUDA kernels each wrapper launches (names as torch.profiler shows them)
DEVICE_NAMES = {
    "nj_scan_dense": ("nj_scan_dense_kernel", "argmin_partials_kernel"),
    "nj_scan_codes": ("nj_scan_codes_kernel", "argmin_partials_kernel"),
    "me_dists": ("me_pair_dist_kernel",),
    "me_average": ("me_average_kernel",),
    "ml_pair_loglk": ("ml_pair_loglk_kernel",),
    "ml_posterior": ("ml_posterior_kernel",),
    "ml_opt_branch": ("ml_opt_branch_kernel",),
    "ml_quartet_opt": ("ml_quartet_opt_kernel",),
    "me_spr_round": ("me_spr_round_kernel",),
    "me_nni_round": ("me_nni_round_kernel",),
    "nj_join_epoch": ("nj_epoch_kernel",),
    "ml_nni_round": ("ml_nni_round_kernel",),
    "ml_lengths_pass": ("ml_lengths_pass_kernel",),
    "sh_resample_counts": ("sh_resample_counts_kernel",),
    "ml_posterior_sweep": ("ml_posterior_sweep_kernel",),
    "ml_tree_loglk": ("ml_tree_loglk_kernel",),
}
# final LogLk and ML-NNIs per round of the default -nt run at N=2000
# (PERF.md, section 5)
ML_MAIN_LOGLK = "-427535.845"
ML_MAIN_NNIS = [706, 447, 198, 113, 53, 32, 13, 4, 0, 7]
# the least time of a call (NVIDIA's H100 SXM data sheet, at 700 W): bytes
# over the memory rate, operations over the float32 rate outside the
# tensor cores (double operations are counted at that rate too, which can
# only lower the bound)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = dict(rtol=1e-12, atol=1e-12)
BEST = 100                      # the row the scan inputs make the best


def TWINS(n):
    """Exact duplicates of row BEST: two in range, one past m_real."""
    return n // 2, 3 * n // 4, n - 10


def wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from veryfasttree_tpu_torch.ops import epoch_kernels, ml_kernels, \
        ml_round, nni_kernels, resample_kernels, scan_kernels, spr_kernels, \
        store_kernels

    return {"nj_scan_dense": scan_kernels.nj_scan_dense,
            "nj_scan_codes": scan_kernels.nj_scan_codes,
            "me_dists": store_kernels.me_dists,
            "me_average": store_kernels.me_average,
            "ml_pair_loglk": ml_kernels.ml_pair_loglk,
            "ml_posterior": ml_kernels.ml_posterior,
            "ml_opt_branch": ml_kernels.ml_opt_branch,
            "ml_quartet_opt": ml_kernels.ml_quartet_opt,
            "me_spr_round": spr_kernels.spr_round,
            "me_nni_round": nni_kernels.nni_round,
            "nj_join_epoch": epoch_kernels.join_epoch,
            "ml_nni_round": ml_round.ml_nni_round,
            "ml_lengths_pass": ml_round.ml_lengths_pass,
            "sh_resample_counts": resample_kernels.sh_resample_counts,
            "ml_posterior_sweep": ml_kernels.ml_posterior_sweep,
            "ml_tree_loglk": ml_kernels.ml_tree_loglk}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "totals"):                 # the rounds' counters
            fn.totals = dict.fromkeys(fn.totals, 0)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, runs=50):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_us(fn, names, runs=50, attempts=3):
    """Device time per call of fn, in us: the durations of the CUDA kernels
    named in `names` (substrings) that torch.profiler (CUDA activity)
    traces over `runs` calls, summed and divided by `runs`.  Every call
    launches the same kernels, so a trace that holds a launch count of a
    name that is not a multiple of `runs` has lost events and is taken
    again; after `attempts` such traces the time is that of a burst of
    `runs` calls between two CUDA events, which bounds the device time from
    above, and the script says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        durations = collections.defaultdict(list)
        for evt in trace.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                for n in names:
                    if n in evt.name:
                        durations[n].append(evt.time_range.elapsed_us())
        if all(durations[n] and len(durations[n]) % runs == 0
               for n in names):
            return sum(sum(durations[n]) for n in names) / runs
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    print(f"  (torch.profiler lost launches of {names} in {attempts} "
          "traces: the device time is a burst's, between CUDA events)")
    return 1e3 * start.elapsed_time(stop) / runs


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of n_bytes over the memory rate and
    n_ops over the float32 rate."""
    ms_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    ms_ops = 1e3 * n_ops / F32_OPS_PER_S
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else \
        (ms_ops, "operations")


def timing(name, fn, twin, n_bytes, n_ops, twin_runs=50):
    """The measured fields of one kernel's entry at one call's inputs: the
    call's launch-to-launch time (host wrapper included) and its device
    time, the twin's time, and the bound of the call's bytes and
    operations.  No single PyTorch call computes any of these functions, so
    library_ms is None."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {"ms": median_ms(fn), "plain_ms": median_ms(twin, twin_runs),
            "device_us": device_us(fn, DEVICE_NAMES[name]),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def ml_row_bytes(P, C):
    """Bytes of one ML store row: codes int8, W float32, V float32 [P, C]."""
    return P * (5 + 4 * C)


# operations per position, counted as the kernels write them (csrc/ml_lk.cu):
# the effective vectors of two rows (three per element each), one site
# likelihood (three per element) with its log and sum, a posterior (JC:
# ten per element and a division; matrix: the products, two C x C rotations
# and the normalisation)
def ml_ops(C, jc):
    eff, site = 6 * C, 3 * C + 2
    post = eff + (11 * C if jc else 6 * C * C + 6 * C)
    return eff, site, post


# --------------------------------------------------------------- phase 2
def dense_case(C, use_matrix, gen, dev, M=8192, P=512):
    """Scan inputs at the main path's store shape: gap rows, masked tail,
    and duplicated rows forcing an exact tie for the best."""
    import torch

    from veryfasttree_tpu_torch.models import DistanceMatrix

    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.rand((M, P), generator=gen, **f32) * 0.7 + 0.3
    W[torch.rand((M, P), generator=gen, **f32) < 0.05] = 0.0
    W[5:9] = 0.0
    f = torch.rand((M, P, C), generator=gen, **f32)
    f /= f.sum(-1, keepdim=True)
    U = W[..., None] * f
    outd = torch.rand(M, generator=gen, dtype=torch.float64, device=dev)
    for r in TWINS(M):                       # duplicates of row BEST
        U[r], W[r] = U[BEST], W[BEST]
    outd[[BEST, *TWINS(M)[:2]]] = 60.0
    outd[M - 10] = 120.0                     # the best row, but masked
    a = U[17].double()
    if use_matrix:
        a = a * torch.as_tensor(DistanceMatrix.blosum45().eigenval,
                                device=dev)[None, :]
    return (U.reshape(M, P * C), W, a.reshape(-1), W[17].double(), outd,
            300, M - 64, use_matrix)


def codes_case(C, use_matrix, gen, dev, L=20000, P=512):
    import torch

    from veryfasttree_tpu_torch.models import DistanceMatrix

    codes = torch.randint(0, C, (L, P), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((L, P), generator=gen, device=dev) < 0.05] = 127
    codes[5:9] = 127
    outd = torch.rand(L, generator=gen, dtype=torch.float64, device=dev)
    for r in TWINS(L):
        codes[r] = codes[BEST]
    outd[[BEST, *TWINS(L)[:2]]] = 60.0
    outd[L - 10] = 120.0
    uq = torch.rand((P, C), generator=gen, dtype=torch.float64, device=dev)
    uq /= uq.sum(-1, keepdim=True)
    wq = torch.rand(P, generator=gen, dtype=torch.float64, device=dev)
    uq *= wq[:, None]
    if use_matrix:
        dm = DistanceMatrix.blosum45()
        ev = torch.as_tensor(dm.eigenval, device=dev)
        cf = torch.as_tensor(dm.code_freq, device=dev)
        G = ((uq * ev[None, :]) @ cf.T).T.contiguous()
    else:
        G = uq.T.contiguous()
    return codes, G, wq, outd, 300, L - 64, use_matrix


def store_case(C, use_matrix, leaf_rows, gen, dev, n_rows=8192, P=512):
    """A random profile store in the main path's layout (N=2000: 8192 rows
    of 512 positions); rows below leaf_rows exist only as codes."""
    import torch

    from veryfasttree_tpu_torch.models import DistanceMatrix

    codes = torch.randint(0, C, (n_rows, P), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((n_rows, P), generator=gen, device=dev) < 0.05] = 127
    codes[5:9] = 127
    n_float = -(-(n_rows - leaf_rows) // 256) * 256
    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.rand((n_float, P), generator=gen, **f32) * 0.7 + 0.3
    W[torch.rand((n_float, P), generator=gen, **f32) < 0.05] = 0.0
    f = torch.rand((n_float, P, C), generator=gen, **f32)
    U = W[..., None] * (f / f.sum(-1, keepdim=True))
    if use_matrix:
        dm = DistanceMatrix.blosum45()
        cf = torch.as_tensor(dm.code_freq, **f32)
        ev = torch.as_tensor(dm.eigenval, dtype=torch.float64, device=dev)
        et = torch.as_tensor(dm.eigentot, **f32)
    else:
        cf, ev, et = torch.eye(C, **f32), None, None
    return codes, W, U, cf, ev, et


def check_dists(label, C, use_matrix, leaf_rows, gen, dev):
    """me_dists against its twin: 300 rows against a query (an out-profile
    refresh) and the 6 pairs of an NNI quartet; the time is the quartet's."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import store_kernels as st

    codes, W, U, cf, ev, _ = store_case(C, use_matrix, leaf_rows, gen, dev)
    rng = np.random.default_rng(C + leaf_rows)
    n_rows = codes.shape[0]
    q_rows = rng.choice(n_rows, 300, replace=False)
    quartet = rng.choice(n_rows, 4, replace=False)
    quartet[0] = 6                           # a row with no weight (dist 1)
    ii = quartet[[0, 0, 0, 1, 1, 2]]
    jj = quartet[[1, 2, 3, 2, 3, 3]]
    q = (U[300], W[300])
    store = (codes, W, U, cf, ev, leaf_rows)
    got = st.me_dists(*store, q_rows, *q, ii, jj).cpu().numpy()
    exp = st.me_dists_ref(*store, q_rows, *q, ii, jj).cpu().numpy()
    np.testing.assert_allclose(got, exp, err_msg=f"me_dists {label}", **TOL)
    err = float(np.max(np.abs(got - exp)))
    nni = (*store, (), None, None, ii, jj)
    P, C = W.shape[1], cf.shape[1]
    # the quartet's four rows (float rows: U, W and codes) and 2 x 6 doubles
    n_bytes = 4 * P * (4 * C + 5) + 2 * 6 * 8
    return err, timing("me_dists", lambda: st.me_dists(*nni),
                       lambda: st.me_dists_ref(*nni), n_bytes,
                       6 * P * (2 * C + 2))


def check_average(label, C, use_matrix, leaf_rows, gen, dev):
    """me_average against its twin on copies of one store: one join, then
    a level of 200 targets; codes and weights equal, vectors equal in
    %different mode (rtol 1e-6 in matrix mode, whose position total is a
    float32 dot product summed in another order); the time is one join's."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import store_kernels as st

    codes, W, U, cf, _, et = store_case(C, use_matrix, leaf_rows, gen, dev)
    rng = np.random.default_rng(7 + C + leaf_rows)
    n_rows = codes.shape[0]
    rows = rng.permutation(np.arange(max(leaf_rows, 16), n_rows))
    level = (rows[:200], rows[200:400].copy(), rows[400:600])
    if leaf_rows:
        level[1][:100] = rng.choice(leaf_rows, 100)
    level[1][:3] = 5                         # NOCODE rows as sources
    calls = [([rows[500]], [3], [rows[600]], 0.5), (*level, 0.5),
             ([rows[700]], [9], [10], 0.3)]
    stores = []
    for fn in (st.me_average, st.me_average_ref):
        c, w, u = codes.clone(), W.clone(), U.clone()
        for t, i, j, bw in calls:
            fn(c, w, u, cf, et, leaf_rows, t, i, j, bw, 1e-10)
        stores.append((c.cpu().numpy(), w.cpu().numpy(), u.cpu().numpy()))
    (c1, w1, u1), (c2, w2, u2) = stores
    np.testing.assert_array_equal(c1, c2, err_msg=f"me_average {label} codes")
    tol = dict(rtol=1e-6, atol=1e-7) if use_matrix else dict(rtol=0, atol=0)
    np.testing.assert_allclose(w1, w2, err_msg=f"me_average {label} W", **tol)
    np.testing.assert_allclose(u1, u2, err_msg=f"me_average {label} U", **tol)
    err = max(float(np.max(np.abs(w1 - w2))), float(np.max(np.abs(u1 - u2))))
    one = (codes, W, U, cf, et, leaf_rows, [rows[500]], [3], [rows[600]], 0.5,
           1e-10)
    P, C = W.shape[1], cf.shape[1]
    # two rows read, one written (U, W and codes)
    return err, timing("me_average", lambda: st.me_average(*one),
                       lambda: st.me_average_ref(*one), 3 * P * (4 * C + 5),
                       P * (4 * C + 6))


def check_kernel(name, kernel, twin, args):
    import numpy as np
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    exp = twin(*args)
    if not int(got[0]) == int(exp[0]) == BEST:
        raise AssertionError(f"{name}: best index {int(got[0])}, twin's "
                             f"{int(exp[0])}, expected the tie's lowest {BEST}")
    err = 0.0
    for label, g, e in zip(("best_crit", "dist", "denom", "crit"), got[1:],
                           exp[1:]):
        g, e = g.cpu().numpy(), e.cpu().numpy()
        np.testing.assert_allclose(g, e, err_msg=f"{name} {label}", **TOL)
        err = max(err, float(np.max(np.abs(g - e))))
    # dense: (U2, W, a, wq, outd, ...); codes: (codes, G, wq, outd, ...)
    dense = name == "nj_scan_dense"
    rows, q, wq, outd = (args[0], args[2], args[3], args[4]) if dense else \
        (args[0], args[1], args[2], args[3])
    # the rows (and W in the dense scan), the query, the out-distances in;
    # distance, denominator and criterion out (doubles); two operations for
    # each element of a row, a few for each row's criterion
    n_bytes = rows.numel() * rows.element_size() \
        + 8 * (q.numel() + wq.numel()) + 8 * 4 * outd.numel()
    n_ops = 2 * rows.numel() + 10 * outd.numel()
    if dense:
        n_bytes += args[1].numel() * 4
        n_ops += 2 * args[1].numel()
    return int(got[0]), err, timing(name, lambda: kernel(*args),
                                    lambda: twin(*args), n_bytes, n_ops)


def ml_store_case(C, model, gen, dev, n_rows=3 * 2 * MAIN_N + 8, P=512,
                  n_pos=MAIN_P, n_leaf=MAIN_N):
    """A random ML store in the N=2000 layout: leaf rows (codes with gaps)
    below n_leaf, posterior rows (NOCODE; weights 0, 1 and a few fractions)
    above, 20 CAT rates.  Returns (codes, W, V, MLModel)."""
    import torch

    from veryfasttree_tpu_torch.models import TransitionMatrix
    from veryfasttree_tpu_torch.ops.ml_kernels import MLModel

    f32 = dict(dtype=torch.float32, device=dev)
    if model == "jc":
        cf = torch.zeros((128, C), **f32)
        cf[:C] = torch.eye(C, **f32)
        cf[127] = 0.25
        ev, ei, si = (torch.zeros(C, **f32), torch.eye(C, **f32),
                      torch.ones(C, **f32))
    else:
        tm = TransitionMatrix.jtt92() if model == "jtt" else \
            TransitionMatrix.gtr([1.2, 3.1, 0.8, 1.1, 2.9, 1.0],
                                 [0.3, 0.2, 0.24, 0.26])
        cf, ev, ei, si = (torch.tensor(a, **f32).contiguous() for a in (
            tm.code_freq, tm.eigenval, tm.eigeninv, tm.statinv))
    codes = torch.randint(0, C, (n_rows, P), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((n_rows, P), generator=gen, **f32) < 0.05] = 127
    codes[n_leaf:] = 127
    codes[:, n_pos:] = 127
    W = (codes != 127).float()
    u = torch.rand((n_rows - n_leaf, P), generator=gen, **f32)
    W[n_leaf:] = torch.where(u < 0.05, 0.0, torch.where(u < 0.1, u * 10, 1.0))
    W[:, n_pos:] = 0.0
    f = torch.rand((n_rows, P, C), generator=gen, **f32) ** 4
    V = torch.where(W[..., None] > 0, (f / f.sum(-1, keepdim=True)) @ cf[:C],
                    cf[127])
    V[:n_leaf] = cf[codes[:n_leaf].long()]
    rates = torch.exp(torch.linspace(-math.log(20), math.log(20), 20, **f32))
    ratecat = torch.randint(0, 20, (P,), generator=gen, device=dev,
                            dtype=torch.int32)
    return codes, W, V, MLModel(model == "jc", cf, ev, ei, si, rates, ratecat,
                                n_pos, 2.5e-4, 1e-10)


# the SH pass's list shapes at the main path's N: 3S pairs, 2S posteriors
SH_SPLITS = MAIN_N - 3
LIST_PAIRS, LIST_POSTERIORS = 3 * SH_SPLITS, 2 * SH_SPLITS


def one_by_one(label, name, list_out, one_outs):
    """Raise unless a list launch's outputs equal those of K=1 launches,
    bit for bit."""
    import numpy as np

    for k, one in enumerate(one_outs):
        for a, b in zip(list_out, one):
            if np.asarray(a[k]).tobytes() != np.asarray(b).tobytes():
                raise AssertionError(f"{name} {label}: item {k} of the list "
                                     "differs from its K=1 launch")


def check_ml(label, C, model, gen, dev):
    """The three ML kernels against their twins on one store: a list of 300
    pairs (ll and per-site lk) and of 200 posteriors (on copies of the
    store), past the old caps of a launch (256 and 128), each also bit for
    bit its K=1 launches; the lists of the SH pass's shapes at N=MAIN_N
    (3S pairs, 2S posteriors into the list-pass rows) against the twins at
    the same tolerances, and 16 of their items spread over the list bit for
    bit their K=1 launches; and 16 line searches.  The pair and posterior
    kernels are timed at the SH pass's list shapes, with the time of one
    item alone beside it; the line search at one call.  Returns {name:
    (err, timing)}."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    codes, W, V, m = ml_store_case(C, model, gen, dev)
    store = (codes, W, V, m)
    n_rows, P = codes.shape
    row = ml_row_bytes(P, C)
    eff, site, post_ops = ml_ops(C, model == "jc")
    rng = np.random.default_rng(C + len(model))
    r1, r2 = rng.integers(0, n_rows, 300), rng.integers(0, n_rows, 300)
    lens = rng.uniform(0.0, 0.5, 300)
    lens[:3] = (0.0, 5e-4, 6.0)
    out = {}

    ll, lk = mk.ml_pair_loglk(*store, r1, r2, lens, want_lk=True)
    ll_t, lk_t = mk.ml_pair_loglk_ref(*store, r1, r2, lens, want_lk=True)
    ll, ll_t, lk, lk_t = (t.cpu().numpy() for t in (ll, ll_t, lk, lk_t))
    np.testing.assert_allclose(ll, ll_t, rtol=1e-6,
                               err_msg=f"ml_pair_loglk {label} ll")
    np.testing.assert_allclose(lk, lk_t, rtol=1e-6, atol=1e-30,
                               err_msg=f"ml_pair_loglk {label} lk")
    one_by_one(label, "ml_pair_loglk", (ll, lk), [
        tuple(t[0].cpu().numpy() for t in mk.ml_pair_loglk(
            *store, r1[k:k + 1], r2[k:k + 1], lens[k:k + 1], want_lk=True))
        for k in range(len(r1))])
    # the list: 3S pairs of rows of the store at the SH pass's lengths
    K = LIST_PAIRS
    lr1, lr2 = rng.integers(0, n_rows, K), rng.integers(0, n_rows, K)
    llens = rng.uniform(0.0, 0.5, K)
    lst = (*store, lr1, lr2, llens, True)
    got = [t.cpu().numpy() for t in mk.ml_pair_loglk(*lst)]
    want = [t.cpu().numpy() for t in mk.ml_pair_loglk_ref(*lst)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6,
                               err_msg=f"ml_pair_loglk {label} ll, {K} pairs")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-30,
                               err_msg=f"ml_pair_loglk {label} lk, {K} pairs")
    spread = np.linspace(0, K - 1, 16).astype(int)
    one_by_one(f"{label} {K} pairs", "ml_pair_loglk",
               tuple(g[spread] for g in got), [
                   tuple(t[0].cpu().numpy() for t in mk.ml_pair_loglk(
                       *store, lr1[k:k + 1], lr2[k:k + 1], llens[k:k + 1],
                       want_lk=True)) for k in spread])
    n_distinct = len(np.unique(np.concatenate([lr1, lr2])))
    # the distinct rows and the rate categories in, K doubles and K per-site
    # rows out
    out["ml_pair_loglk"] = (max(float(np.max(np.abs(ll - ll_t))),
                                float(np.max(np.abs(got[0] - want[0])))),
                            timing(
        "ml_pair_loglk", lambda: mk.ml_pair_loglk(*lst),
        lambda: mk.ml_pair_loglk_ref(*lst),
        n_distinct * row + 4 * P + K * (8 + 4 * P),
        K * P * (eff + site), twin_runs=10))
    one = (*store, r1[:1], r2[:1], lens[3:4])
    out["ml_pair_loglk"][1].update(
        list_k=K, one_ms=median_ms(lambda: mk.ml_pair_loglk(*one)),
        one_device_us=device_us(lambda: mk.ml_pair_loglk(*one),
                                DEVICE_NAMES["ml_pair_loglk"]))

    targets = np.arange(n_rows - 200, n_rows)
    post = (targets, r1[:200] % MAIN_N + MAIN_N, r2[:200] % MAIN_N,
            lens[:200] + 5e-4, lens[100:] + 5e-4)
    copies = []
    for fn in (mk.ml_posterior, mk.ml_posterior_ref):
        c, w, v = codes.clone(), W.clone(), V.clone()
        fn(c, w, v, m, *post)
        copies.append([t.cpu().numpy() for t in (c, w, v)])
    (c1, w1, v1), (c2, w2, v2) = copies
    np.testing.assert_array_equal(c1, c2, err_msg=f"ml_posterior {label}")
    np.testing.assert_allclose(w1, w2, rtol=0, atol=1e-6,
                               err_msg=f"ml_posterior {label} W")
    np.testing.assert_allclose(v1, v2, rtol=0, atol=1e-6,
                               err_msg=f"ml_posterior {label} V")
    c, w, v = codes.clone(), W.clone(), V.clone()
    ones = []
    for k in range(200):
        mk.ml_posterior(c, w, v, m, *(a[k:k + 1] for a in post))
        ones.append(tuple(t[targets[k]].cpu().numpy() for t in (c, w, v)))
    one_by_one(label, "ml_posterior", tuple(t[targets] for t in (c1, w1, v1)),
               ones)
    # the list: 2S posteriors into the list-pass rows (the last maxnodes
    # rows) from node and up-profile rows
    K = LIST_POSTERIORS
    lpost = (codes.clone(), W.clone(), V.clone(), m,
             n_rows - 2 * MAIN_N + np.arange(K),
             rng.integers(0, 2 * MAIN_N, K), rng.integers(0, 2 * MAIN_N, K),
             rng.uniform(5e-4, 0.5, K), rng.uniform(5e-4, 0.5, K))
    lt = lpost[4]
    copies = []
    for fn in (mk.ml_posterior, mk.ml_posterior_ref):
        c, w, v = codes.clone(), W.clone(), V.clone()
        fn(c, w, v, *lpost[3:])
        copies.append((c, w, v))
    (lc1, lw1, lv1), (lc2, lw2, lv2) = copies
    if not torch.equal(lc1, lc2):
        raise AssertionError(f"ml_posterior {label}: codes differ from the "
                             f"twin's, {K} posteriors")
    list_err = max(float((lw1 - lw2).abs().max()),
                   float((lv1 - lv2).abs().max()))
    if list_err > 1e-6:
        raise AssertionError(f"ml_posterior {label}: W or V {list_err:.3e} "
                             f"from the twin's, {K} posteriors")
    spread = np.linspace(0, K - 1, 16).astype(int)
    c, w, v = codes.clone(), W.clone(), V.clone()
    ones = []
    for k in spread:
        mk.ml_posterior(c, w, v, m, *(a[k:k + 1] for a in lpost[4:]))
        ones.append(tuple(t[lt[k]].cpu().numpy() for t in (c, w, v)))
    one_by_one(f"{label} {K} posteriors", "ml_posterior",
               tuple(t[lt[spread]].cpu().numpy() for t in (lc1, lw1, lv1)),
               ones)
    del copies, lc1, lw1, lv1, lc2, lw2, lv2, c, w, v
    n_distinct = len(np.unique(np.concatenate([lpost[5], lpost[6]])))
    # the distinct rows and the rate categories in, K rows out
    out["ml_posterior"] = (
        max(float(np.max(np.abs(w1 - w2))), float(np.max(np.abs(v1 - v2))),
            list_err),
        timing("ml_posterior", lambda: mk.ml_posterior(*lpost),
               lambda: mk.ml_posterior_ref(*lpost),
               (n_distinct + K) * row + 4 * P, K * P * post_ops,
               twin_runs=10))
    one = (codes.clone(), W.clone(), V.clone(), m, targets[:1],
           post[1][:1], post[2][:1], post[3][:1], post[4][:1])
    out["ml_posterior"][1].update(
        list_k=K, one_ms=median_ms(lambda: mk.ml_posterior(*one)),
        one_device_us=device_us(lambda: mk.ml_posterior(*one),
                                DEVICE_NAMES["ml_posterior"]))

    guesses = np.concatenate([[5e-4, 9e-4, 0.1, 5.0],
                              rng.uniform(0.01, 1.0, 12)])
    opt = (r1[:16], r2[:16], guesses, 5e-4, 6.0, 1e-3, 1e-4)
    x, fx, n_eval = (t.cpu().numpy() for t in mk.ml_opt_branch(*store, *opt))
    x_t, fx_t, _ = (t.cpu().numpy() for t in mk.ml_opt_branch_ref(*store,
                                                                    *opt))
    np.testing.assert_allclose(x, x_t, rtol=1e-4,
                               err_msg=f"ml_opt_branch {label} x")
    np.testing.assert_allclose(fx, fx_t, rtol=0, atol=1e-3,
                               err_msg=f"ml_opt_branch {label} f(x)")
    one = (*store, r1[:1], r2[:1], guesses[2:3], 5e-4, 6.0, 1e-3, 1e-4)
    n = int(mk.ml_opt_branch(*one)[2][0])      # this search's evaluations
    # two rows and the rate categories in, x, f(x) and the count out; the
    # vectors mixed once, then n evaluations
    out["ml_opt_branch"] = (
        max(float(np.max(np.abs(x - x_t))), float(np.max(np.abs(fx - fx_t)))),
        timing("ml_opt_branch", lambda: mk.ml_opt_branch(*one),
               lambda: mk.ml_opt_branch_ref(*one), 2 * row + 4 * P + 12,
               P * (eff + n * site)))
    print(f"  line searches [{label}]: {int(n_eval.min())}..{int(n_eval.max())}"
          " evaluations")
    return out


N_FAMILIES = 160
# the store rows a twin or the chain of single calls uses for the quartet's
# temporaries: scratch rows 0-5 of the N=2000 layout (2 * maxnodes + k)
SCRATCH_ROWS = [4 * MAIN_N + k for k in range(6)]
# xmin, xmax, ftol, atol of the float32 line searches (options.py)
QUARTET_LIMS = (5.0e-4, 6.0, 1.0e-3, 1.0e-4)


def quartet_store(model, gen, dev):
    """ml_store_case's store (4 codes) whose leaf rows 4q .. 4q + 3, for q
    below N_FAMILIES, are copies of random rows X_q, X_q, Y_q, Y_q with 3%
    of their positions mutated and 5% gaps: (4q, 4q+1 | 4q+2, 4q+3) is a
    clear split, and (4q, 4q+2 | 4q+1, 4q+3) a wrong one."""
    import torch

    codes, W, V, m = ml_store_case(4, model, gen, dev)
    P = codes.shape[1]
    base = torch.randint(0, 4, (N_FAMILIES, 2, P), generator=gen, device=dev,
                         dtype=torch.int8)
    fam = base[:, [0, 0, 1, 1]].reshape(4 * N_FAMILIES, P).clone()
    mut = torch.rand(fam.shape, generator=gen, device=dev) < 0.03
    fam[mut] = torch.randint(0, 4, (int(mut.sum()),), generator=gen,
                             device=dev, dtype=torch.int8)
    fam[torch.rand(fam.shape, generator=gen, device=dev) < 0.05] = 127
    fam[:, m.n_pos:] = 127
    k = 4 * N_FAMILIES
    codes[:k] = fam
    W[:k] = (fam != 127).float()
    V[:k] = m.code_freq[fam.long()]
    return codes, W, V, m


def check_quartets(model, gen, dev):
    """ml_quartet_opt on 200 quartets of one store (100 clear splits, 60
    wrong ones, 40 of random rows), with the star test and with per-site
    likelihoods: bit for bit the chain of single-call kernels, K=1
    launches equal to the K=200 launch, the twin on 24 of them (8 of each
    kind) within the tolerances of the module's docstring.  Then the SH
    pass's list (quartet_list).  The time is that of one quartet with the
    star test that does not end at it, as an ML NNI's first call; the
    chain's times are given beside it.  Returns (err, timing)."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    codes, W, V, m = quartet_store(model, gen, dev)
    store = (codes, W, V, m)
    P = codes.shape[1]
    rng = np.random.default_rng(11 + len(model))
    fam = 4 * np.arange(N_FAMILIES)[:, None]
    rows4 = np.concatenate([
        fam[:100] + [0, 1, 2, 3], fam[100:] + [0, 2, 1, 3],
        rng.integers(4 * N_FAMILIES, 4 * MAIN_N, (40, 4))]).astype(np.int32)
    lens = np.maximum(rng.uniform(0.0, 0.3, (len(rows4), 5)),
                      QUARTET_LIMS[0])
    lims = (SCRATCH_ROWS, *QUARTET_LIMS)
    chain_fns = (mk.ml_posterior, mk.ml_opt_branch, mk.ml_pair_loglk)
    pick = np.r_[0:8, 100:108, 160:168]         # the twin's quartets
    err = 0.0
    for star_test, site in ((True, False), (False, True)):
        tag = f"{model} {'star test' if star_test else 'per-site'}"
        args = (*store, rows4, lens, *lims, star_test, site)
        rec, lk = mk.ml_quartet_opt(*args)
        rec_c, lk_c = mk.quartet_chain(*chain_fns, *args)
        if rec.tobytes() != rec_c.tobytes() \
                or (site and lk.tobytes() != lk_c.tobytes()):
            raise AssertionError(f"ml_quartet_opt {tag}: differs from the "
                                 "chain of single-call kernels")
        for k in range(3):
            one = mk.ml_quartet_opt(*store, rows4[k:k + 1], lens[k:k + 1],
                                    *lims, star_test, site)
            if one[0].tobytes() != rec[k:k + 1].tobytes():
                raise AssertionError(f"ml_quartet_opt {tag}: quartet {k} "
                                     "alone differs from the K=200 launch")
        rec_t, lk_t = mk.ml_quartet_opt_ref(*store, rows4[pick], lens[pick],
                                            *lims, star_test, site)
        got = rec[pick]
        ll = lambda r: r["parts"][:, 0] + r["parts"][:, 1] + r["parts"][:, 2]  # noqa: E731
        len_err = np.abs(got["len"] - rec_t["len"])
        ll_err = float(np.max(np.abs(ll(got) - ll(rec_t))))
        ll_rel = float(np.max(np.abs(ll(got) - ll(rec_t)) / np.abs(ll(rec_t))))
        print(f"  ml_quartet_opt [{tag}] against the twin on {len(pick)}: "
              f"stars {int(got['star'].sum())} / {int(rec_t['star'].sum())}, "
              f"lengths max abs err {float(len_err.max()):.3e} (max rel "
              f"{float(np.max(len_err / rec_t['len'])):.3e}), quartet "
              f"LogLk max abs err {ll_err:.3e} (max rel {ll_rel:.3e})")
        np.testing.assert_array_equal(got["star"], rec_t["star"],
                                      err_msg=f"ml_quartet_opt {tag} star")
        np.testing.assert_allclose(got["len"], rec_t["len"], rtol=2e-2,
                                   atol=2e-3,
                                   err_msg=f"ml_quartet_opt {tag} lengths")
        if ll_rel > 1e-4:
            raise AssertionError(f"ml_quartet_opt {tag}: quartet LogLk "
                                 f"{ll_rel:.3e} relative from the twin's")
        if site:
            np.testing.assert_allclose(lk[pick], lk_t, rtol=5e-2,
                                       atol=1e-30,
                                       err_msg=f"ml_quartet_opt {tag} lk")
        err = max(err, ll_err, float(len_err.max()))
        stars = int(rec["star"].sum())
        print(f"  ml_quartet_opt [{tag}]: {len(rows4)} quartets bit for bit "
              f"the chain's, {stars} star tests fired, "
              f"{int(rec['n_eval'].sum())} line-search evaluations")
        if star_test and not 0 < stars < len(rows4):
            raise AssertionError(f"ml_quartet_opt {tag}: the star test fired "
                                 f"{stars} times of {len(rows4)}")
        if star_test:
            first = int(np.flatnonzero(rec["star"] == 0)[0])
            n_eval = int(rec["n_eval"][first])

    err = max(err, quartet_list(model, store, rng))
    one = (*store, rows4[first:first + 1], lens[first:first + 1], *lims,
           True, False)
    row = ml_row_bytes(P, 4)
    eff, site_ops, post_ops = ml_ops(4, model == "jc")
    # four rows and the rate categories in, one record out; seven
    # posteriors, five line searches (their vectors mixed once each, then
    # this quartet's evaluations), three pair likelihoods (star and two
    # closing ones)
    times = timing("ml_quartet_opt", lambda: mk.ml_quartet_opt(*one),
                   lambda: mk.ml_quartet_opt_ref(*one), 4 * row + 4 * P + 64,
                   P * (7 * post_ops + 5 * eff + n_eval * site_ops
                        + 3 * (eff + site_ops)), twin_runs=10)
    times["chain_ms"] = median_ms(lambda: mk.quartet_chain(*chain_fns, *one))
    times["chain_device_us"] = device_us(
        lambda: mk.quartet_chain(*chain_fns, *one),
        [n for k in ("ml_posterior", "ml_opt_branch", "ml_pair_loglk")
         for n in DEVICE_NAMES[k]])
    print(f"  ml_quartet_opt [{model}]: one quartet ({n_eval} evaluations) "
          f"{times['ms']:.4f} ms launch to launch, {times['device_us']:.3f} "
          f"us on the device; the chain of single calls "
          f"{times['chain_ms']:.4f} ms, {times['chain_device_us']:.3f} us "
          "on the device")
    return err, times


def quartet_list(model, store, rng):
    """ml_quartet_opt on the SH pass's list at N=MAIN_N: 2S quartets with
    per-site likelihoods and no star test (the first 160 the families of
    quartet_store, the rest of random rows), bit for bit the chain of
    single-call kernels, and the twin on 24 spread over the list within
    check_quartets' tolerances.  Prints the launch's launch-to-launch
    time.  Returns the largest difference from the twin."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    K = 2 * SH_SPLITS
    fam = 4 * np.arange(N_FAMILIES)[:, None]
    rows4 = np.concatenate([
        fam[:100] + [0, 1, 2, 3], fam[100:] + [0, 2, 1, 3],
        rng.integers(4 * N_FAMILIES, 4 * MAIN_N, (K - N_FAMILIES, 4))]) \
        .astype(np.int32)
    lens = np.maximum(rng.uniform(0.0, 0.3, (K, 5)), QUARTET_LIMS[0])
    args = (*store, rows4, lens, SCRATCH_ROWS, *QUARTET_LIMS, False, True)
    tag = f"{model}, the SH list of {K}"
    rec, lk = mk.ml_quartet_opt(*args)
    rec_c, lk_c = mk.quartet_chain(mk.ml_posterior, mk.ml_opt_branch,
                                   mk.ml_pair_loglk, *args)
    if rec.tobytes() != rec_c.tobytes() or lk.tobytes() != lk_c.tobytes():
        bad = np.flatnonzero(
            (rec.view(np.uint8).reshape(K, -1)
             != rec_c.view(np.uint8).reshape(K, -1)).any(1)
            | (lk.view(np.uint32) != lk_c.view(np.uint32))
            .reshape(K, -1).any(1))
        raise AssertionError(f"ml_quartet_opt [{tag}]: {len(bad)} quartets "
                             f"differ from the chain of single-call kernels, "
                             f"first {bad[:5].tolist()}")
    pick = np.linspace(0, K - 1, 24).astype(int)
    rec_t, lk_t = mk.ml_quartet_opt_ref(*store, rows4[pick], lens[pick],
                                        *args[6:])
    got = rec[pick]
    ll = lambda r: r["parts"][:, 0] + r["parts"][:, 1] + r["parts"][:, 2]  # noqa: E731
    len_err = np.abs(got["len"] - rec_t["len"])
    ll_err = float(np.max(np.abs(ll(got) - ll(rec_t))))
    ll_rel = float(np.max(np.abs(ll(got) - ll(rec_t)) / np.abs(ll(rec_t))))
    np.testing.assert_allclose(got["len"], rec_t["len"], rtol=2e-2, atol=2e-3,
                               err_msg=f"ml_quartet_opt [{tag}] lengths")
    if ll_rel > 1e-4:
        raise AssertionError(f"ml_quartet_opt [{tag}]: quartet LogLk "
                             f"{ll_rel:.3e} relative from the twin's")
    np.testing.assert_allclose(lk[pick], lk_t, rtol=5e-2, atol=1e-30,
                               err_msg=f"ml_quartet_opt [{tag}] lk")
    # launch to launch only: a torch.profiler trace of this launch left the
    # traces after it short of launches (device_us)
    ms = median_ms(lambda: mk.ml_quartet_opt(*args), runs=5)
    print(f"  ml_quartet_opt [{tag}]: bit for bit the chain's "
          f"({int(rec['n_eval'].sum())} line-search evaluations); the twin "
          f"on {len(pick)}: lengths max abs err {float(len_err.max()):.3e}, "
          f"quartet LogLk max abs err {ll_err:.3e} (max rel {ll_rel:.3e}); "
          f"{ms:.4f} ms launch to launch")
    return max(ll_err, float(len_err.max()))


def phase_kernels(report):
    import torch

    from veryfasttree_tpu_torch.ops import scan_kernels as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [
        ("nj_scan_dense", "M=8192 P*C=2048 %different", sk.nj_scan_dense,
         sk.nj_scan_ref, dense_case(4, False, gen, dev)),
        ("nj_scan_dense", "M=8192 P*C=10240 BLOSUM45", sk.nj_scan_dense,
         sk.nj_scan_ref, dense_case(20, True, gen, dev)),
        ("nj_scan_codes", "L=20000 P=512 C=4 %different", sk.nj_scan_codes,
         sk.nj_scan_codes_ref, codes_case(4, False, gen, dev)),
        ("nj_scan_codes", "L=20000 P=512 C=20 BLOSUM45", sk.nj_scan_codes,
         sk.nj_scan_codes_ref, codes_case(20, True, gen, dev)),
    ]
    def record(name, label, err, times):
        lst = (f" (a list of {times['list_k']}; one item alone "
               f"{times['one_ms']:.4f} ms, {times['one_device_us']:.3f} us)"
               if "list_k" in times else "")
        print(f"  {name} [{label}]: max abs err {err:.3e}, kernel "
              f"{times['ms']:.4f} ms launch to launch, "
              f"{times['device_us']:.3f} us on the device, twin "
              f"{times['plain_ms']:.4f} ms, bound {times['bound_ms']:.3e} ms "
              f"({times['bound_by']}){lst}")
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if "ms" not in entry:         # the first case is the main path's shape
            entry.update(times)

    for name, shape, kernel, twin, args in cases:
        best, err, times = check_kernel(name, kernel, twin, args)
        record(name, f"{shape}, best {best}: the tie's lowest index", err,
               times)
    for name, check in (("me_dists", check_dists),
                        ("me_average", check_average)):
        for C, use_matrix, leaf_rows, label in (
                (4, False, 0, "dense 8192x512 C=4"),
                (4, False, 2000, "two-tier 2000 leaves C=4"),
                (20, True, 0, "dense 8192x512 C=20 BLOSUM45")):
            record(name, label, *check(label, C, use_matrix, leaf_rows, gen,
                                       dev))
    for C, model, label in ((4, "jc", "12008x512 C=4 JC"),
                            (4, "gtr", "12008x512 C=4 GTR"),
                            (20, "jtt", "12008x512 C=20 JTT")):
        for name, (err, times) in check_ml(label, C, model, gen, dev).items():
            record(name, label, err, times)
    for model in ("jc", "gtr"):
        err, times = check_quartets(model, gen, dev)
        record("ml_quartet_opt", f"12008x512 C=4 {model.upper()}", err, times)


# ------------------------------------------------------------- phase 2b
SPR_N = 500
SPR_COUNTERS = ("n_spr", "profile_ops", "profile_avg_ops")


def spr_start(n, dev, two_tier=False, protein=False):
    """The port's NJ tree and ME store of synth_codes(n, MAIN_P) on dev: the
    start of an SPR round.  protein: 20 codes under BLOSUM45 (matrix mode),
    as a protein -noml run."""
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.models import DistanceMatrix
    from veryfasttree_tpu_torch.options import Options

    opts = Options(n_codes=20 if protein else 4, ml_nni=0, n_bootstrap=0,
                   show_progress=False,
                   **({"two_tier_min": 0} if two_tier else {}))
    opts.derive_settings()
    nj = NeighbourJoining(opts, synth_codes(n, MAIN_P, n_codes=opts.n_codes),
                          DistanceMatrix.blosum45() if protein else None,
                          None, device=dev)
    nj.fast_nj()
    return nj


def engine_copy(nj, dev):
    """nj with a tree, counters and ME store of its own, on dev: another
    run of a round from the same start."""
    import copy

    import torch

    c = copy.copy(nj)
    c.tree, c.debug = copy.deepcopy(nj.tree), copy.deepcopy(nj.debug)
    c.prof = copy.copy(nj.prof)
    c.prof.device = torch.device(dev)
    for name in ("codes", "W", "U", "code_freq", "eigenval", "eigentot",
                 "w_out", "f_out"):
        t = getattr(nj.prof, name)
        setattr(c.prof, name, None if t is None else t.to(dev, copy=True))
    return c


def spr_state(nj, counters=SPR_COUNTERS):
    """What a round leaves behind: the tree arrays, the counters, and the
    node rows (codes, and W, U of the float rows among them)."""
    m, lo = nj.tree.maxnode, nj.prof._leaf_rows
    return ({k: getattr(nj.tree, k).copy()
             for k in ("parent", "children", "n_child")},
            {k: getattr(nj.debug, k) for k in counters},
            {"codes": nj.prof.codes[:m].cpu().numpy(),
             "W": nj.prof.W[: m - lo].cpu().numpy(),
             "U": nj.prof.U[: m - lo].cpu().numpy()})


def spr_diff(a, b):
    """(what differs between two rounds' states, or None; the rows' max
    abs difference, or None where the trees or counters differ)."""
    import numpy as np

    (tree_a, ctr_a, rows_a), (tree_b, ctr_b, rows_b) = a, b
    for k in tree_a:
        if not np.array_equal(tree_a[k], tree_b[k]):
            return f"tree {k}", None
    if ctr_a != ctr_b:
        return f"counters {ctr_a} and {ctr_b}", None
    if not np.array_equal(rows_a["codes"], rows_b["codes"]):
        return "codes", None
    err = max(float(np.max(np.abs(rows_a[k] - rows_b[k]))) for k in "WU")
    return (None if err == 0 else "rows"), err


def spr_ops(totals, P, C):
    """Operations of the SPR or NNI rounds that made `totals` (the kernel's
    counters), as me_dists and me_average count theirs: six pair distances
    per corrected quartet, one average per averaged row."""
    return (6 * P * (2 * C + 2) * totals["quartets"]
            + P * (4 * C + 6) * totals["rows_averaged"])


def record_rows(prof):
    """Have the store's calls note the rows a round reads before it writes
    them and the rows it writes: returns those two sets, filled as the
    round runs."""
    inputs, outputs = set(), set()
    dists, average = prof._dists, prof._average_into

    def read(*row_lists):
        for rows in row_lists:
            inputs.update(int(r) for r in rows if int(r) not in outputs)

    def _dists(q_rows=(), query=None, iis=(), jjs=()):
        read(q_rows, iis, jjs)
        return dists(q_rows, query, iis, jjs)

    def _average_into(targets, iis, jjs, bw):
        read(iis, jjs)
        outputs.update(int(t) for t in targets)
        return average(targets, iis, jjs, bw)

    prof._dists, prof._average_into = _dists, _average_into
    return inputs, outputs


def phase_spr(report, dev):
    """One SPR round at N=SPR_N from one NJ start, dense, two-tier and
    protein, through one launch of the kernel (ops/spr_kernels.spr_round)
    and through the host loop with the per-call kernels (engine/spr.run_spr):
    tree, counters and node rows bit for bit.  Dense, also through the
    kernel with its tree in device memory, and through the plain twin (the
    host loop on the per-call twins, on a CPU copy of the start): the same
    tree and counters, rows within 1e-6 (its pair distances are summed in
    another order, 1e-12 apart; its averages round as the kernel's).  The
    kernel's device time comes from torch.profiler over three more rounds,
    each from a copy of the start (a trace of one round can lose its
    event), in all, per node and per chain step (corrected quartet); ms and
    plain_ms are the kernel's and the twin's round walls (a round is one
    launch).  The bound counts each row the round reads before writing it
    read once and each row it writes written once (the host loop's store
    calls, recorded), and the operations of the kernel's counted work."""
    import torch

    from veryfasttree_tpu_torch.engine import spr
    from veryfasttree_tpu_torch.ops import spr_kernels

    cpu = torch.device("cpu")
    kern = spr_kernels.spr_round
    entry = report.setdefault("me_spr_round", {"max_abs_err": 0.0})
    for label, kw in (("dense", {}), ("two-tier", {"two_tier": True}),
                      ("protein", {"protein": True})):
        label = f"N={SPR_N} {label}"
        start = spr_start(SPR_N, dev, **kw)
        dense = not kw
        runs = {}
        for name, fn, where in (
                ("kernel", kern, dev), ("host loop", spr.run_spr, dev),
                ("tree in device memory",
                 lambda nj, i, n: kern(nj, i, n, tree_in_smem=False), dev),
                ("twin", kern, cpu)):
            if name in ("tree in device memory", "twin") and not dense:
                continue
            nj = engine_copy(start, where)
            if name == "host loop":
                rows_in, rows_out = record_rows(nj.prof)
            reset_launches()
            threads = torch.get_num_threads()
            torch.set_num_threads(1)     # the twin's tiny ops only contend
            t0 = time.perf_counter()
            fn(nj, 0, 2)
            torch.cuda.synchronize()
            runs[name] = (spr_state(nj), time.perf_counter() - t0)
            torch.set_num_threads(threads)
            if name == "kernel":
                stats = dict(kern.totals, launches=kern.launches)
        (state, wall) = runs["kernel"]
        for name in ("host loop", "tree in device memory"):
            if name in runs and spr_diff(runs[name][0], state)[0] is not None:
                raise AssertionError(f"me_spr_round {label}: "
                                     f"{spr_diff(runs[name][0], state)[0]} "
                                     f"differ between the kernel and the "
                                     f"{name}")
        n_launch, n_nodes = stats["launches"], stats["nodes"]
        if n_launch != 1:
            raise AssertionError(f"me_spr_round {label}: {n_launch} launches "
                                 "for one round")
        print(f"  me_spr_round [{label}]: bit for bit the host loop's"
              f"{' and the device-memory tree' * dense}; {n_nodes} nodes in "
              f"one launch, {wall:.3f} s (the host loop with the per-call "
              f"kernels {runs['host loop'][1]:.3f} s); counters {state[1]}, "
              f"{stats['quartets']} quartets, {stats['rows_averaged']} rows "
              "averaged")
        if not dense:
            continue
        what, err = spr_diff(state, runs["twin"][0])
        if what not in (None, "rows") or err > 1e-6:
            raise AssertionError(f"me_spr_round {label}: {what} differ from "
                                 f"the twin's (rows {err})")
        dev_us = device_us(lambda: kern(engine_copy(start, dev), 0, 2),
                           DEVICE_NAMES["me_spr_round"], runs=3)
        P, C = start.prof.W.shape[1], start.prof.U.shape[2]
        # a dense store's rows are float rows: U, W and codes
        n_bytes = (len(rows_in) + len(rows_out)) * P * (4 * C + 5)
        n_ops = spr_ops(stats, P, C)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        entry.update({
            "max_abs_err": err, "ms": 1e3 * wall,
            "plain_ms": 1e3 * runs["twin"][1],
            "host_loop_ms": 1e3 * runs["host loop"][1],
            "tree_in_device_memory_ms":
                1e3 * runs["tree in device memory"][1],
            "device_us": dev_us,
            "device_us_per_step": dev_us / stats["quartets"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"  me_spr_round [{label}]: the twin on the CPU "
              f"{runs['twin'][1]:.3f} s, rows max abs err {err:.3e}; the "
              "tree in device memory "
              f"{runs['tree in device memory'][1]:.3f} s; device "
              f"{dev_us / 1e3:.3f} ms for the round ({dev_us / n_nodes:.3f} "
              f"us per node, {dev_us / stats['quartets']:.3f} us per chain "
              f"step); {len(rows_in)} rows read, {len(rows_out)} "
              f"written, {n_ops:.4e} operations: bound {bound_ms:.4e} ms "
              f"({bound_by}; bytes {1e3 * n_bytes / HBM_BYTES_PER_S:.4e} ms, "
              f"operations {1e3 * n_ops / F32_OPS_PER_S:.4e} ms)")


# ------------------------------------------------------------- phase 2c
NNI_COUNTERS = ("n_nni", "profile_ops", "profile_avg_ops")
NNI_STATS = ("age", "subtree_age", "delta", "support")
# the NNI round kernel's deltas and supports (and max_delta) against the
# host loop's: differences of sums of log-corrected distances, whose log1p
# the card and numpy may round differently in the last bit (a criterion is
# at most 6, an ulp of it 8.9e-16); everything else is bit for bit
NNI_DELTA_ATOL = 1e-13


def nni_state(nj, stats, result):
    """What an NNI round leaves behind: spr_state's, the NNIStats beside
    the tree arrays, and the round's (n_nni, max_delta) beside the
    counters."""
    tree, ctr, rows = spr_state(nj, NNI_COUNTERS)
    tree.update({k: getattr(stats, k).copy() for k in NNI_STATS})
    ctr["n_nni_round"], ctr["max_delta"] = int(result[0]), float(result[1])
    return tree, ctr, rows


def nni_diff(a, b):
    """(what differs between two NNI rounds' states apart from the deltas,
    supports and max_delta, or None; the rows' max abs difference; the
    deltas', supports' and max_delta's max abs difference)."""
    import numpy as np

    def split(state):
        tree, ctr, rows = state
        return ({k: v for k, v in tree.items() if k not in ("delta", "support")},
                {k: v for k, v in ctr.items() if k != "max_delta"}, rows)

    (ta, ca, _), (tb, cb, _) = a, b
    gap = max([float(np.max(np.abs(ta[k] - tb[k])))
               for k in ("delta", "support")]
              + [abs(ca["max_delta"] - cb["max_delta"])])
    return (*spr_diff(split(a), split(b)), gap)


def phase_nni(report, dev):
    """One ME NNI round at N=SPR_N from one NJ start, dense, two-tier and
    protein, through one launch of the kernel (ops/nni_kernels.nni_round)
    and through the host loop with the per-call kernels
    (engine/rearrange.do_nni): tree, NNIStats ages, counters and node rows
    bit for bit, the deltas and supports within NNI_DELTA_ATOL.  Dense, also through the kernel with its tree in device memory,
    and through the plain twin (the host loop on the per-call twins, on a
    CPU copy of the start): the same tree, ages and counters, rows within
    1e-6 and deltas and supports within 1e-9 (its pair distances are summed
    in another order, 1e-12 apart).  The kernel's device time comes from
    torch.profiler over ten more rounds, each from a copy of the start (a
    trace of one short round lost its event); ms and plain_ms are the
    kernel's and the twin's round walls (a round is one launch),
    host_loop_ms the host loop's.  The bound counts each row the round reads before writing it
    read once and each row it writes written once (the host loop's store
    calls, recorded), and the operations of the kernel's counted work; per
    quartet it is the round's divided by its quartets."""
    import torch

    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.ops import nni_kernels

    cpu = torch.device("cpu")
    kern = nni_kernels.nni_round
    entry = report.setdefault("me_nni_round", {"max_abs_err": 0.0})
    for label, kw in (("dense", {}), ("two-tier", {"two_tier": True}),
                      ("protein", {"protein": True})):
        label = f"N={SPR_N} {label}"
        start = spr_start(SPR_N, dev, **kw)
        dense = not kw
        runs = {}
        for name, fn, where in (
                ("kernel", kern, dev),
                ("host loop", lambda nj, i, n, st:
                 rearrange.do_nni(nj, i, n, False, st), dev),
                ("tree in device memory", lambda nj, i, n, st:
                 kern(nj, i, n, st, tree_in_smem=False), dev),
                ("twin", kern, cpu)):
            if name in ("tree in device memory", "twin") and not dense:
                continue
            nj = engine_copy(start, where)
            stats = rearrange.NNIStats.init(nj)
            if name == "host loop":
                rows_in, rows_out = record_rows(nj.prof)
            reset_launches()
            threads = torch.get_num_threads()
            torch.set_num_threads(1)     # the twin's tiny ops only contend
            t0 = time.perf_counter()
            result = fn(nj, 0, 2, stats)
            torch.cuda.synchronize()
            runs[name] = (nni_state(nj, stats, result),
                          time.perf_counter() - t0)
            torch.set_num_threads(threads)
            if name == "kernel":
                totals = dict(kern.totals, launches=kern.launches)
        state, wall = runs["kernel"]
        for name in ("host loop", "tree in device memory"):
            if name not in runs:
                continue
            what, err, gap = nni_diff(runs[name][0], state)
            if what is not None or gap > NNI_DELTA_ATOL:
                raise AssertionError(
                    f"me_nni_round {label}: {what or 'deltas or supports'} "
                    f"differ between the kernel and the {name} (rows "
                    f"{err}, deltas and supports {gap})")
        if totals["launches"] != 1:
            raise AssertionError(f"me_nni_round {label}: "
                                 f"{totals['launches']} launches for one round")
        n_q = totals["quartets"]
        gap = nni_diff(runs["host loop"][0], state)[2]
        print(f"  me_nni_round [{label}]: bit for bit the host loop's"
              f"{' and the device-memory tree' * dense} (deltas and supports "
              f"within {gap:.3e}); one launch, "
              f"{wall:.3f} s (the host loop with the per-call kernels "
              f"{runs['host loop'][1]:.3f} s); counters {state[1]}, {n_q} "
              f"quartets, {totals['rows_averaged']} rows averaged")
        if not dense:
            continue
        what, err, gap = nni_diff(state, runs["twin"][0])
        if what not in (None, "rows") or err > 1e-6 or gap > 1e-9:
            raise AssertionError(f"me_nni_round {label}: {what} differ from "
                                 f"the twin's (rows {err}, deltas and "
                                 f"supports {gap})")

        def one_round():
            nj = engine_copy(start, dev)
            kern(nj, 0, 2, rearrange.NNIStats.init(nj))

        dev_us = device_us(one_round, DEVICE_NAMES["me_nni_round"], runs=10)
        P, C = start.prof.W.shape[1], start.prof.U.shape[2]
        # a dense store's rows are float rows: U, W and codes
        n_bytes = (len(rows_in) + len(rows_out)) * P * (4 * C + 5)
        n_ops = spr_ops(totals, P, C)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        entry.update({
            "max_abs_err": err, "ms": 1e3 * wall,
            "plain_ms": 1e3 * runs["twin"][1],
            "host_loop_ms": 1e3 * runs["host loop"][1],
            "tree_in_device_memory_ms":
                1e3 * runs["tree in device memory"][1],
            "device_us": dev_us, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        print(f"  me_nni_round [{label}]: the twin on the CPU "
              f"{runs['twin'][1]:.3f} s, rows max abs err {err:.3e}, deltas "
              f"and supports {gap:.3e}; the tree in device memory "
              f"{runs['tree in device memory'][1]:.3f} s; device "
              f"{dev_us / 1e3:.3f} ms for the round; per quartet "
              f"{dev_us / n_q:.3f} us on the device, "
              f"{totals['rows_averaged'] / n_q:.3f} rows averaged, bound "
              f"{1e3 * bound_ms / n_q:.4e} us; {len(rows_in)} rows read, "
              f"{len(rows_out)} written, {n_ops:.4e} operations: bound "
              f"{bound_ms:.4e} ms ({bound_by}; bytes "
              f"{1e3 * n_bytes / HBM_BYTES_PER_S:.4e} ms, operations "
              f"{1e3 * n_ops / F32_OPS_PER_S:.4e} ms)")


# ------------------------------------------------------------- phase 2d
# the plain twin's values against the kernel's: the twin sums its distances
# in other orders, and divides the out-profile weights by n_active - 1 where
# PyTorch's CUDA kernel (which the kernel repeats) multiplies by the
# reciprocal, a float32 ulp apart that the out-distances sum over every
# active row (6.2e-6 measured at N=500)
EPOCH_TWIN_ATOL = 1e-4
EPOCH_DEBUG = ("outprofile_ops", "profile_ops", "seq_ops", "profile_avg_ops",
               "n_hill_better", "n_visible_update", "n_refresh_tophits")


def epoch_run(n, dev, kernel=True, max_joins=None, two_tier=False,
              protein=False, bionj=False, **launch):
    """The port's NJ phase (fast_nj) on synth_codes(n, MAIN_P) on dev, its
    joins through the epoch kernel (launch: grid, state_in_smem and
    lists_in_smem of ops/epoch_kernels.join_epoch) or, kernel=False,
    through the host loop with the per-call kernels.  protein: 20 codes
    under BLOSUM45 (matrix mode)."""
    import torch

    from veryfasttree_tpu_torch.engine import epoch
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.models import DistanceMatrix
    from veryfasttree_tpu_torch.options import Options

    opts = Options(n_codes=20 if protein else 4, ml_nni=0, n_bootstrap=0,
                   show_progress=False, bionj=bionj,
                   **({"two_tier_min": 0} if two_tier else {}))
    opts.derive_settings()
    nj = NeighbourJoining(opts, synth_codes(n, MAIN_P, n_codes=opts.n_codes),
                          DistanceMatrix.blosum45() if protein else None,
                          None, device=dev)
    supported, run = epoch.epoch_supported, epoch.run_epoch
    if not kernel:
        epoch.epoch_supported = lambda nj_, tophits: False
    elif launch:
        epoch.run_epoch = lambda nj_, tophits, mj=None: run(
            nj_, tophits, mj, **launch)
    try:
        nj.fast_nj(max_joins)
        torch.cuda.synchronize()
    finally:
        epoch.epoch_supported, epoch.run_epoch = supported, run
    return nj


def epoch_state(nj):
    """What the NJ phase leaves behind: the join log and tree, the per-node
    arrays, the store rows and out-profile, the top-hits lists, visible and
    top-visible sets and ages, and the debug counters."""
    import numpy as np

    tree, prof, th = nj.tree, nj.prof, nj._tophits
    hits_j, hits_d = th.pack_state()
    m, lo = tree.maxnode, prof._leaf_rows
    return {
        "join_log": np.array(nj.join_log), "parent": tree.parent.copy(),
        "children": tree.children.copy(),
        "branchlength": tree.branchlength.copy(),
        "diameter": nj.diameter.copy(), "var_diameter": nj.var_diameter.copy(),
        "selfdist": nj.selfdist.copy(), "selfweight": nj.selfweight.copy(),
        "out_distances": nj.out_distances.copy(),
        "n_out_dist_active": nj.n_out_dist_active.copy(),
        "totdiam": np.array([nj.totdiam]),
        "codes": prof.codes[:m].cpu().numpy(),
        "W": prof.W[: m - lo].cpu().numpy(),
        "U": prof.U[: m - lo].cpu().numpy(),
        "w_out": prof.w_out.cpu().numpy(), "f_out": prof.f_out.cpu().numpy(),
        "hits_j": hits_j, "hits_dist": hits_d,
        "visible_j": th.visible_j.copy(),
        "visible_dist": th.visible_dist.copy(),
        "topvisible": th.topvisible.copy(),
        "topvisible_age": np.array([th.topvisible_age]), "age": th.age.copy(),
        "debug": np.array([getattr(nj.debug, k) for k in EPOCH_DEBUG])}


def epoch_diff(a, b):
    """The names of the arrays that differ between two NJ phases' states."""
    import numpy as np

    return [k for k in a if a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


def epoch_bound(nj, totals):
    """(bytes, operations) of the epoch launches that made `totals` (the
    kernel's counts): each join's two rows read and new row written once,
    every row a refresh scan reads, and the operations of the distances
    (2(C+1) per position of each pair, out-profile distance and scanned
    row) and averages (4C+6 per position)."""
    P, C = nj.prof.W.shape[1], nj.prof.U.shape[2]
    joins = totals["joins"]
    n_dists = (totals["profile_ops"] + totals["seq_ops"]
               + totals["outprofile_ops"])
    n_bytes = (3 * joins + totals["scan_rows"]) * P * (4 * C + 5)
    return n_bytes, P * (2 * (C + 1) * n_dists + (4 * C + 6) * joins)


def phase_epoch(report, dev):
    """The NJ phase at N=SPR_N, dense, two-tier and protein, and at N=MAIN_N
    dense, the decisions' per-node arrays in shared memory and in device
    memory (their layout past N of about 2,300): its joins through the
    epoch kernel (ops/epoch_kernels.join_epoch, one launch per out-profile
    reset) and through the host loop with the per-call kernels (one run per
    input), every array of epoch_state bit for bit.  Dense at
    N=SPR_N also through the plain twin (the host loop on the per-call
    twins, on the CPU): the same join log, the values within
    EPOCH_TWIN_ATOL (its counters, which a last-bit difference can move,
    are printed beside the kernel's).  Walls are the join
    phase's (nj.timings joins_s, _root_three included); the kernel's device
    time, in all and per join, comes from torch.profiler over one more join
    phase of each dense case; the bound from epoch_bound."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.ops import epoch_kernels

    kern = epoch_kernels.join_epoch
    entry = report.setdefault("nj_join_epoch", {"max_abs_err": 0.0})
    cases = ((f"N={SPR_N} dense", SPR_N, {}, {}),
             (f"N={SPR_N} two-tier", SPR_N, {"two_tier": True}, {}),
             (f"N={SPR_N} protein", SPR_N, {"protein": True}, {}),
             (f"N={MAIN_N} dense", MAIN_N, {}, {}),
             (f"N={MAIN_N} dense, per-node arrays in device memory", MAIN_N,
              {}, {"state_in_smem": False}))
    hosts = {}
    for label, n, kw, launch in cases:
        key = (n, tuple(sorted(kw.items())))
        if key not in hosts:
            hosts[key] = epoch_run(n, dev, kernel=False, **kw)
        host = hosts[key]
        reset_launches()
        nj = epoch_run(n, dev, **kw, **launch)
        stats = dict(kern.totals, launches=kern.launches)
        diff = epoch_diff(epoch_state(host), epoch_state(nj))
        if diff:
            raise AssertionError(f"nj_join_epoch {label}: {diff} differ "
                                 "between the kernel and the host loop")
        wall, host_wall = nj.timings["joins_s"], host.timings["joins_s"]
        joins = stats["joins"]
        print(f"  nj_join_epoch [{label}]: bit for bit the host loop's; "
              f"{joins} joins in {stats['launches']} launches "
              f"({stats['resets']} out-profile resets), {wall:.3f} s (the "
              f"host loop with the per-call kernels {host_wall:.3f} s); "
              f"{stats['phases']} phases ({stats['phases'] / joins:.2f} per "
              f"join), {stats['scans']} refresh scans of {stats['scan_rows']} "
              f"rows, grid {stats['grid']} blocks")
        if kw:
            continue
        dev_us = device_us(lambda: epoch_run(n, dev, **launch),
                           DEVICE_NAMES["nj_join_epoch"], runs=1)
        n_bytes, n_ops = epoch_bound(nj, stats)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"  nj_join_epoch [{label}]: device {dev_us / 1e3:.3f} ms "
              f"({dev_us / joins:.3f} us per join, "
              f"{dev_us / stats['launches'] / 1e3:.3f} ms per launch); "
              f"{n_bytes / 1e6:.2f} MB, {n_ops:.4e} operations: bound "
              f"{bound_ms:.4e} ms ({bound_by})")
        if n == MAIN_N and launch:
            entry.update({"main_state_in_device_memory_ms": 1e3 * wall,
                          "main_state_in_device_memory_device_us": dev_us})
            continue
        if n == MAIN_N:
            entry.update({"main_ms": 1e3 * wall,
                          "main_host_loop_ms": 1e3 * host_wall,
                          "main_device_us": dev_us,
                          "main_device_us_per_join": dev_us / joins})
            continue
        threads = torch.get_num_threads()
        torch.set_num_threads(1)         # the twin's tiny ops only contend
        cpu = epoch_run(n, torch.device("cpu"), **kw)
        torch.set_num_threads(threads)
        a, b = epoch_state(cpu), epoch_state(nj)
        if not np.array_equal(a["join_log"], b["join_log"]):
            raise AssertionError(f"nj_join_epoch {label}: the join log "
                                 "differs from the twin's")
        err = max(float(np.max(np.abs(a[k] - b[k])))
                  for k in ("branchlength", "diameter", "out_distances"))
        if err > EPOCH_TWIN_ATOL:
            raise AssertionError(f"nj_join_epoch {label}: values {err} from "
                                 "the twin's")
        entry.update({
            "max_abs_err": err, "ms": 1e3 * wall,
            "plain_ms": 1e3 * cpu.timings["joins_s"],
            "host_loop_ms": 1e3 * host_wall, "device_us": dev_us,
            "device_us_per_join": dev_us / joins, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        counters = dict(zip(EPOCH_DEBUG, a["debug"].tolist()))
        print(f"  nj_join_epoch [{label}]: the twin on the CPU "
              f"{cpu.timings['joins_s']:.3f} s, the same join log, values "
              f"max abs err {err:.3e}; counters {counters} (the kernel's "
              f"{b['debug'].tolist()}); {' '.join(epoch_diff(a, b))} "
              "differ")


# ------------------------------------------------------------- phase 2e
ML_DEBUG = ("n_ml_nni", "n_star_tests", "n_lk_compute", "n_posterior_compute")
# the plain twins against the kernels (the host loops' bits): the tree
# LogLk after a pass or a round within 1e-5 relative, where the twins read
# 2.3e-7 (pass) and 1.25e-6 (round) at N=500 and a pass that leaves out each
# node's second sweep (second_sweep_left_out, a planted fault) reads 8.3e-5;
# the round's NNI count equal and its max_delta within ML_TWIN_NEAR_TIE; a
# quartet decision may flip only on a near tie, its two criteria within
# the quartet LogLk tolerance of tests/test_torch_ml_round.py.  Each
# package's float32 line searches stop at other points of their flat
# bottoms and a pass carries each length into the next search, so single
# lengths differ by up to about 1e-2 at N=500.
ML_TWIN_RTOL = 1e-5
ML_TWIN_NEAR_TIE = 5e-3
GTR = ([1.2, 3.1, 0.8, 1.1, 2.9, 1.0], [0.3, 0.2, 0.24, 0.26])


def ml_start(n, dev, model="jc", cat=False):
    """The port's NJ tree of synth_codes(n, MAIN_P) on dev with its ME
    branch lengths and an ML store (Jukes-Cantor or GTR) with recomputed
    posteriors: the start of the default run's first ML lengths pass and
    NNI round (one rate), or with cat, of its later ones (the CAT 20 rates
    fitted to the tree, engine/ml.set_ml_rates)."""
    from veryfasttree_tpu_torch.engine import ml, rearrange
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu_torch.models import TransitionMatrix

    nj = spr_start(n, dev)
    rearrange.update_branch_lengths(nj)
    nj.ml = MLProfiles(nj, None if model == "jc"
                       else TransitionMatrix.gtr(*GTR))
    if cat:
        ml.set_ml_rates(nj)
    else:
        nj.ml.recompute_ml_profiles()
    return nj


def ml_copy(nj, dev):
    """engine_copy of nj with an ML store of its own on dev."""
    import copy

    import torch

    c = engine_copy(nj, dev)
    c.ml = copy.copy(nj.ml)
    c.ml.nj, c.ml.device = c, torch.device(dev)
    for name in ("codes", "W", "V", "code_freq", "eigenval", "statinv",
                 "eigeninv", "eigentot"):
        setattr(c.ml, name, getattr(nj.ml, name).to(dev, copy=True))
    c.ml.gap_vec = c.ml.code_freq[127]
    c.ml._push_model()
    return c


def ml_state(nj, stats=None, result=None):
    """What an ML lengths pass or NNI round leaves behind: the tree arrays
    and branch lengths (and the NNIStats), the debug counters (and the
    round's n_changes and max_delta), and the node and up-profile rows of
    the ML store (every row but the scratch rows)."""
    tree = {k: getattr(nj.tree, k).copy()
            for k in ("parent", "children", "n_child", "branchlength")}
    if stats is not None:
        tree.update({k: getattr(stats, k).copy() for k in NNI_STATS})
    ctr = {k: getattr(nj.debug, k) for k in ML_DEBUG}
    if result is not None:
        ctr["round"] = (int(result[0]), float(result[1]))
    m = 2 * nj.tree.maxnodes
    return tree, ctr, {k: getattr(nj.ml, k)[:m].cpu().numpy()
                       for k in ("codes", "W", "V")}


def ml_diff(a, b):
    """The names of what differs, bit for bit, between two states."""
    (ta, ca, ra), (tb, cb, rb) = a, b
    out = [k for k in ta if ta[k].tobytes() != tb[k].tobytes()]
    out += [k for k in ca if ca[k] != cb[k]]
    return out + [k for k in ra if ra[k].tobytes() != rb[k].tobytes()]


def record_ml_rows(nj):
    """Have the ML store's calls note the node and up-profile rows a host
    loop reads before it writes them and the rows it writes (the scratch
    rows are the kernels' shared memory): returns those two sets, filled
    as the loop runs, and a function that stops the recording."""
    ml = nj.ml
    inputs, outputs = set(), set()
    lim = ml.scratch_row(0)
    names = ("posterior_rows", "quartet_optimize", "opt_branch_length")
    orig = {k: getattr(ml, k) for k in names}

    def read(*rows):
        inputs.update(int(r) for r in rows if int(r) < lim
                      and int(r) not in outputs)

    def posterior_rows(targets, r1s, r2s, *a):
        read(*r1s, *r2s)
        outputs.update(int(t) for t in targets if int(t) < lim)
        return orig["posterior_rows"](targets, r1s, r2s, *a)

    def quartet_optimize(rows4s, *a, **k):
        read(*(r for rows in rows4s for r in rows))
        return orig["quartet_optimize"](rows4s, *a, **k)

    def opt_branch_length(r1, r2, guess):
        read(r1, r2)
        return orig["opt_branch_length"](r1, r2, guess)

    for k, fn in zip(names, (posterior_rows, quartet_optimize,
                             opt_branch_length)):
        setattr(ml, k, fn)
    return inputs, outputs, lambda: [delattr(ml, k) for k in names]


def ml_round_bound(totals, n_rows, P, C, jc):
    """(bound_ms, bound_by, bytes, operations) of the work in `totals` (a
    round kernel's counters): n_rows distinct rows read or written once,
    and each posterior's, line search's (its vectors mixed once, then its
    evaluations) and pair likelihood's operations per position."""
    eff, site, post = ml_ops(C, jc)
    n_ops = P * (totals["posteriors"] * post + totals["searches"] * eff
                 + totals["evals"] * site + totals["pairs"] * (eff + site))
    n_bytes = n_rows * ml_row_bytes(P, C)
    return (*bound(n_bytes, n_ops), n_bytes, n_ops)


def ml_decisions(fn):
    """Run fn() with engine/ml.ml_quartet_nni logging its quartets:
    returns [(rows, choice, criteria)]."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import ml

    log, orig = [], ml.ml_quartet_nni

    def rec(nj_, rows4, lengths):
        out = orig(nj_, rows4, lengths)
        log.append((tuple(int(r) for r in rows4), int(out[0]),
                    np.array(out[1], dtype=np.float64)))
        return out

    ml.ml_quartet_nni = rec
    try:
        fn()
    finally:
        ml.ml_quartet_nni = orig
    return log


def second_sweep_left_out(fn):
    """Run fn() with engine/ml.optimize_all_branch_lengths leaving out each
    node's second sweep (its three line searches return their start): a
    planted fault, which the twin check must see."""
    from veryfasttree_tpu_torch.engine import ml

    orig, calls = ml.ml_pair_optimize, [0]

    def searched(nj_, r1, r2, length):
        calls[0] += 1
        if (calls[0] - 1) % 6 >= 3:
            return None, length
        return orig(nj_, r1, r2, length)

    ml.ml_pair_optimize = searched
    try:
        fn()
    finally:
        ml.ml_pair_optimize = orig


def first_flip(label, a, b):
    """The index of the first quartet two logs of the same round decide
    otherwise, or None; raises unless it is a near tie in both, or if the
    logs part before it.  Returns (index, the criteria's max abs difference
    up to it)."""
    import numpy as np

    err = 0.0
    for k, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            raise AssertionError(f"{label}: quartet {k} differs ({x[0]}, "
                                 f"{y[0]})")
        err = max(err, float(np.max(np.abs(x[2] - y[2]))))
        if x[1] != y[1]:
            if any(abs(c[x[1]] - c[y[1]]) > ML_TWIN_NEAR_TIE
                   for c in (x[2], y[2])):
                raise AssertionError(f"{label}: quartet {k} flips, not on a "
                                     f"near tie: {x} {y}")
            return k, err
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} and {len(b)} quartets")
    return None, err


def phase_ml_round(report, dev):
    """One ML lengths pass, then one ML NNI round, from one NJ start with
    an ML store (ml_start): at N=SPR_N under Jukes-Cantor with one rate, as
    the default run's first pass and round, and under Jukes-Cantor and GTR
    with fitted CAT 20 rates, as its later ones; and at the main path's
    N=MAIN_N under Jukes-Cantor with one rate, where the tree fills most of
    block 0's shared memory (the layout of the default run's rounds); in
    every case no quartet piece of the round's three blocks goes to device
    scratch (asserted).  Each
    through one launch of each kernel (ops/ml_round.ml_lengths_pass,
    ml_nni_round) and through the host loops with the per-call kernels
    (engine/ml.optimize_all_branch_lengths, engine/rearrange.do_nni): tree,
    branch lengths, NNIStats, counters and the ML store's node and
    up-profile rows bit for bit.  The first case also with the kernels'
    tree in device memory, and through the plain twins (the host loops on
    the per-call twins, on a CPU copy of the start): the tree LogLk after
    the pass and after the round within ML_TWIN_RTOL, the round's NNI count
    equal and max_delta within ML_TWIN_NEAR_TIE, its quartet decisions equal
    up to a flip on a near tie (ML_TWIN_NEAR_TIE); and the planted fault
    second_sweep_left_out (the host loop on the card) must read more than
    ML_TWIN_RTOL from the kernel's pass.  Timed on the first case:
    the kernels' device time from torch.profiler over three more launches,
    and the host loop's (its ml_quartet_opt, ml_opt_branch and ml_posterior
    launches) over one more run; ms and plain_ms are the kernel's and the
    twin's walls (one launch each), host_loop_ms the host loop's; the bound
    counts each node or up-profile row the host loop reads before writing
    it and each row it writes once (record_ml_rows) and the operations of
    the kernel's counted work (ml_round_bound)."""
    import torch

    from veryfasttree_tpu_torch.engine import ml, rearrange
    from veryfasttree_tpu_torch.ops import ml_round

    cpu = torch.device("cpu")
    lengths, nni = ml_round.ml_lengths_pass, ml_round.ml_nni_round
    for i_case, (label, n, model, cat) in enumerate((
            ("JC", SPR_N, "jc", False), ("JC CAT 20", SPR_N, "jc", True),
            ("GTR CAT 20", SPR_N, "gtr", True), ("JC", MAIN_N, "jc", False))):
        label = f"N={n} {label}"
        start = ml_start(n, dev, model, cat)
        first = i_case == 0
        runs = {}
        for name, where, kw in (("kernel", dev, {}),
                                ("host loop", dev, None),
                                ("tree in device memory", dev,
                                 {"tree_in_smem": False}),
                                ("twin", cpu, {})):
            if name in ("tree in device memory", "twin") and not first:
                continue
            nj = ml_copy(start, where)
            stats = rearrange.NNIStats.init(nj)
            if kw is None:
                steps = (("pass", lambda: ml.optimize_all_branch_lengths(nj)),
                         ("round",
                          lambda: rearrange.do_nni(nj, 0, 2, True, stats)))
            else:
                steps = (("pass", lambda: lengths(nj, **kw)),
                         ("round", lambda: nni(nj, 0, 2, stats, **kw)))
            run = {}
            reset_launches()
            threads = torch.get_num_threads()
            torch.set_num_threads(1)     # the twin's tiny ops only contend
            for what, fn in steps:
                if name == "host loop":
                    rows = record_ml_rows(nj)
                out = []
                t0 = time.perf_counter()
                if name in ("host loop", "twin") and what == "round":
                    run["log"] = ml_decisions(lambda: out.append(fn()))
                else:
                    out.append(fn())
                torch.cuda.synchronize()
                run[f"{what}_s"] = time.perf_counter() - t0
                run[what] = ml_state(nj, stats if what == "round" else None,
                                     out[0] if what == "round" else None)
                run[f"{what}_loglk"] = ml.tree_loglk(nj)
                if name == "host loop":
                    run[f"{what}_rows"] = len(rows[0]) + len(rows[1])
                    rows[2]()
            torch.set_num_threads(threads)
            run.update(layout=nni.tree_layout, scratch=nni.scratch_floats,
                       pass_totals=dict(lengths.totals),
                       round_totals=dict(nni.totals),
                       launches=(lengths.launches, nni.launches))
            runs[name] = run
        k, h = runs["kernel"], runs["host loop"]
        if k["launches"] != (1, 1):
            raise AssertionError(f"ml round kernels {label}: launches "
                                 f"{k['launches']}, not one each")
        P, C = start.ml.W.shape[1], start.ml.V.shape[2]
        # each block of the round's cluster keeps its quartet pieces in its
        # own shared memory, block 0 the tree before them (104 KB at
        # N=MAIN_N): no device scratch
        for name in ("kernel", "tree in device memory"):
            if name in runs and (runs[name]["layout"], runs[name]["scratch"]) \
                    != ("shared memory" if name == "kernel" else
                        "device memory", 0):
                raise AssertionError(
                    f"ml round kernels {label} ({name}): tree in "
                    f"{runs[name]['layout']}, {runs[name]['scratch']} floats "
                    "of device scratch")
        for name in ("host loop", "tree in device memory"):
            for what in ("pass", "round") if name in runs else ():
                diff = ml_diff(runs[name][what], k[what])
                if diff:
                    raise AssertionError(
                        f"ml round kernels {label}: after the {what}, {diff} "
                        f"differ between the kernel and the {name}")
        print(f"  ml_lengths_pass [{label}]: bit for bit the host loop's"
              f"{' and the device-memory tree' * first}; one launch, "
              f"{k['pass_s']:.3f} s (the host loop with the per-call "
              f"kernels {h['pass_s']:.3f} s), LogLk {k['pass_loglk']:.3f}; "
              f"{k['pass_totals']}")
        print(f"  ml_nni_round [{label}]: bit for bit the host loop's"
              f"{' and the device-memory tree' * first}; one launch, "
              f"{k['round_s']:.3f} s (the host loop {h['round_s']:.3f} s), "
              f"{k['round'][1]['round']} (NNIs, max delta), LogLk "
              f"{k['round_loglk']:.3f}, tree in {k['layout']}, "
              f"{k['scratch']} floats of device scratch; "
              f"{k['round_totals']['speculative']} AC/AD optimizations "
              f"started beside AB and discarded; {k['round_totals']}")
        if not first:
            continue
        t = runs["twin"]
        rel = {what: abs(t[f"{what}_loglk"] - k[f"{what}_loglk"])
               / abs(k[f"{what}_loglk"]) for what in ("pass", "round")}
        flip, crit_err = first_flip(f"ml_nni_round {label} twin", h["log"],
                                    t["log"])
        bl_err = float(abs(t["pass"][0]["branchlength"]
                           - k["pass"][0]["branchlength"]).max())
        print(f"  twins on the CPU [{label}]: lengths pass {t['pass_s']:.3f}"
              f" s, LogLk {t['pass_loglk']:.3f} ({rel['pass']:.2e} "
              f"relative), lengths max abs err {bl_err:.3e}; NNI round "
              f"{t['round_s']:.3f} s, {t['round'][1]['round']}, LogLk "
              f"{t['round_loglk']:.3f} ({rel['round']:.2e} relative), "
              f"{len(t['log'])} quartets, "
              + (f"the same decisions, criteria within {crit_err:.3e}"
                 if flip is None else
                 f"a near tie flips at quartet {flip} (criteria within "
                 f"{crit_err:.3e} before it)"))
        if max(rel.values()) > ML_TWIN_RTOL:
            raise AssertionError(f"ml round kernels {label}: tree LogLk "
                                 f"{rel} relative from the twins'")
        (k_nni, k_max), (t_nni, t_max) = (r["round"][1]["round"]
                                          for r in (k, t))
        if flip is None and (k_nni != t_nni
                             or abs(k_max - t_max) > ML_TWIN_NEAR_TIE):
            raise AssertionError(f"ml round kernels {label}: (NNIs, max "
                                 f"delta) {(k_nni, k_max)}, the twins' "
                                 f"{(t_nni, t_max)}")
        faulty = ml_copy(start, dev)
        second_sweep_left_out(lambda: ml.optimize_all_branch_lengths(faulty))
        fault = abs(ml.tree_loglk(faulty) - k["pass_loglk"]) \
            / abs(k["pass_loglk"])
        print(f"  planted fault [{label}]: the host loop leaving out each "
              f"node's second sweep reads {fault:.2e} relative from the "
              f"kernel's pass, the twins {max(rel.values()):.2e}; the "
              f"limit {ML_TWIN_RTOL:.0e}; max delta {k_max!r} (the twins' "
              f"{t_max!r})")
        if fault <= ML_TWIN_RTOL:
            raise AssertionError(f"ml round kernels {label}: the planted "
                                 f"fault reads {fault:.2e}, within the twin "
                                 f"limit {ML_TWIN_RTOL:.0e}")

        # the host loops' kernels (device_us needs each name launched)
        for wrapper, what, host_kernels in (
                (lengths, "pass", ("ml_opt_branch", "ml_posterior")),
                (nni, "round", ("ml_quartet_opt", "ml_posterior"))):
            def one(wrapper=wrapper, kernel=True):
                nj = ml_copy(start, dev)
                stats = rearrange.NNIStats.init(nj)
                if wrapper is nni:
                    if kernel:
                        wrapper(nj, 0, 2, stats)
                    else:
                        rearrange.do_nni(nj, 0, 2, True, stats)
                elif kernel:
                    wrapper(nj)
                else:
                    ml.optimize_all_branch_lengths(nj)

            name = wrapper.__name__
            dev_us = device_us(one, DEVICE_NAMES[name], runs=3)
            host_us = device_us(lambda: one(kernel=False),
                                [n for k in host_kernels
                                 for n in DEVICE_NAMES[k]], runs=1)
            totals = k[f"{what}_totals"]
            bound_ms, bound_by, n_bytes, n_ops = ml_round_bound(
                totals, h[f"{what}_rows"], P, C, True)
            per, unit, key = (
                (totals["quartets"], "quartet optimization", "quartet")
                if wrapper is nni else
                (totals["searches"], "line search", "search"))
            n_nodes = SPR_N - 2
            report.setdefault(name, {}).update({
                "max_abs_err": abs(t[f"{what}_loglk"] - k[f"{what}_loglk"]),
                "ms": 1e3 * k[f"{what}_s"], "plain_ms": 1e3 * t[f"{what}_s"],
                "host_loop_ms": 1e3 * h[f"{what}_s"],
                "tree_in_device_memory_ms":
                    1e3 * runs["tree in device memory"][f"{what}_s"],
                "device_us": dev_us, f"device_us_per_{key}": dev_us / per,
                "device_us_per_node": dev_us / n_nodes,
                "host_loop_device_us": host_us,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None})
            print(f"  {name} [{label}]: device {dev_us / 1e3:.3f} ms for "
                  f"the {what} ({dev_us / per:.3f} us per {unit}, "
                  f"{dev_us / n_nodes:.3f} us per node; the host loop's "
                  f"kernels {host_us / 1e3:.3f} ms); the tree in device "
                  f"memory {runs['tree in device memory'][f'{what}_s']:.3f} "
                  f"s; {h[f'{what}_rows']} rows read or written, {n_ops:.4e} "
                  f"operations: bound {bound_ms:.4e} ms ({bound_by}; bytes "
                  f"{1e3 * n_bytes / HBM_BYTES_PER_S:.4e} ms, operations "
                  f"{1e3 * n_ops / F32_OPS_PER_S:.4e} ms)")


# ------------------------------------------------------------- phase 2f
SH_BOOT = 1000                  # the resamples of the default run
SH_KEYS = ("nodes", "loglk", "pair_lk", "quartet_lk", "choice", "bad",
           "support")


def sh_start(n, dev, model):
    """ml_start(n, dev, model, cat=True) after one ML lengths pass and one
    ML NNI round (the round kernels on a CUDA store, the host loops on a CPU
    one), with SH_BOOT resamples: the state the default run's SH-like
    supports start from, a few rounds early."""
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.ops import ml_round

    nj = ml_start(n, dev, model, cat=True)
    ml_round.ml_lengths_pass(nj)
    ml_round.ml_nni_round(nj, 0, 2, rearrange.NNIStats.init(nj))
    nj.options.n_bootstrap = SH_BOOT
    return nj


def sh_host_loop(nj):
    """engine/ml.test_splits_ml on nj, its pair and quartet calls recorded
    (the store's pair_loglk_rows and quartet_records): returns (SplitCount,
    record) with the keys sh_run's record has (SH_KEYS),
    built from the loop's calls as the loop uses them: per split, its three
    AB pairs, its AC and AD optimizations and the second pass on the closer
    one."""
    import numpy as np

    from veryfasttree_tpu_torch import constants
    from veryfasttree_tpu_torch.engine import ml

    events, store = [], nj.ml

    def pair(*a, **k):
        ll, lk = type(store).pair_loglk_rows(store, *a, **k)
        events.append((np.array(ll), np.array(lk, dtype=np.float32)))
        return ll, lk

    def quartet(rows4, *a, **k):
        rec, site = type(store).quartet_records(store, rows4, *a, **k)
        events.append((np.asarray(rows4).reshape(-1, 4).copy(), rec.copy(),
                       np.array(site)))
        return rec, site

    store.pair_loglk_rows, store.quartet_records = pair, quartet
    try:
        sc = ml.test_splits_ml(nj)
    finally:
        del store.pair_loglk_rows, store.quartet_records
    tree, n = nj.tree, nj.n_pos
    nodes = [v for v in tree.postorder_nodes()
             if v >= nj.n_seqs and v != tree.root]
    out = {k: [] for k in SH_KEYS}
    i = 0
    for node in nodes:
        p, (rows, rec, site) = events[i:i + 3], events[i + 3]
        i += 4
        ll = [float(e[0][0]) for e in p]
        parts = rec["parts"]
        loglk = [ll[0] + ll[1] + ll[2], *(parts[:, 0] + parts[:, 1]
                                          + parts[:, 2])]
        q_lk = site[:, :, :n].copy()
        if i < len(events) and len(events[i]) == 3:      # the second pass
            rows2, rec2, site2 = events[i]
            i += 1
            which = 0 if (rows2[0] == rows[0]).all() else 1
            parts = rec2["parts"][0]
            loglk[1 + which] = parts[0] + parts[1] + parts[2]
            q_lk[which] = site2[0, :, :n]
        ab, ac, ad = loglk
        if ab >= ac and ab >= ad:
            choice = 0
        elif ac >= ab and ac >= ad:
            choice = 1
        else:
            choice = 2
        out["nodes"].append(node)
        out["loglk"].append(loglk)
        out["pair_lk"].append(np.stack([e[1][0] for e in p]))
        out["quartet_lk"].append(q_lk)
        out["choice"].append(choice)
        out["bad"].append(loglk[choice] > ab + constants.TREE_LOGLK_DELTA)
    if i != len(events):
        raise AssertionError(f"test_splits_ml: {len(events) - i} calls left "
                             "over")
    rec = {k: np.array(v) for k, v in out.items() if k != "support"}
    rec["loglk"] = rec["loglk"].astype(np.float64)
    rec["support"] = tree.support[rec["nodes"]].copy() \
        if nj.options.n_bootstrap > 0 else None
    return sc, rec


def sh_run(nj):
    """ops/ml_round.SHPass on nj, as sh_pass runs it: returns (SplitCount,
    record of SH_KEYS, the pass)."""
    from veryfasttree_tpu_torch.ops import ml_round

    sh = ml_round.SHPass(nj).run()
    return sh.sc, {k: getattr(sh, k) for k in SH_KEYS}, sh


def sh_work(sh):
    """The work an SHPass did: levels, up-profile rows, splits optimized
    again, quartets, posteriors, pairs, line searches and their
    evaluations, and the distinct store rows read or written."""
    import numpy as np

    S, again = sh.S, len(sh.again)
    quartets = 2 * S + again
    up = [np.concatenate(v) for v in zip(*sh.levels)] if sh.levels \
        else [np.zeros(0, dtype=np.int64)] * 3
    evals = int(sh.rec["n_eval"].sum()) + (
        int(sh.rec2["n_eval"].sum()) if sh.rec2 is not None else 0)
    return {"levels": len(sh.levels), "up_rows": len(up[0]), "again": again,
            "quartets": quartets,
            "posteriors": len(up[0]) + 2 * S + 7 * quartets,
            "pairs": 3 * S + 3 * quartets, "searches": 5 * quartets,
            "evals": evals,
            "rows": 2 * S + len(np.unique(np.concatenate(
                [sh.rows4.ravel(), *up[:3]]).astype(np.int64)))}


def sh_state(nj, sc, record):
    """What an SH pass leaves behind, for sh_diff: its record (tensors as
    numpy arrays), the SplitCount, nj.debug's likelihood and posterior
    counters, and the ML store's node and up-profile rows."""
    import dataclasses

    import numpy as np

    state = {k: np.asarray(v.cpu().numpy() if hasattr(v, "cpu") else v)
             for k, v in record.items()}
    state["split_count"] = np.array(dataclasses.astuple(sc), dtype=np.float64)
    state["counters"] = np.array([nj.debug.n_lk_compute,
                                  nj.debug.n_posterior_compute])
    m = 2 * nj.tree.maxnodes
    for k in ("codes", "W", "V"):
        state[f"rows_{k}"] = getattr(nj.ml, k)[:m].cpu().numpy()
    return state


def sh_diff(a, b):
    """The names of what differs, bit for bit, between two sh_states."""
    return [k for k in a if a[k].shape != b[k].shape
            or a[k].tobytes() != b[k].tobytes()]


def sh_bound(w, S, P, C, jc, n_boot):
    """(bound_ms, bound_by) of one SH pass over S splits that did the work
    w (sh_work): its distinct store rows read or written once and the
    counts [P, B] written; each posterior's, pair's and quartet piece's
    operations per position (ml_ops) and the resampled sums (two per
    count)."""
    eff, site, post = ml_ops(C, jc)
    n_ops = P * (w["posteriors"] * post + w["pairs"] * (eff + site)
                 + w["searches"] * eff + w["evals"] * site) \
        + 2 * S * 3 * P * n_boot
    return bound(w["rows"] * ml_row_bytes(P, C) + 8 * P * n_boot, n_ops)


def check_resample(report, dev):
    """The counts kernel against its twin at B=SH_BOOT, P=MAIN_P: equal.
    Times: the kernel's launch to launch and device time, the twin's one
    run (a Python draw per column)."""
    from veryfasttree_tpu_torch.ops import resample_kernels as rk

    P, B = MAIN_P, SH_BOOT
    got = rk.sh_resample_counts(P, B, dev)
    t0 = time.perf_counter()
    want = rk.sh_resample_counts_ref(P, B)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not (got.cpu() == want).all() or int(want.sum()) != P * B:
        raise AssertionError("sh_resample_counts differs from its twin")
    # the state in, the counts [P, B] float64 out; per draw its column
    # (five operations) and ten values of the recurrence (two each)
    bound_ms, bound_by = bound(400 + 8 * P * B, 25 * P * B)
    fn = lambda: rk.sh_resample_counts(P, B, dev)  # noqa: E731
    entry = {"max_abs_err": 0.0, "ms": median_ms(fn, runs=20),
             "plain_ms": plain_ms,
             "device_us": device_us(fn, DEVICE_NAMES["sh_resample_counts"],
                                    runs=10),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    report.setdefault("sh_resample_counts", {}).update(entry)
    print(f"  sh_resample_counts [P={P} B={B}]: equal to the twin; kernel "
          f"{entry['ms']:.4f} ms launch to launch, {entry['device_us']:.1f} "
          f"us on the device, twin {plain_ms:.1f} ms, bound "
          f"{bound_ms:.3e} ms ({bound_by})")


def phase_sh(report, dev):
    """The SH-like supports at N=SPR_N from sh_start, JC + CAT 20 and GTR +
    CAT 20: ops/ml_round.SHPass (sh_pass's list launches) and the host loop
    engine/ml.test_splits_ml with the per-call kernels, each on its own
    copy of the start; per-split log-likelihoods, per-site likelihoods,
    choices, bad splits, supports, SplitCount, counters and the store's node
    and up-profile rows bit for bit (sh_diff).  Then the counts kernel
    against its twin (check_resample).  Prints each pass's launches, walls,
    device time (torch.profiler, every kernel of the pass) and bound
    (sh_bound: each distinct row once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from veryfasttree_tpu_torch.ops import ml_round

    for label, model in (("JC CAT 20", "jc"), ("GTR CAT 20", "gtr")):
        label = f"N={SPR_N} {label}"
        start = sh_start(SPR_N, dev, model)
        runs = {}
        for name in ("pass", "host loop"):
            nj = ml_copy(start, dev)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc, record, sh = sh_run(nj) if name == "pass" else \
                (*sh_host_loop(nj), None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in wrappers().items()
                        if fn.launches}
            runs[name] = (sh_state(nj, sc, record), wall, launches, sh)
        diff = sh_diff(runs["pass"][0], runs["host loop"][0])
        state, wall, launches, sh = runs["pass"]
        if diff:
            raise AssertionError(f"sh_pass {label}: {diff} differ from the "
                                 "host loop's")
        nj = ml_copy(start, dev)
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            ml_round.sh_pass(nj)
            torch.cuda.synchronize()
        busy, _, n_events, top = busy_share(trace, 1.0)
        P, C = start.ml.W.shape[1], start.ml.V.shape[2]
        work = sh_work(sh)
        bound_ms, bound_by = sh_bound(work, sh.S, P, C, model == "jc",
                                      SH_BOOT)
        print(f"  sh_pass [{label}]: bit for bit the host loop's ({sh.S} "
              f"splits, {int(sh.bad.sum())} bad, {work['again']} optimized "
              f"again); {wall:.3f} s (the host loop "
              f"{runs['host loop'][1]:.3f} s); launches {launches} (the host "
              f"loop's {runs['host loop'][2]}); device {1e3 * busy:.3f} ms "
              f"in {n_events} events, top {top}; {work['rows']} rows, work "
              f"{work}: bound {bound_ms:.4e} ms ({bound_by})")
    check_resample(report, dev)


# ------------------------------------------------------------- phase 2g
CAT_N = 20                      # the default run's CAT rate categories
DEEP_N = 600                    # a caterpillar of DEEP_N - 1 levels
# the whole-tree kernels' sums against the per-level path's: each level's
# sum over its pairs in list order, where torch's reductions (ll.sum(),
# a per-site sum over the level's pairs) take an order of their own, so
# float64 sums of the same terms may part in their last bits
SUM_RTOL = 1e-12
# the kernels against their plain twins on the card: float32 posteriors
# whose last bits differ, carried up the tree's levels (the tolerances at
# which tests/test_torch_ml_store.py holds the port's rows and per-site
# sums to the JAX package's)
TWIN_ROWS = dict(rtol=1e-6, atol=1e-4)
TWIN_SITE = dict(rtol=1e-5, atol=1e-4)


def shaped_tree(nj, shape, seed=0):
    """Replace nj's tree by one of its n_seqs leaves (at least four), with
    branch lengths drawn from `seed`, some 0 (below the minimum length):
    "caterpillar", each internal node the node below it and a leaf, the
    root's three children the chain's top and the last two leaves
    (n_seqs - 1 levels, one posterior each but the root's); or "balanced",
    the leaves, then the nodes, paired in order level by level (its
    deepest level n_seqs / 2 nodes of two leaves)."""
    import numpy as np

    from veryfasttree_tpu_torch.engine.state import TreeState

    n = nj.n_seqs
    tree = TreeState(n, nj.maxnodes)
    top = n

    def join(kids):
        nonlocal top
        tree.set_children(top, kids)
        top += 1
        return top - 1

    if shape == "caterpillar":
        node = join([0, 1])
        for leaf in range(2, n - 2):
            node = join([node, leaf])
        tree.root = join([node, n - 2, n - 1])
    else:
        nodes = list(range(n))
        while len(nodes) > 3:
            if len(nodes) == 4:
                nodes = [join(nodes[:2])] + nodes[2:]
                continue
            odd = len(nodes) % 2
            nodes = [join(nodes[i:i + 2])
                     for i in range(0, len(nodes) - 1, 2)] + \
                nodes[len(nodes) - odd:]
        tree.root = join(nodes)
    tree.maxnode = top
    rng = np.random.default_rng(seed)
    bl = rng.uniform(0.0, 0.4, top)
    bl[rng.random(top) < 0.02] = 0.0
    tree.branchlength[:top] = bl
    nj.tree = tree


def shaped_start(n, dev, shape, model, p=MAIN_P, seed=0):
    """An engine on synth_codes(n, p) on dev (no NJ phase) whose tree is
    shaped_tree(shape), with an ML store under `model` (Jukes-Cantor or
    GTR; its averaged profiles) at CAT_N rates, the categories drawn from
    `seed`."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import ml
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.models import TransitionMatrix
    from veryfasttree_tpu_torch.options import Options

    opts = Options(n_codes=4, n_bootstrap=0, show_progress=False)
    opts.derive_settings()
    nj = NeighbourJoining(opts, synth_codes(n, p), None, None, device=dev)
    shaped_tree(nj, shape, seed)
    nj.ml = MLProfiles(nj, None if model == "jc"
                       else TransitionMatrix.gtr(*GTR))
    rng = np.random.default_rng(seed)
    nj.ml.set_rates(ml.ml_site_rates(CAT_N),
                    rng.integers(0, CAT_N, nj.n_pos).astype(np.int32))
    return nj


def per_level_recompute(ml):
    """recompute_ml_profiles as it ran before ml_posterior_sweep: one
    ml_posterior call per tree level (MLProfiles.posterior_rows)."""
    tree = ml.nj.tree
    bl = tree.branchlength
    for level in tree.level_lists():
        nodes = [int(nd) for nd in level if tree.n_child[nd] == 2]
        if nodes:
            i, j = tree.children[nodes, 0], tree.children[nodes, 1]
            ml.posterior_rows(nodes, i, j, bl[i], bl[j])


def per_level_loglk(nj, want_site=False):
    """The sums of tree_loglk as they ran before ml_tree_loglk: one
    ml_pair_loglk call per tree level, the root term through ml_posterior
    and ml_pair_loglk, the level sums and per-site logs added in float64 by
    torch on the device.  Returns (total, per-site [n_pos] or None),
    tensors on the device, before the Jukes-Cantor correction."""
    import torch

    from veryfasttree_tpu_torch.engine.ml_profiles import S_AB

    tree, ml = nj.tree, nj.ml
    acc = torch.zeros((), dtype=torch.float64, device=ml.device)
    site = torch.zeros(nj.n_pos, dtype=torch.float64, device=ml.device)

    def add(ll, lk):
        nonlocal acc, site
        acc = acc + ll.sum()
        if want_site:
            site = site + torch.log(torch.clamp_min(lk.double(), 1e-300)) \
                .reshape(-1, nj.n_pos).sum(0)

    bl = tree.branchlength
    for level in tree.level_lists():
        nodes = [int(nd) for nd in level if tree.n_child[nd] >= 2]
        if nodes:
            r1s, r2s = tree.children[nodes, 0], tree.children[nodes, 1]
            add(*ml.pair_loglk_rows(r1s, r2s, bl[r1s] + bl[r2s], want_site,
                                    fetch=False))
    if tree.n_child[tree.root] == 3:
        c0, c1, c2 = (int(c) for c in tree.children[tree.root])
        s_ab = ml.scratch_row(S_AB)
        ml.posterior_into(s_ab, c0, c1, bl[c0], bl[c1])
        add(*ml.pair_loglk(s_ab, c2, bl[c2], want_site, fetch=False))
    return acc, (site if want_site else None)


def per_level_site_likelihoods(nj, rates):
    """engine/ml.ml_site_likelihoods_by_rate as it ran before the
    whole-tree kernels: per rate per_level_recompute, per_level_loglk and a
    fetch; [nRate, n_pos] float64 on the host, with the Jukes-Cantor
    correction."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import ml as eml

    ml = nj.ml
    old_rates, old_cats = ml.rates_np.copy(), ml.ratecat_np.copy()
    out = np.zeros((len(rates), nj.n_pos))
    for i, r in enumerate(rates):
        ml.set_rates(np.full_like(old_rates, r), old_cats[: nj.n_pos])
        per_level_recompute(ml)
        out[i] = per_level_loglk(nj, True)[1].cpu().numpy()
    eml._jc_correct(nj, site=out)
    ml.set_rates(old_rates, old_cats[: nj.n_pos])
    per_level_recompute(ml)
    return out


def store_diff(a, b):
    """The arrays of two ML stores (codes, W, V) that differ, bit for
    bit."""
    import torch

    return [k for k in ("codes", "W", "V") if not torch.equal(
        getattr(a, k).contiguous().view(torch.uint8),
        getattr(b, k).contiguous().view(torch.uint8))]


def max_rel(a, b):
    """The largest |a - b| / |b| of two float arrays (0 where both are
    0)."""
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    d = np.abs(a - b)
    return float(np.max(np.where(d == 0, 0.0, d / np.maximum(np.abs(b),
                                                            1e-300))))


def sweep_bound(tables, P, C, jc):
    """(bound_ms, bound_by) of a posterior sweep: the rows it reads before
    any item writes them and the rows it writes, once each, its tables
    (seven words an item) and the rate categories; a posterior's
    operations per position (ml_ops) for each item."""
    import numpy as np

    src = np.unique(np.concatenate([tables.r1, tables.r2]))
    n_rows = len(np.setdiff1d(src, tables.targets)) + tables.n_items
    return bound(n_rows * ml_row_bytes(P, C) + 28 * tables.n_items + 4 * P,
                 tables.n_items * P * ml_ops(C, jc)[2])


def loglk_bound(tables, P, C, jc, n_pos, want_site):
    """(bound_ms, bound_by) of a tree log-likelihood: the distinct rows it
    reads once, the root term's posterior row written, its tables (three
    words a pair) and the rate categories, the total and the per-site sums
    out; each pair's operations per position (ml_ops), the root term's
    posterior and pair, and a log and an add for each per-site term."""
    import numpy as np

    eff, site, post = ml_ops(C, jc)
    rows = [tables.r1, tables.r2]
    n_terms = tables.n_pairs
    n_ops = tables.n_pairs * P * (eff + site)
    if tables.root is not None:
        rows.append(np.asarray(tables.root[1:4]))
        n_terms += 1
        n_ops += P * (post + eff + site)
    n_rows = len(np.unique(np.concatenate(rows)))
    n_bytes = (n_rows + (tables.root is not None)) * ml_row_bytes(P, C) \
        + 12 * tables.n_pairs + 4 * P + 8 * (1 + (n_pos if want_site else 0))
    if want_site:
        n_ops += 2 * n_terms * n_pos
    return bound(n_bytes, n_ops)


def check_sweep(label, nj, dev, kernel_runs=True):
    """One posterior sweep and one tree log-likelihood with per-site sums
    over nj's tree (its TreeSweep): the kernels against the per-level
    launches (the rows bit for bit, the sums within SUM_RTOL) and against
    their twins on the card (TWIN_ROWS, TWIN_SITE), each on its own copy of
    nj.  Returns ({name: (max abs err against the twin, timing)}, the
    TreeSweep); with kernel_runs False the timings are left out."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    copies = {k: ml_copy(nj, dev) for k in ("kernel", "levels", "twin")}
    sweeps = {k: c.ml.tree_sweep() for k, c in copies.items()}
    out = {}
    for k, c in copies.items():
        if k == "twin":
            mk.ml_posterior_sweep_ref(*c.ml._store(), sweeps[k].posteriors)
        elif k == "kernel":
            c.ml.recompute_ml_profiles(sweeps[k])
        else:
            per_level_recompute(c.ml)
    kern, lev, twin = (copies[k].ml for k in ("kernel", "levels", "twin"))
    diff = store_diff(kern, lev)
    if diff:
        raise AssertionError(f"ml_posterior_sweep {label}: {diff} differ "
                             "from the per-level launches'")
    rows = sweeps["kernel"].posteriors.targets
    err = 0.0
    for k in ("W", "V"):
        a = getattr(kern, k)[rows].cpu().numpy()
        b = getattr(twin, k)[rows].cpu().numpy()
        np.testing.assert_allclose(a, b, err_msg=f"ml_posterior_sweep "
                                   f"{label} {k} vs the twin", **TWIN_ROWS)
        err = max(err, float(np.max(np.abs(a - b))))
    if not np.array_equal(kern.codes.cpu().numpy(), twin.codes.cpu().numpy()):
        raise AssertionError(f"ml_posterior_sweep {label}: codes differ from "
                             "the twin's")
    out["ml_posterior_sweep"] = [err]

    # the tree log-likelihood, each copy on its own rows
    ll_k, site_k = kern.tree_loglk(sweeps["kernel"], want_site=True)
    ll_l, site_l = per_level_loglk(copies["levels"], want_site=True)
    ll_t, site_t = mk.ml_tree_loglk_ref(*twin._store(), sweeps["twin"].loglk,
                                        True)
    (ll_k, site_k), (ll_l, site_l), (ll_t, site_t) = (
        (float(a), b.cpu().numpy()) for a, b in ((ll_k, site_k),
                                                 (ll_l, site_l),
                                                 (ll_t, site_t)))
    sum_err = max(max_rel(ll_k, ll_l), max_rel(site_k, site_l))
    if not sum_err <= SUM_RTOL:
        raise AssertionError(f"ml_tree_loglk {label}: {sum_err:.3e} "
                             "relative from the per-level path's sums")
    diff = store_diff(kern, lev)
    if diff:
        raise AssertionError(f"ml_tree_loglk {label}: {diff} differ from the "
                             "per-level launches' (the root term's row)")
    np.testing.assert_allclose(site_k, site_t, err_msg=f"ml_tree_loglk "
                               f"{label} per-site sums vs the twin",
                               **TWIN_SITE)
    np.testing.assert_allclose(ll_k, ll_t, rtol=TWIN_SITE["rtol"],
                               err_msg=f"ml_tree_loglk {label} vs the twin")
    out["ml_tree_loglk"] = [max(abs(ll_k - ll_t),
                                float(np.max(np.abs(site_k - site_t))))]
    print(f"  [{label}] sweep: {sweeps['kernel'].posteriors.n_items} items "
          f"in {sweeps['kernel'].posteriors.n_levels} levels, rows bit for "
          f"bit the per-level launches', max abs err {err:.3e} against the "
          f"twin; tree LogLk: {sweeps['kernel'].loglk.n_pairs} pairs in "
          f"{sweeps['kernel'].loglk.n_levels} levels, total {ll_k!r} (per-"
          f"level {ll_l!r}), sums {sum_err:.3e} relative from the per-level "
          f"path's (bit for bit: total {ll_k == ll_l}, sites "
          f"{np.array_equal(site_k, site_l)}), {out['ml_tree_loglk'][0]:.3e}"
          " from the twin's")
    if not kernel_runs:
        return out, sweeps["kernel"]

    # times, on the kernel's copy: the kernels, their twins, the per-level
    # launches
    ml, sw = kern, sweeps["kernel"]
    P, C = ml.W.shape[1], ml.V.shape[2]
    n_pos = ml.n_pos
    store = ml._store()
    post = sw.posteriors
    levels_copy = copies["levels"]
    runs = (
        ("ml_posterior_sweep",
         lambda: mk.ml_posterior_sweep(*store, post),
         lambda: mk.ml_posterior_sweep_ref(*store, post),
         lambda: per_level_recompute(levels_copy.ml),
         sweep_bound(post, P, C, ml.jc)),
        ("ml_tree_loglk",
         lambda: mk.ml_tree_loglk(*store, sw.loglk, True),
         lambda: mk.ml_tree_loglk_ref(*store, sw.loglk, True),
         lambda: per_level_loglk(levels_copy, True),
         loglk_bound(sw.loglk, P, C, ml.jc, n_pos, True)))
    for name, fn, twin_fn, levels_fn, (bound_ms, bound_by) in runs:
        times = {"ms": median_ms(fn), "plain_ms": median_ms(twin_fn, 5),
                 "device_us": device_us(fn, DEVICE_NAMES[name]),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None, "per_level_ms": median_ms(levels_fn, 10)}
        out[name].append(times)
        print(f"  {name} [{label}]: {times['ms']:.4f} ms launch to launch, "
              f"{times['device_us']:.2f} us on the device; the per-level "
              f"launches {times['per_level_ms']:.4f} ms; twin "
              f"{times['plain_ms']:.3f} ms; bound {bound_ms:.4e} ms "
              f"({bound_by})")
    return out, sw


def phase_cat_sweep(report, dev):
    """The CAT fit and the tree log-likelihood as whole-tree launches
    (ml_posterior_sweep, ml_tree_loglk) against the per-level launches of
    ml_posterior and ml_pair_loglk: at the main shape (N=MAIN_N, P=MAIN_P,
    the port's NJ tree with ME lengths), Jukes-Cantor and GTR, the 20
    rates' per-site log-likelihoods of engine/ml.ml_site_likelihoods_by_rate
    within SUM_RTOL of per_level_site_likelihoods', the categories they
    give equal, the store's rows after the fit bit for bit and the tree
    LogLk within SUM_RTOL; the walls and launches of both fits; then one
    sweep and one tree log-likelihood (check_sweep) at the main shape with
    the fitted categories, and on a caterpillar of DEEP_N leaves (DEEP_N -
    1 levels), each timed: device us, launch to launch, the per-level
    launches, the twin and the bound."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.engine import ml as eml

    rates = eml.ml_site_rates(CAT_N)
    prior = 2.0 * np.log(rates) - 3.0 * rates
    for model in ("jc", "gtr"):
        label = f"N={MAIN_N} {model.upper()}"
        start = ml_start(MAIN_N, dev, model)
        fits = {}
        for name in ("kernels", "per-level"):
            nj = ml_copy(start, dev)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            site = eml.ml_site_likelihoods_by_rate(nj, rates) \
                if name == "kernels" else per_level_site_likelihoods(nj, rates)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in wrappers().items()
                        if fn.launches}
            fits[name] = (site, wall, launches, nj)
        (ks, kwall, kl, knj), (ps, pwall, pl, pnj) = fits["kernels"], \
            fits["per-level"]
        rel = max_rel(ks, ps)
        cats_k = np.argmax(ks + prior[:, None], axis=0)
        cats_p = np.argmax(ps + prior[:, None], axis=0)
        if not rel <= SUM_RTOL:
            raise AssertionError(f"CAT fit {label}: per-site log-likelihoods "
                                 f"{rel:.3e} relative from the per-level "
                                 "path's")
        if not np.array_equal(cats_k, cats_p):
            raise AssertionError(f"CAT fit {label}: "
                                 f"{int((cats_k != cats_p).sum())} categories"
                                 " differ from the per-level path's")
        diff = store_diff(knj.ml, pnj.ml)
        if diff:
            raise AssertionError(f"CAT fit {label}: {diff} differ from the "
                                 "per-level path's after the fit")
        ll_k = eml.tree_loglk(knj)
        ll_p = float(per_level_loglk(pnj)[0])
        ll_p = eml._jc_correct(pnj, ll_p)[0]
        if not max_rel(ll_k, ll_p) <= SUM_RTOL:
            raise AssertionError(f"tree LogLk {label}: {ll_k!r}, the "
                                 f"per-level path's {ll_p!r}")
        print(f"  CAT fit [{label}, {CAT_N} rates]: per-site log-likelihoods "
              f"{rel:.3e} relative from the per-level path's (bit for bit "
              f"{np.array_equal(ks, ps)}), categories equal "
              f"({len(np.unique(cats_k))} used), rows bit for bit; wall "
              f"{kwall:.4f} s ({kl}) against {pwall:.4f} s ({pl}); tree "
              f"LogLk {ll_k!r} (per-level {ll_p!r})")
        # one sweep and one tree log-likelihood at the fitted categories
        nj = ml_copy(start, dev)
        nj.ml.set_rates(rates / rates[cats_k].mean(), cats_k.astype(np.int32))
        out, _ = check_sweep(label + " CAT 20", nj, dev,
                             kernel_runs=model == "jc")
        for name, (err, *times) in out.items():
            entry = report.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if times:
                entry.update(times[0])
    for model in ("jc", "gtr"):
        label = f"caterpillar N={DEEP_N} {model.upper()} CAT 20"
        nj = shaped_start(DEEP_N, dev, "caterpillar", model)
        out, sw = check_sweep(label, nj, dev, kernel_runs=model == "jc")
        if sw.posteriors.n_levels < DEEP_N - 3:
            raise AssertionError(f"{label}: {sw.posteriors.n_levels} levels")
        for name, (err, *times) in out.items():
            entry = report.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if times:
                entry.update({f"deep_{k}": v for k, v in times[0].items()
                              if k in ("ms", "device_us", "per_level_ms",
                                       "bound_ms")})


# ------------------------------------------------------------- phases 3, 4
ALPHA = "ACGT"


def synth_codes(n, p, seed=0, n_codes=4):
    """The founder-mutation alignment of bench.py and bench_e2e.py (a copy
    of bench_e2e.synth_codes, so that this script imports nothing of the
    JAX side; tests/test_torch_nojax.py holds the two equal): n unique rows
    of p codes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_founders = max(4, n // 20)
    founders = rng.integers(0, n_codes, size=(n_founders, p))
    rows = founders[rng.integers(0, n_founders, size=n)]
    mut = rng.random((n, p)) < 0.1
    rows = np.where(mut, rng.integers(0, n_codes, size=(n, p)), rows)
    # a unique 16-position suffix per row, so that no row is a duplicate
    tag = ((np.arange(n)[:, None] >> np.arange(16)[None, :]) & 1) \
        .astype(rows.dtype)
    rows[:, -16:] = tag
    return rows.astype(np.int8)


def fasta_text(codes) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1} (as bench.py)."""
    return "".join(f">s{i}\n{''.join(ALPHA[c] for c in row)}\n"
                   for i, row in enumerate(codes))


def run_port(fasta, dev, **overrides):
    import torch

    from veryfasttree_tpu_torch.options import noml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    out = io.StringIO()
    t0 = time.perf_counter()
    nj, _ = run_pipeline(noml_options(**overrides), io.StringIO(fasta), out,
                         device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out.getvalue(), nj, time.perf_counter() - t0


def counted_run(fasta, dev, **overrides):
    """One run with every launch count set to 0 just before it; the counts
    read just after it."""
    reset_launches()
    nw, nj, wall = run_port(fasta, dev, **overrides)
    return nw, nj, wall, {name: fn.launches for name, fn in wrappers().items()}


def require_launched(label, counts, names):
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")


# the -noml path's kernels; the scans' bodies run inside nj_join_epoch's
# refreshes (require_scans), no longer as launches of their own
DENSE_PATH = ("me_dists", "me_average", "me_spr_round", "me_nni_round",
              "nj_join_epoch")


def require_scans(label):
    """The refresh scans of the run's join epoch (the bodies of nj_scan_dense
    and, in a two-tier store, of nj_scan_codes) ran: returns their count."""
    scans = wrappers()["nj_join_epoch"].totals["scans"]
    if scans == 0:
        raise AssertionError(f"{label}: the join epoch ran no refresh scan")
    return scans


def phase_golden(dev):
    from util import rf_distance

    with open(GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(GOLDEN + ".json") as f:
        golden_len = json.load(f)["total_len"]
    fasta = fasta_text(synth_codes(500, 500, seed=0))
    trees = {}
    for label, overrides in (("dense", {}), ("two-tier", {"two_tier_min": 0})):
        nw, nj, wall, counts = counted_run(fasta, dev, **overrides)
        rf, n_splits = rf_distance(nw, golden)
        print(f"  N=500 {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX "
              f"golden, byte-identical {nw == golden}, tree length "
              f"{nj.total_len():.6f} (golden {golden_len:.6f}), launches "
              f"{counts}")
        if rf != 0:
            raise AssertionError(f"{label}: RF {rf} to the golden tree")
        require_launched(label, counts, DENSE_PATH)
        require_scans(label)
        trees[label] = nw
    if trees["dense"] != trees["two-tier"]:
        raise AssertionError("two-tier and dense Newick differ")

    # the same input through the command line, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "n500.fasta")
        with open(path, "w") as f:
            f.write(fasta)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-noml",
             "-nosupport", "-quiet", path], cwd=REPO, capture_output=True,
            text=True, timeout=600, check=False)
    rf = rf_distance(res.stdout, golden)[0] if res.returncode == 0 else None
    print(f"  N=500 command line: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.2f} s, RF {rf} to the JAX golden, "
          f"byte-identical {res.stdout == golden}")
    if res.returncode != 0 or rf != 0:
        raise AssertionError(f"command line: exit {res.returncode}, RF {rf}"
                             f"\n{res.stderr[-2000:]}")


def phase_main(report, dev):
    """The N=2000 cell: a cold run, the warm run whose launches are the main
    path's, and a two-tier run for the codes scan's launches."""
    from util import newick_splits

    n = MAIN_N
    fasta = fasta_text(synth_codes(n, MAIN_P))
    runs = {}
    for label, overrides in (("cold", {}), ("warm", {}),
                             ("two-tier", {"two_tier_min": 0})):
        nw, nj, wall, counts = counted_run(fasta, dev, **overrides)
        t = nj.timings
        length = nj.total_len()
        print(f"  N={n} P={MAIN_P} {label}: wall {wall:.2f} s; NJ store "
              f"{t['store_s']:.3f} s, top-hits {t['tophits_s']:.3f} s, joins "
              f"{t['joins_s']:.3f} s ({(n - 3) / t['joins_s']:.1f} joins/s); "
              f"ME NNI {t['nni_s']:.3f} s, SPR {t['spr_s']:.3f} s, lengths "
              f"{t['lengths_s']:.3f} s, split test {t['splits_s']:.3f} s; "
              "tree length "
              f"{length:.6f}; launches {counts}")
        _, leaves = newick_splits(nw)
        if len(leaves) != n or not math.isfinite(length):
            raise AssertionError(f"{label}: {len(leaves)} leaves, length "
                                 f"{length}")
        runs[label] = nw
        if label == "warm":                  # the -noml main path's run
            require_launched(label, counts, DENSE_PATH)
            scans = require_scans(label)
            epoch = wrappers()["nj_join_epoch"].totals
            print(f"  nj_join_epoch in the warm run: "
                  f"{counts['nj_join_epoch']} launches, {epoch['joins']} "
                  f"joins, {epoch['phases']} phases, {scans} refresh scans "
                  f"of {epoch['scan_rows']} rows (the scan kernels' bodies)")
            for name in ("nj_scan_dense", "nj_scan_codes"):
                report.setdefault(name, {})["epoch_scans"] = scans
            spr = wrappers()["me_spr_round"].totals
            P, C = nj.prof.W.shape[1], nj.prof.U.shape[2]
            rounds = counts["me_spr_round"]
            # at most every node row and its up-profile read once and
            # written once per round
            n_bytes = 4 * nj.tree.maxnode * P * (4 * C + 5)
            ms_ops = 1e3 * spr_ops(spr, P, C) / rounds / F32_OPS_PER_S
            print(f"  me_spr_round in the warm run: {spr['nodes']} nodes, "
                  f"{spr['quartets']} chain steps and BIONJ weights "
                  f"(quartets), {spr['rows_averaged']} rows averaged, "
                  f"{spr['n_spr']} SPR moves; per round, operations "
                  f"{ms_ops:.4e} ms, bytes at most "
                  f"{1e3 * n_bytes / HBM_BYTES_PER_S:.4e} ms")
            nni = wrappers()["me_nni_round"].totals
            rounds = counts["me_nni_round"]
            print(f"  me_nni_round in the warm run: {rounds} rounds, "
                  f"{nni['quartets']} quartets, {nni['rows_averaged']} rows "
                  f"averaged, {nni['n_nni']} NNIs; per round, operations "
                  f"{1e3 * spr_ops(nni, P, C) / rounds / F32_OPS_PER_S:.4e}"
                  f" ms; launches beside it: me_average "
                  f"{counts['me_average']}, me_dists {counts['me_dists']}")
            for name, count in counts.items():
                if name not in ML_KERNELS:
                    report.setdefault(name, {})["launches"] = count
        elif label == "two-tier":
            report["nj_scan_codes"]["two_tier_epoch_scans"] = \
                require_scans(label)
    if runs["two-tier"] != runs["cold"] or runs["warm"] != runs["cold"]:
        raise AssertionError("the three runs gave different trees")


# ------------------------------------------------------------- phases 5, 6
ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def run_ml(fasta, dev, **overrides):
    """One ML run through run_pipeline with every launch count set to 0
    just before it.  Returns (newick, nj, wall, counts, per-round
    (LogLk, NNIs), final LogLk); the LogLk values are the run's log
    lines."""
    import torch

    from veryfasttree_tpu_torch.options import ml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    out, log = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    nj, _ = run_pipeline(ml_options(**overrides), io.StringIO(fasta), out,
                         log_fp=log, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    text = log.getvalue()
    rounds = [(float(ll), int(n)) for _, ll, n in ROUND.findall(text)]
    return out.getvalue(), nj, wall, counts, rounds, \
        float(FINAL.findall(text)[-1])


def busy_share(trace, wall):
    """(device-busy seconds, share of wall, event count, top kernels) of a
    CUDA-activity trace."""
    import torch

    count, total = collections.Counter(), collections.Counter()
    for evt in trace.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            count[evt.name] += 1
            total[evt.name] += evt.time_range.elapsed_us()
    busy = sum(total.values()) / 1e6
    return busy, busy / wall, sum(count.values()), \
        [(name[:60], count[name], us / 1e3) for name, us
         in total.most_common(6)]


def phase_ml_golden(dev):
    """The default -nt run and -nt -gtr -gamma at N=200 against the JAX
    package's; the default run is traced for the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from util import rf_distance

    fasta = fasta_text(synth_codes(ML_GOLDEN_N, MAIN_P, seed=0))
    for suffix, overrides in (("", {}), ("_gtr_gamma", {
            "use_gtr": True, "gamma_loglk": True})):
        with open(ML_GOLDEN + suffix + ".nwk") as f:
            golden = f.read()
        with open(ML_GOLDEN + suffix + ".json") as f:
            meta = json.load(f)
        label = f"N={ML_GOLDEN_N} {'-gtr -gamma' if suffix else 'default -nt'}"
        if suffix:
            nw, nj, wall, counts, rounds, final = run_ml(fasta, dev,
                                                         **overrides)
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                nw, nj, wall, counts, rounds, final = run_ml(fasta, dev)
            busy, share, n_events, top = busy_share(trace, wall)
            print(f"  {label} under torch.profiler: device busy {busy:.3f} s "
                  f"of {wall:.2f} s wall ({100 * share:.2f}%), {n_events} "
                  f"device events; top {top}")
        rf, n_splits = rf_distance(nw, golden)
        rel = abs(final - meta["final_loglk"]) / abs(meta["final_loglk"])
        diffs = [round(a[0] - b, 3) for a, b in zip(rounds,
                                                    meta["round_loglk"])]
        print(f"  {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX golden, "
              f"final LogLk {final:.3f} (golden {meta['final_loglk']:.3f}, "
              f"rel diff {rel:.2e}); ML-NNIs per round {[r[1] for r in rounds]}"
              f" (golden {meta['round_nnis']}); per-round LogLk - golden "
              f"{diffs}; launches {counts}")
        if rf != 0 or not rel <= 1e-4:
            raise AssertionError(f"{label}: RF {rf}, final LogLk rel diff "
                                 f"{rel:.2e}")

    # the default run through the command line, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "n200.fasta")
        with open(path, "w") as f:
            f.write(fasta)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-quiet",
             path], cwd=REPO, capture_output=True, text=True, timeout=600,
            check=False)
    with open(ML_GOLDEN + ".nwk") as f:
        golden = f.read()
    rf = rf_distance(res.stdout, golden)[0] if res.returncode == 0 else None
    print(f"  N={ML_GOLDEN_N} command line -nt: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.2f} s, RF {rf} to the JAX golden")
    if res.returncode != 0 or rf != 0:
        raise AssertionError(f"command line: exit {res.returncode}, RF {rf}"
                             f"\n{res.stderr[-2000:]}")


def launches_during(fn, owner, name):
    """Run fn() noting each kernel's launches during the calls of
    owner.name (a method or a module's function), summed over its calls:
    returns (fn's result, launches, the first argument of its last
    call)."""
    orig, launches, firsts = getattr(owner, name), collections.Counter(), []

    def traced(*a, **k):
        before = {n: w.launches for n, w in wrappers().items()}
        out = orig(*a, **k)
        launches.update({n: w.launches - before[n]
                         for n, w in wrappers().items()})
        firsts.append(a[0] if a else None)
        return out

    setattr(owner, name, traced)
    try:
        return fn(), dict(launches), (firsts[-1] if firsts else None)
    finally:
        setattr(owner, name, orig)


def sh_launches(fn):
    """Run fn() noting each kernel's launches during the SH pass
    (ops/ml_round.SHPass.run): returns (fn's result, launches, the
    pass)."""
    from veryfasttree_tpu_torch.ops import ml_round

    return launches_during(fn, ml_round.SHPass, "run")


def cat_launches(fn):
    """Run fn() noting each kernel's launches during the CAT fit
    (engine/ml.set_ml_rates): returns (fn's result, launches)."""
    from veryfasttree_tpu_torch.engine import ml

    return launches_during(fn, ml, "set_ml_rates")[:2]


def phase_ml_main(report, dev):
    """The default -nt run at N=2000: the ML main path."""
    from util import newick_splits

    n = MAIN_N
    ((nw, nj, wall, counts, rounds, final), cat), sh, sh_pass = sh_launches(
        lambda: cat_launches(
            lambda: run_ml(fasta_text(synth_codes(n, MAIN_P)), dev)))
    t = nj.timings
    nj_s = t["store_s"] + t["tophits_s"] + t["joins_s"]
    print(f"  N={n} P={MAIN_P} default -nt: wall {wall:.2f} s; NJ {nj_s:.3f} "
          f"s, ME NNI {t['nni_s']:.3f} s, SPR {t['spr_s']:.3f} s, ME lengths "
          f"{t['lengths_s']:.3f} s, ML lengths {t['ml_lengths_s']:.3f} s, ML "
          f"NNI {t['ml_nni_s']:.3f} s ({len(rounds)} rounds), CAT "
          f"{t['cat_s']:.3f} s, SH {t['sh_s']:.3f} s; final LogLk "
          f"{final:.3f}; ML-NNIs per round {[r[1] for r in rounds]}; "
          f"launches {counts}")
    _, leaves = newick_splits(nw)
    if len(leaves) != n or not math.isfinite(final):
        raise AssertionError(f"{len(leaves)} leaves, final LogLk {final}")
    if f"{final:.3f}" != ML_MAIN_LOGLK:
        raise AssertionError(f"final LogLk {final:.3f}, recorded "
                             f"{ML_MAIN_LOGLK}")
    require_launched("ML main path", counts, DENSE_PATH + ML_PATH)
    from veryfasttree_tpu_torch.ops import ml_round

    rounds_t, pass_t = (wrappers()[k].totals
                        for k in ("ml_nni_round", "ml_lengths_pass"))
    print(f"  ML round kernels in the run: ml_nni_round "
          f"{counts['ml_nni_round']} launches ({rounds_t['quartets']} quartet "
          f"optimizations, {rounds_t['n_ml_nni']} NNIs), ml_lengths_pass "
          f"{counts['ml_lengths_pass']} launches ({pass_t['searches']} line "
          f"searches), the tree in {ml_round.ml_nni_round.tree_layout}, "
          f"{ml_round.ml_nni_round.scratch_floats} floats of device scratch, "
          f"{rounds_t['speculative']} speculative AC/AD optimizations "
          "discarded; "
          f"launches beside them: ml_quartet_opt {counts['ml_quartet_opt']}, "
          f"ml_opt_branch {counts['ml_opt_branch']} (its body ran "
          f"{rounds_t['searches'] + pass_t['searches']} line searches inside "
          f"the round kernels), ml_posterior {counts['ml_posterior']}, "
          f"ml_pair_loglk {counts['ml_pair_loglk']}")
    if (ml_round.ml_nni_round.tree_layout,
            ml_round.ml_nni_round.scratch_floats) != ("shared memory", 0):
        raise AssertionError(
            "the ML NNI rounds kept the tree in "
            f"{ml_round.ml_nni_round.tree_layout} with "
            f"{ml_round.ml_nni_round.scratch_floats} floats of device "
            "scratch at the main path's shape")
    # the SH pass on the card: the counts, one posterior launch per
    # up-profile level and one of the AB posteriors, one pair launch, the
    # AC/AD quartets and the second pass
    work = sh_work(sh_pass)
    print(f"  SH pass in the run: sh_s {t['sh_s']:.3f} s, "
          f"{sh_pass.S} splits, {work['levels']} up-profile "
          f"levels ({work['up_rows']} rows), {work['again']} optimized "
          f"again; launches {({k: v for k, v in sh.items() if v})}")
    want = {"sh_resample_counts": 1, "ml_pair_loglk": 1, "ml_posterior": 1,
            "ml_posterior_sweep": 1,
            "ml_quartet_opt": 1 + (work["again"] > 0)}
    if any(sh.get(k) != v for k, v in want.items()) \
            or sum(sh.values()) != sum(want.values()):
        raise AssertionError(f"the SH pass launched {sh}, not {want}")
    # the CAT fit: a sweep and a tree log-likelihood per rate, a sweep
    # back at one rate and one at the fitted rates, and nothing per level
    want = {"ml_posterior_sweep": CAT_N + 2, "ml_tree_loglk": CAT_N}
    print(f"  CAT fit in the run: cat_s {t['cat_s']:.3f} s; launches "
          f"{({k: v for k, v in cat.items() if v})}")
    if any(cat.get(k) != v for k, v in want.items()) \
            or sum(cat.values()) != sum(want.values()):
        raise AssertionError(f"the CAT fit launched {cat}, not {want}")
    # the whole run: the per-level kernels only in the SH pass's lists; a
    # tree log-likelihood after each ML NNI round, per CAT rate and after
    # the last lengths pass
    want = {"ml_posterior": 1, "ml_pair_loglk": 1,
            "ml_posterior_sweep": CAT_N + 3,
            "ml_tree_loglk": CAT_N + len(rounds) + 1}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError("the run launched "
                             f"{ {k: counts[k] for k in want} }, not {want}")
    nnis = [r[1] for r in rounds]
    if nnis != ML_MAIN_NNIS:
        raise AssertionError(f"ML-NNIs per round {nnis}, recorded "
                             f"{ML_MAIN_NNIS}")
    for name, count in counts.items():
        key = "launches" if name in ML_KERNELS else "ml_path_launches"
        report.setdefault(name, {})[key] = count


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "veryfasttree_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (no "
              "veryfasttree_tpu_torch/ beside it)", file=sys.stderr)
        return 2
    for sub in ("", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    from veryfasttree_tpu_torch.ops import _build

    failed = []
    report = {}

    def phase(label, fn, *a):
        print(f"[{label}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*a)
        except Exception:  # noqa: BLE001 -- report, go on, fail at the end
            traceback.print_exc()
            failed.append(label)
        print(f"[{label}] {'FAILED' if label in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def card():
        print(f"  {card_line()}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s)")
        torch.use_deterministic_algorithms(True)

    def build():
        t0 = time.perf_counter()
        path, log = _build.build(force=True)
        print(f"  built {os.path.relpath(path, REPO)} in "
              f"{time.perf_counter() - t0:.1f} s")
        print("\n".join("  " + line for line in log.splitlines()
                        if "registers" in line or "Function properties" in line
                        or "Compiling entry" in line or "stack frame" in line))
        _build.library()
        report = _build.ptxas_report(log)
        for kernel in _build.STACK_LIMITS:
            print(f"  {kernel}<4>: "
                  f"{_build.kernel_resources(report, kernel)}")
        faults = _build.resource_faults(report)
        if faults:
            raise AssertionError("; ".join(faults))

    phase("0 card", card)
    phase("1 build", build)
    if "1 build" not in failed:
        phase("2 kernels vs twins", phase_kernels, report)
        cuda = torch.device("cuda")
        phase("2b SPR round vs host loop", phase_spr, report, cuda)
        phase("2c NNI round vs host loop", phase_nni, report, cuda)
        phase("2d join epoch vs host loop", phase_epoch, report, cuda)
        phase("2e ML round and lengths pass vs host loop", phase_ml_round,
              report, cuda)
        phase("2f SH pass vs host loop", phase_sh, report, cuda)
        phase("2g CAT sweep and tree LogLk vs per-level launches",
              phase_cat_sweep, report, cuda)
        phase("3 N=500 vs JAX golden", phase_golden, cuda)
        phase(f"4 main path N={MAIN_N}", phase_main, report, cuda)
        phase(f"5 ML N={ML_GOLDEN_N} vs JAX golden", phase_ml_golden, cuda)
        phase(f"6 ML main path N={MAIN_N}", phase_ml_main, report, cuda)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **report[name]}
               for name, (source, replaces) in KERNELS.items()]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
