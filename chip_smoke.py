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
   for the ML kernels' 20-code templates the limits of
   _build.STACK_LIMITS_20 (the lengths pass and the quartet kernel no
   stack and no spills, the NNI round at most 8 bytes of stack); the
   constrained instantiations (the *_cons_kernel entries) at most what
   their builds reached;
2. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with the median time of 50 runs of each (CUDA events):
   the scans and the pair distances in double (rtol 1e-12, atol 1e-12; best
   index equal), the profile average bit-identical (rtol 1e-6 in BLOSUM45
   matrix mode).  The code scan (L=20000, P=512 at 4 and 20 codes, and
   P=1536 at 20, two tiles of its query table) also bit for bit the numpy
   replay of its lane order (codes_lane_replay): dist, denom, crit and the
   best index.
   The ML store's kernels (ml_pair_loglk, ml_posterior, ml_opt_branch)
   against theirs on a store of the N=2000 layout (12008 rows of 512
   positions), Jukes-Cantor and GTR with 4 codes and JTT with 20: ll and
   per-site lk rtol 1e-6, posterior W and V atol 1e-6, line search x rtol
   1e-4 and -loglk at x atol 1e-3; a list of 300 pairs and one of 200
   posteriors (past the old caps of a launch, 256 and 128) also bit for bit
   their K=1 launches, and both timed at the SH pass's list shapes
   (3 x 1997 pairs, 2 x 1997 posteriors).  The ME whole-tree kernels on
   the port's NJ tree at N=2000 (dense): me_average_sweep (the 1,997
   up-profiles of the split test and the ME lengths) bit for bit the
   per-level launches of me_average and one me_average launch per
   up-profile, codes equal and W, U within 1e-12 of its twin;
   me_dists_list (the split test's 11,982 pairs, quartet by quartet) bit
   for bit me_dists' calls of six pairs, within 1e-12 of its twin; each
   also timed against those per-call paths; me_dist_pieces_list (the
   local bootstrap's per-position pieces and weights, float32) bit for bit
   its twin on that list, on the same list of a two-tier store and on
   random pairs of a C=20 BLOSUM45 store, timed beside the bootstrap's
   float64 products with the resample counts (cuBLAS, printed apart).
   The quartet kernel (ml_quartet_opt) on
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
   case and the bound; then the N=2000 join phase, dense and two-tier,
   through a build of the epoch kernel with its clock64 probes (built
   beside phase 1's, csrc/probes.cuh): the refresh scans' time, which in
   the two-tier store read the leaf rows with the code scan's body;
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
   equal to its twin at B=1000, P=500 and P=5000, both timed;
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
   1e-4); each kernel's device time beside its time before the chain
   redesign (OLD_SWEEP_US), its time per level, launch-to-launch time, the
   per-level launches' time, the twin's and the bound; and the SH pass's
   up-profile sweep over the N=2000 tree (top-down: a parent's up-profile
   read by two chains; check_fan_out), its rows and weighted rough/exact
   counts bit for bit per_level_sweep's, within the twin's tolerance of
   the twin, timed;
2h. the ME branch lengths, then the split test, at N=2000 from the port's
   NJ tree, dense and two-tier: the whole-tree path
   (batched.update_branch_lengths_batched,
   supports.test_splits_min_evo_batched: one me_average_sweep and one
   me_dists_list launch each, one fetch) against the serial walks through
   the per-call kernels (rearrange.update_branch_lengths,
   supports.test_splits_min_evo): the SplitCount, the debug counters and
   every branch length bit for bit; the walls and launches of both;
2i. the ME local bootstrap at N=2000 from the port's NJ tree (1000
   resamples): the whole-tree path (supports.reliability_nj_list: one
   sweep, one me_dist_pieces_list launch, the float64 products and the
   decisions on the card) against the serial walk
   (supports.reliability_nj, a six-pair list a split): every support and
   the count of suboptimal splits equal; the walls, launches and the
   splits re-decided on the host;
3. the -noml pipeline at N=500, P=500 against the JAX package's tree
   (tests/data/torch_port_golden_n500_p500.nwk), dense and two-tier: RF 0
   to the golden, and the two layouts give the same Newick; against the
   JAX package's outputs of scripts/make_torch_port_noml_golden.py
   (tests/data/torch_port_noml_golden_n500_p500.*): -nt -noml with its
   1000-resample supports, dense and two-tier, byte-identical; -makematrix
   (dense and two-tier, one nj_scan_dense or nj_scan_codes launch a
   sequence), the SHA-256 of its output equal; -intree from the N=500
   golden tree, byte-identical, no NJ launch; then the same input through
   the command line (python -m veryfasttree_tpu_torch -nt -noml -threads
   1, the thread count pinned so that the host's OMP_NUM_THREADS cannot
   move it), RF 0 to the golden and byte-identical to the supports golden;
4. the -noml main path: full -nt -noml -nosupport at N=2000, P=500 (the
   bench.py input) through run_pipeline, cold, then warm, then once more
   with the two-tier store forced on (-two-tier-min 0), which must give the
   same tree; the warm run's Newick SHA-256 must begin as recorded
   (NOML_MAIN_SHA).  The kernel launch counts are reset just before the warm run
   and read just after it: each kernel of the dense path must have
   launched, the single-call me_average never (the ME lengths and the
   split test take one me_average_sweep and one me_dists_list launch
   each, and no more), and me_dists only in the NJ phase (NJ_DISTS_CALLS).
   The scans run inside the join epoch's refreshes, so its
   refresh scans must be nonzero there (and in the two-tier run, where the
   leaf rows take the codes scan's body); then one -nt -noml run with
   the local bootstrap's supports (1000 resamples), its wall, split test
   and bootstrap time: the same tree, and the bootstrap in one
   me_dist_pieces_list and one sh_resample_counts launch beside the
   lengths' and split test's two sweeps and two lists;
5. the ML phase against the JAX package's trees at N=200, P=500
   (tests/data/torch_port_ml_golden_n200_p500*): the default -nt run (ML
   NNIs, CAT 20, SH-like supports from 1000 resamples) and -nt -gtr
   -gamma, each RF 0 to its golden and final LogLk within 1e-4 relative,
   with the per-round LogLk differences printed; the default run is traced
   with torch.profiler for the device's busy share; then the default run
   through the command line (python -m veryfasttree_tpu_torch -nt -threads
   1), RF 0 to its golden;
6. the ML main path: the full default -nt run at N=2000, P=500 through
   run_pipeline (warm: phase 5 ran the same code), with its phase split and
   final LogLk.  The launch counts are reset just before it and read just
   after it: every kernel of the dense path, the ML kernels included, must
   have launched (but ml_opt_branch, whose body runs inside the round
   kernels: its count, 0, is printed), the ML NNI rounds must have kept the
   tree in shared memory with no device scratch, the SH pass must have run
   on the card in its list launches (sh_launches: the counts once, one pair
   launch, one or two quartet launches, one sweep of the up-profiles and
   one posterior launch), and the final LogLk, the Newick SHA-256
   (ML_MAIN_SHA) and the ML-NNIs per round must be the ones recorded in
   PERF.md for this input (the kernels' arithmetic
   does not change the tree).  The CAT fit (cat_launches) must launch 22
   sweeps and 20 tree log-likelihoods and nothing else, and the whole run
   ml_posterior and ml_pair_loglk only once each (the SH pass's lists).
2j. the ML kernels at 20 codes (protein): one ML lengths pass, then one
   ML NNI round, at N=500 (JTT, CAT 20 rates fitted to the port's NJ tree
   of a protein alignment) through ml_lengths_pass<20> and
   ml_nni_round<20> (one launch each, the quartet temporaries in device
   scratch) against the host loops with the per-call kernels (tree,
   lengths, NNIStats, counters, rough/exact counts and rows bit for bit)
   and against the plain twins on the CPU (the pass's tree LogLk within
   1e-5 relative; the round's decisions equal up to a flip where the
   quartet's two choices lie closer than the two runs' criteria for it,
   reported with its margins, and then its LogLk within 1e-4); the
   rough-posterior gate (-approxml) in an ml_posterior list of the SH
   pass's shape against its twin, the rough/exact counts equal; one
   ml_posterior_sweep<20> and ml_tree_loglk<20> with the gate on over a
   balanced tree of 2000 leaves and a caterpillar of 600 leaves against
   the per-level launches (rows bit for bit, counts equal) and the twins;
   each timed with its bound and its time before the redesign;
7a. protein ML against the JAX package's trees at N=200, P=300
   (tests/data/torch_port_protein_ml_golden_n200_p300*, from
   scripts/make_torch_port_protein_golden.py): the default run (JTT, CAT
   20, SH-like supports from 1000 resamples), -lg -gamma and -approxml,
   each RF 0 to its golden and final LogLk within 1e-4 relative, with the
   ML-NNIs per round and the approximate-posteriors share printed beside
   the golden's;
7b. the protein ML main path: the default protein run at N=5000, P=400
   (synth_codes(5000, 400, seed=0, n_codes=20); BASELINE.json's ~5k-taxa
   JTT+CAT config), warm, with its phase split, final LogLk, ML-NNIs per
   round and approximate-posteriors share.  The launch counts are reset
   just before it and read just after it: ml_nni_round and
   ml_lengths_pass launched (at 20 codes; their scratch and tree layout
   printed), ml_posterior and ml_pair_loglk only in the SH pass's lists,
   the CAT fit in whole-tree sweeps only.
8. -constraints (16 columns of cons_columns: half following the founder
   groups, half random bipartitions, 15% '-'): at N=500 the join phase
   through the constrained epoch kernel (nj_epoch_cons_kernel), one ME NNI
   round, one SPR round and one ML NNI round (at 4 codes and, on a
   protein start of N=300, at 20) through their constrained kernels, each
   against its host loop with the per-call kernels, bit for bit (join
   log, tree, rows, counters, NNIStats, counts; the ME deltas and
   supports within log1p's last bit carried into criteria as large as the
   penalties), and both split tests' SplitCount (the list against the
   serial walk, the SH pass against the host loop); each constrained
   kernel's device time; the -nt -noml run at N=500 byte-identical to the
   JAX package's (tests/data/torch_port_constraints_golden_n500_p500.nwk)
   and the default run at N=200 RF 0 and final LogLk within 1e-4
   relative (torch_port_constraints_ml_golden_n200_p500); then -nt -noml
   and -nt at N=2000, P=500, warm, the launch counts reset just before
   each: the constrained kernels launched, the phase split, SplitCount
   and wall beside the unconstrained runs of phases 4 and 6.
9. -threads (the batched tier: engine/batched.py, engine/spr_batched.py).
   (a) From one N=500 NJ start, each batched function on the card, then
   against its plain twins on the CPU, one process each (chip_smoke.py
   --twins, from the card's start), which run beside (b) and no timed
   phase: an ME NNI round and a partitioned SPR round at -threads 8 and
   12 (tree, rows, NNIStats ages, counters and lockstep steps equal, the
   deltas and supports within THREADS_DELTA_ATOL); the ML lists that read
   their lengths on the device (ml_posterior and ml_opt_branch with bl=)
   bit for bit the host-length lists on the card, and against the twins
   (rows within TWIN_ROWS, the searches' optima within ML_TWIN_NEAR_TIE);
   an ML lengths pass (the tree LogLk within THREADS_PASS_RTOL; the
   lengths, which float32 line searches carry from search to search,
   reported against 1e-4 + 2e-3 x length); an ML NNI round (the criteria
   within THREADS_CRIT_TOL, a flip only on a near tie, reported with its
   margins; without one the tree, ages and NNIs equal and the tree LogLk
   within THREADS_ROUND_RTOL, with one within ML_TWIN_RTOL); the ML split
   test (the SH pass; the SplitCount's counts equal, its worst delta
   within THREADS_CRIT_TOL).  (b) The JAX package's -threads 8 trees
   (scripts/make_torch_port_threads_golden.py): -nt -noml at N=500
   byte-identical; the default run at N=200 RF 0, or parting from the
   golden at a batched ML NNI decision that is a near tie in both
   packages (the golden's _decisions.json), reported with its
   margins, and the final LogLk within 1e-4 relative.  (c) -nt -threads 8
   and -nt -noml -threads 8 at N=500, P=500 (THREADS_MAIN),
   warm, the launch counts reset just before each run and read just after
   it:
   me_dists_list, me_average_sweep and the join epoch with its refresh
   scans launched in both, ml_quartet_opt, ml_opt_branch and ml_posterior
   in the default run, and none of the serial round kernels
   (me_nni_round, me_spr_round, ml_nni_round, ml_lengths_pass); the phase
   split, wall, Newick SHA-256 and final LogLk beside phases 4 and 6, and
   the lockstep SPR's steps.
10. The last single-card modules.  (a) -checkpoint: the default -nt run
   at N=2000, P=500 stopped just after round 3's save, then resumed in a
   fresh run_pipeline and, from a copy of that file, through the command
   line: both give phase 6's Newick SHA-256, final LogLk and ML-NNIs; each
   save's fetch and write time and bytes, and one compressed save's.
   (b) The fused join step: -nt -noml -fastest at N=2000 with the unfused
   host loop (VFT_FUSED_JOIN=0's) and fused, the launch counts reset
   before each: the fused run launches nj_join_step and no join epoch, and
   the two end states (join log, tree, per-node arrays, store rows,
   out-profile, top-hits state, counters) and Newicks are bit for bit
   equal; joins_s and wall of each; nj_join_step against its twin on one
   join of that run (packed result rtol 1e-12, the new row and the
   out-profile bit for bit), timed with its bound; -fastest and -2nd at
   N=500 byte-identical to the JAX package's trees
   (tests/data/torch_port_{fastest,2nd}_golden_n500_p500.nwk, from
   scripts/make_torch_port_fastest_golden.py).  (c) VFT_TRACE on the
   default -nt run at N=60: the trace holds CUDA kernel events and the
   phases' annotations; which whole-tree kernels it shows.
11. Multi-GPU (parallel/).  (a) The partial modes of the scans
   (nj_scan_dense_partial, nj_scan_codes_partial) and of the pair kernels
   (me_dists_partial, me_dists_list_partial) against their twins at
   phase 2's shapes, and at k = 1 partial then finish (nj_scan_finish,
   me_pair_finish) the fused kernels' results bit for bit; over two
   blocks of positions the finishes against their twins (dist and denom
   bit for bit) and the fused results within TOL; timed.  (b) -nt -noml
   at N=500 over ranks through run_pipeline (chip_smoke.py --mesh-rank,
   one process a rank: NCCL over min(cards, 4) ranks, or on one card two
   ranks on cuda:0 over gloo), each rank's Newick byte-identical to the
   -noml JAX golden and its tree printed without supports to the
   -nosupport one (-nosupport only skips the bootstrap at the end), its
   store p_pad / ranks positions wide, the partial kernels launched and no
   whole-row kernel; the wall, phase split, exchanges and their host-clock
   ms a call, beside the same run on one card through the same host loops
   (a 1 x 1 mesh) where the smoke has run under MESH_SINGLE_BY_S.

The last lines are the card's name and power limit, one JSON line with each
kernel's route, source, main-path launches (the ML main path's for the ML
kernels, the -noml one's for the others, with their ML-path and two-tier
launches apart; the "<20>" entries the protein main path's), error, times
and bound, and the result line.  Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import collections  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
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
NOML_GOLDEN = os.path.join(REPO, "tests", "data",
                           "torch_port_noml_golden_n500_p500")
MAIN_N, MAIN_P = 2000, 500          # bench.py's input
ML_GOLDEN_N = 200
# protein ML: the JAX package's goldens (scripts/make_torch_port_protein_
# golden.py) and the main path, BASELINE.json's ~5k-taxa JTT+CAT config
PROTEIN_GOLDEN = os.path.join(REPO, "tests", "data",
                              "torch_port_protein_ml_golden_n200_p300")
PROTEIN_GOLDEN_N, PROTEIN_GOLDEN_P = 200, 300
# -approxml's rough and exact counts against the golden's, relative: the
# runs' line searches take their own numbers of evaluations (1.5e-4 and
# 2.2e-4 read on the H100)
PROTEIN_COUNT_RTOL = 1e-3
PROTEIN_N, PROTEIN_P = 5000, 400

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
    "me_average_sweep": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                         "veryfasttree_tpu/engine/profiles.py:375"),
    # the same XLA function as me_dists, over a whole list (dist_pairs :708)
    "me_dists_list": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                      "veryfasttree_tpu/engine/profiles.py:244"),
    # the local bootstrap's pieces (_dist_pieces, via dist_pieces_pairs :718)
    "me_dist_pieces_list": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                            "veryfasttree_tpu/engine/profiles.py:293"),
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
    # the fused join of the host join loop (-fastest, -2nd): XLA's
    # _fused_join, not a Pallas kernel
    "nj_join_step": ("veryfasttree_tpu_torch/csrc/nj_join.cu",
                     "veryfasttree_tpu/engine/fused.py:56"),
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
    # the 20-code launches of the protein main path (phase 7b), each with
    # the rough-posterior gate of posterior_matrix
    # (veryfasttree_tpu/ops/kernels.py:267) in its posteriors
    "ml_nni_round<20>": ("veryfasttree_tpu_torch/csrc/ml_round.cu",
                         "veryfasttree_tpu/engine/rearrange.py:246"),
    "ml_lengths_pass<20>": ("veryfasttree_tpu_torch/csrc/ml_round.cu",
                            "veryfasttree_tpu/engine/ml.py:380"),
    "ml_posterior_sweep<20>": ("veryfasttree_tpu_torch/csrc/ml_sweep.cu",
                               "veryfasttree_tpu/engine/ml_profiles.py:123"),
    "ml_tree_loglk<20>": ("veryfasttree_tpu_torch/csrc/ml_sweep.cu",
                          "veryfasttree_tpu/engine/ml.py:299"),
    "ml_posterior<20>": ("veryfasttree_tpu_torch/csrc/ml_lk.cu",
                         "veryfasttree_tpu/engine/ml_profiles.py:77"),
    # the mesh path's kernels (phase 11): the partial modes of the scans
    # and the pair kernels, and their finishes
    "nj_scan_dense_partial": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                              "veryfasttree_tpu/ops/pallas_kernels.py:38"),
    "nj_scan_codes_partial": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                              "veryfasttree_tpu/ops/pallas_kernels.py:173"),
    "nj_scan_finish": ("veryfasttree_tpu_torch/csrc/nj_scan.cu",
                       "veryfasttree_tpu/ops/pallas_kernels.py:38"),
    "me_dists_partial": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                         "veryfasttree_tpu/engine/profiles.py:244"),
    "me_dists_list_partial": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                              "veryfasttree_tpu/engine/profiles.py:244"),
    "me_pair_finish": ("veryfasttree_tpu_torch/csrc/me_store.cu",
                       "veryfasttree_tpu/engine/profiles.py:244"),
}
# the wrapper each 20-code entry of KERNELS counts
PROTEIN_KERNELS = {k: k[:-len("<20>")] for k in KERNELS if k.endswith("<20>")}
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
    "me_dists_list": ("me_pair_list_kernel",),
    "me_dist_pieces_list": ("me_pieces_list_kernel",),
    "me_average_sweep": ("me_average_sweep_kernel",),
    "ml_pair_loglk": ("ml_pair_loglk_kernel",),
    "ml_posterior": ("ml_posterior_kernel",),
    "ml_opt_branch": ("ml_opt_branch_kernel",),
    "ml_quartet_opt": ("ml_quartet_opt_kernel",),
    "me_spr_round": ("me_spr_round_kernel",),
    "me_nni_round": ("me_nni_round_kernel",),
    "nj_join_epoch": ("nj_epoch_kernel",),
    "nj_join_step": ("nj_join_step_kernel",),
    "ml_nni_round": ("ml_nni_round_kernel",),
    "ml_lengths_pass": ("ml_lengths_pass_kernel",),
    "sh_resample_counts": ("sh_resample_counts_kernel",),
    "ml_posterior_sweep": ("ml_posterior_sweep_kernel",),
    "ml_tree_loglk": ("ml_tree_loglk_kernel",),
    "nj_scan_dense_partial": ("nj_scan_dense_kernel",),
    "nj_scan_codes_partial": ("nj_scan_codes_kernel",),
    "nj_scan_finish": ("nj_scan_finish_kernel", "argmin_partials_kernel"),
    "me_dists_partial": ("me_pair_dist_kernel",),
    "me_dists_list_partial": ("me_pair_list_kernel",),
    "me_pair_finish": ("me_pair_finish_kernel",),
}
# final LogLk and ML-NNIs per round of the default -nt run at N=2000
# (PERF.md, section 5)
ML_MAIN_LOGLK = "-427535.845"
ML_MAIN_NNIS = [706, 447, 198, 113, 53, 32, 13, 4, 0, 7]
# the first hex digits of the SHA-256 of the N=2000 runs' Newick output,
# -noml (phase 4) and default (phase 6), as scripts/compare_torch_port.py
# hashes it (PERF.md, section 5)
NOML_MAIN_SHA, ML_MAIN_SHA = "775406", "5ed6a64e"
# the least time of a call (NVIDIA's H100 SXM data sheet, at 700 W): bytes
# over the memory rate, operations over the float32 rate outside the
# tensor cores, the double operations of the ML posteriors' rotations over
# the float64 rate (ml_ops weighs each as F32_OPS_PER_S / F64_OPS_PER_S
# float32 operations)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
TOL = dict(rtol=1e-12, atol=1e-12)
BEST = 100                      # the row the scan inputs make the best


def TWINS(n):
    """Exact duplicates of row BEST: two in range, one past m_real."""
    return n // 2, 3 * n // 4, n - 10


def wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from veryfasttree_tpu_torch.ops import epoch_kernels, join_kernels, \
        ml_kernels, ml_round, nni_kernels, resample_kernels, scan_kernels, \
        spr_kernels, store_kernels

    return {"nj_scan_dense": scan_kernels.nj_scan_dense,
            "nj_scan_codes": scan_kernels.nj_scan_codes,
            "me_dists": store_kernels.me_dists,
            "me_average": store_kernels.me_average,
            "me_dists_list": store_kernels.me_dists_list,
            "me_dist_pieces_list": store_kernels.me_dist_pieces_list,
            "me_average_sweep": store_kernels.me_average_sweep,
            "ml_pair_loglk": ml_kernels.ml_pair_loglk,
            "ml_posterior": ml_kernels.ml_posterior,
            "ml_opt_branch": ml_kernels.ml_opt_branch,
            "ml_quartet_opt": ml_kernels.ml_quartet_opt,
            "me_spr_round": spr_kernels.spr_round,
            "me_nni_round": nni_kernels.nni_round,
            "nj_join_epoch": epoch_kernels.join_epoch,
            "nj_join_step": join_kernels.nj_join_step,
            "ml_nni_round": ml_round.ml_nni_round,
            "ml_lengths_pass": ml_round.ml_lengths_pass,
            "sh_resample_counts": resample_kernels.sh_resample_counts,
            "ml_posterior_sweep": ml_kernels.ml_posterior_sweep,
            "ml_tree_loglk": ml_kernels.ml_tree_loglk,
            "nj_scan_dense_partial": scan_kernels.nj_scan_dense_partial,
            "nj_scan_codes_partial": scan_kernels.nj_scan_codes_partial,
            "nj_scan_finish": scan_kernels.nj_scan_finish,
            "me_dists_partial": store_kernels.me_dists_partial,
            "me_dists_list_partial": store_kernels.me_dists_list_partial,
            "me_pair_finish": store_kernels.me_pair_finish}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "cons_launches"):          # the constrained kernels'
            fn.cons_launches = 0
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
# ten per element and a division; matrix: the products, the normalisation,
# and the two C x C rotations into character space and the one back, 6 C^2
# double operations, weighed at the float64 rate)
def ml_ops(C, jc):
    eff, site = 6 * C, 3 * C + 2
    post = eff + (11 * C if jc else
                  6 * C * C * F32_OPS_PER_S / F64_OPS_PER_S + 6 * C)
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


def codes_lane_replay(codes, G, wq, outd, n_active, l_real, use_matrix):
    """nj_scan_codes's arithmetic in numpy, in the kernel's order: lane l of
    a row's warp sums, tile by tile (scan_kernels.codes_p_tile), the
    positions 16 v + j of its chunks v = l, l + 32, ... in the order j = 0
    .. 15: wq[p] into den where the code is not NOCODE (127), G[code, p]
    into pick where it is a code below C; then the xor butterfly (lane l
    adds lane l ^ off's sum, off = 16 .. 1), dist (top / den, or 1), crit
    and the lowest index of the least crit.  Arguments as nj_scan_codes's
    (tensors or arrays); returns (best_idx, best_crit, dist, denom, crit) in
    numpy."""
    import numpy as np

    from veryfasttree_tpu_torch.ops.scan_kernels import codes_p_tile

    codes, G, wq, outd = (np.asarray(x.cpu()) if hasattr(x, "cpu")
                          else np.asarray(x) for x in (codes, G, wq, outd))
    L, P = codes.shape
    C = G.shape[0]
    lanes = np.arange(32)
    den = np.zeros((L, 32))
    pick = np.zeros((L, 32))
    p_tile = codes_p_tile(P, C)
    for p0 in range(0, P, p_tile):
        n_chunks = min(p_tile, P - p0) // 16
        for v0 in range(0, n_chunks, 32):
            v = v0 + lanes
            live = v < n_chunks
            for j in range(16):
                p = p0 + 16 * np.minimum(v, n_chunks - 1) + j
                code = codes[:, p].astype(np.int64)
                take = live & (code != 127)
                den = np.where(take, den + wq[p], den)
                hit = take & (code >= 0) & (code < C)
                pick = np.where(hit, pick + G[np.clip(code, 0, C - 1), p],
                                pick)
    for off in (16, 8, 4, 2, 1):
        den = den + den[:, lanes ^ off]
        pick = pick + pick[:, lanes ^ off]
    den, pick = den[:, 0], pick[:, 0]
    top = pick if use_matrix else den - pick
    dist = np.where(den > 0, top / np.where(den > 0, den, 1.0), 1.0)
    crit = np.where(np.arange(L) < l_real,
                    dist - outd / (float(n_active) - 2.0), 1e30)
    best = int(np.argmin(crit))
    return best, crit[best], dist, den, crit


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
    if name == "nj_scan_codes":            # its lane order, bit for bit
        want = codes_lane_replay(*args)
        if int(got[0]) != want[0] or any(
                g.cpu().numpy().tobytes() != w.tobytes()
                for g, w in zip(got[2:], want[2:])):
            raise AssertionError("nj_scan_codes: dist, denom or crit not bit "
                                 "for bit the lane-order replay's")
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
                  n_pos=MAIN_P, n_leaf=MAIN_N, approx=False):
    """A random ML store in the N=2000 layout: leaf rows (codes with gaps)
    below n_leaf, posterior rows (NOCODE; weights 0, 1 and a few fractions)
    above, 20 CAT rates; "jtt" and "lg" at 20 codes carry the rough
    posteriors' tables, used where approx is set.  Returns (codes, W, V,
    MLModel)."""
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
            TransitionMatrix.lg08() if model == "lg" else \
            TransitionMatrix.gtr([1.2, 3.1, 0.8, 1.1, 2.9, 1.0],
                                 [0.3, 0.2, 0.24, 0.26])
        cf, ev, ei, si = (torch.tensor(a, **f32).contiguous() for a in (
            tm.code_freq, tm.eigenval, tm.eigeninv, tm.statinv))
        near = {k: torch.tensor(getattr(tm, k), **f32).contiguous()
                for k in ("near_p", "near_freq")}
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
                                n_pos, 2.5e-4, 1e-10,
                                **(near if model != "jc" else {}),
                                approx=approx)


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
        ("nj_scan_codes", "L=20000 P=1536 C=20 BLOSUM45, two tiles",
         sk.nj_scan_codes, sk.nj_scan_codes_ref,
         codes_case(20, True, gen, dev, P=1536)),
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
        lanes = ("; dist, denom, crit bit for bit the lane-order replay"
                 if name == "nj_scan_codes" else "")
        record(name, f"{shape}, best {best}: the tie's lowest index{lanes}",
               err, times)
        if name == "nj_scan_codes" and "C=20" in shape and "tiles" not in \
                shape:
            report[name].update({"c20_ms": times["ms"],
                                 "c20_device_us": times["device_us"],
                                 "c20_bound_ms": times["bound_ms"]})
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
    check_me_whole_tree(report, dev)


def me_row_bytes(P, C):
    """Bytes of one ME store row: codes int8, W float32, U float32 [P, C]."""
    return P * (4 * C + 5)


def me_read_bytes(rows, leaf_rows, P, C):
    """Bytes a distance reads of `rows` (distinct): a float row's W and U
    (load_pos reads no codes there), a code-only leaf row's codes."""
    leaves = int((rows < leaf_rows).sum())
    return leaves * P + (len(rows) - leaves) * P * (4 * C + 4)


def me_sweep_bound(tables, P, C):
    """(bound_ms, bound_by) of an up-profile sweep: the rows it reads
    before any item writes them and the rows it writes, once each, and its
    tables (five words an item); an average's operations per position
    (check_average's count) for each item."""
    import numpy as np

    src = np.unique(np.concatenate([tables.iis, tables.jjs]))
    n_rows = len(np.setdiff1d(src, tables.targets)) + tables.n_items
    return bound(n_rows * me_row_bytes(P, C) + 20 * tables.n_items,
                 tables.n_items * P * (4 * C + 6))


def me_list_bound(iis, jjs, leaf_rows, P, C):
    """(bound_ms, bound_by) of a pair-distance list: what a distance reads
    of its distinct rows, once each (me_read_bytes), the list (two words a
    pair) in and (dist, denom) out; a pair's operations per position
    (check_dists' count) for each pair."""
    import numpy as np

    rows = np.unique(np.concatenate([iis, jjs]))
    return bound(me_read_bytes(rows, leaf_rows, P, C) + 24 * len(iis),
                 len(iis) * P * (2 * C + 2))


def pieces_bound(iis, jjs, leaf_rows, n_pos, C):
    """(bound_ms, bound_by) of a pieces list: the n_pos positions of its
    distinct rows read once each (me_read_bytes), the list (two words a
    pair) in, and the pieces and weights (two floats a pair and position)
    out; 2C + 3 operations a pair and position (the C products of the dot,
    its C sums, the weight, the eigenvalue or the subtraction)."""
    import numpy as np

    rows = np.unique(np.concatenate([iis, jjs]))
    return bound(me_read_bytes(rows, leaf_rows, n_pos, C)
                 + 8 * len(iis) * (1 + n_pos), len(iis) * n_pos * (2 * C + 3))


def check_pieces(report, dev, p, iis, jjs):
    """me_dist_pieces_list at the main path's shapes: the N=MAIN_N split
    test's list over the store p (its up-profiles written), then the same
    list on a two-tier store of the same input, then random pairs of a
    C=20 BLOSUM45 store: pieces and weights bit for bit the twin's on the
    card.  The first case timed (device us, launch to launch, the twin,
    the bound), and beside it the float64 products of the local bootstrap
    with the [P, B + 1] resample counts (cuBLAS, not a port kernel)."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.engine import batched
    from veryfasttree_tpu_torch.ops import resample_kernels as rk
    from veryfasttree_tpu_torch.ops import store_kernels as st

    def case(label, store, ii, jj):
        got = st.me_dist_pieces_list(*store, ii, jj)
        want = st.me_dist_pieces_list_ref(*store, ii, jj)
        for name, a, b in zip(("pieces", "weights"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"me_dist_pieces_list [{label}]: {name} "
                                     "differ from the twin's")
        print(f"  me_dist_pieces_list [{label}, {len(ii)} pairs]: pieces "
              "and weights bit for bit the twin's")
        return got

    n_pos = p.n_pos
    store = (p.codes, p.W, p.U, p.code_freq, p._ev, p._leaf_rows, n_pos)
    pieces, weights = case(f"N={MAIN_N} split test, dense", store, iis, jjs)
    tt = spr_start(MAIN_N, dev, two_tier=True)
    batched.compute_up_profiles_levelwise(tt, False)
    tp = tt.prof
    case(f"N={MAIN_N} split test, two-tier ({tp._leaf_rows} code-only "
         "leaves)", (tp.codes, tp.W, tp.U, tp.code_freq, tp._ev,
                     tp._leaf_rows, tp.n_pos),
         *batched.pair_list(batched.quartet_rows(tt, batched.split_nodes(tt)),
                            batched.QUARTET_PAIRS))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    codes, W, U, cf, ev, _ = store_case(20, True, 0, gen, dev)
    rng = np.random.default_rng(20)
    case("8192x512 C=20 BLOSUM45", (codes, W, U, cf, ev, 0, n_pos),
         rng.integers(0, 8192, len(iis)), rng.integers(0, 8192, len(iis)))

    bound_ms, bound_by = pieces_bound(iis, jjs, p._leaf_rows, n_pos,
                                      p.U.shape[2])
    fn = lambda: st.me_dist_pieces_list(*store, iis, jjs)  # noqa: E731
    times = {"ms": median_ms(fn),
             "plain_ms": median_ms(lambda: st.me_dist_pieces_list_ref(
                 *store, iis, jjs), 5),
             "device_us": device_us(fn, DEVICE_NAMES["me_dist_pieces_list"]),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "pairs": len(iis)}
    counts = rk.sh_resample_counts(n_pos, 1000, dev)
    cx = torch.cat([counts, torch.ones_like(counts[:, :1])], 1)
    times["product_ms"] = median_ms(
        lambda: (pieces.double() @ cx, weights.double() @ cx), 20)
    report["me_dist_pieces_list"] = {"max_abs_err": 0.0, **times}
    print(f"  me_dist_pieces_list [N={MAIN_N} split test, {len(iis)} pairs, "
          f"{n_pos} positions]: {times['ms']:.4f} ms launch to launch, "
          f"{times['device_us']:.2f} us on the device; twin "
          f"{times['plain_ms']:.3f} ms; bound {bound_ms:.4e} ms ({bound_by})")
    print(f"  the local bootstrap's float64 products (cuBLAS, not a port "
          f"kernel): [{len(iis)}, {n_pos}] x [{n_pos}, 1001] twice, "
          f"{times['product_ms']:.4f} ms")


def check_me_whole_tree(report, dev):
    """The ME whole-tree kernels at the main path's shapes, on the port's
    NJ tree at N=MAIN_N (dense store): me_average_sweep, the up-profiles of
    the split test and the ME lengths, against the per-level launches of
    me_average and against one me_average launch per up-profile (the serial
    walk's calls), every row bit for bit, and against its twin on the card
    (codes equal, W and U within TOL); me_dists_list, the split test's
    quartets' pairs, against me_dists' calls of six pairs (the serial
    walk's), bit for bit, and its twin within TOL.  Each timed: device us,
    launch to launch, the per-level launches (the sweep), the per-call path
    (the serial walk's calls, each list of six fetched), the twin and the
    bound."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import batched
    from veryfasttree_tpu_torch.ops import store_kernels as st

    nj = spr_start(MAIN_N, dev)
    levels = batched.up_profile_levels(nj)
    tables = st.AverageTables.from_levels(levels)
    iis, jjs = batched.pair_list(
        batched.quartet_rows(nj, batched.split_nodes(nj)),
        batched.QUARTET_PAIRS)
    profs = {k: engine_copy(nj, dev).prof
             for k in ("sweep", "levels", "calls", "twin")}

    def store(p):
        return p.codes, p.W, p.U, p.code_freq

    def sweep(p):
        st.me_average_sweep(*store(p), p._et, p._leaf_rows, tables, p.tol)

    def per_level(p):
        for t, i, j in levels:
            st.me_average(*store(p), p._et, p._leaf_rows, t, i, j, 0.5, p.tol)

    def per_call(p):
        for t, i, j in levels:
            for k in range(len(t)):
                st.me_average(*store(p), p._et, p._leaf_rows, t[k:k + 1],
                              i[k:k + 1], j[k:k + 1], 0.5, p.tol)

    def twin(p):
        st.me_average_sweep_ref(*store(p), p._et, p._leaf_rows, tables, p.tol)

    for k, fn in (("sweep", sweep), ("levels", per_level), ("calls", per_call),
                  ("twin", twin)):
        fn(profs[k])
    rows = {k: [t.cpu().numpy() for t in (p.codes, p.W, p.U)]
            for k, p in profs.items()}
    for k in ("levels", "calls"):
        for name, a, b in zip(("codes", "W", "U"), rows["sweep"], rows[k]):
            if not np.array_equal(a, b):
                raise AssertionError(f"me_average_sweep: {name} differ from "
                                     f"the {k} of me_average")
    if not np.array_equal(rows["sweep"][0], rows["twin"][0]):
        raise AssertionError("me_average_sweep: codes differ from the twin's")
    err = 0.0
    for name, a, b in zip("WU", rows["sweep"][1:], rows["twin"][1:]):
        np.testing.assert_allclose(a, b, err_msg=f"me_average_sweep {name}",
                                   **TOL)
        err = max(err, float(np.max(np.abs(a - b))))
    p = profs["sweep"]
    P, C = p.W.shape[1], p.U.shape[2]
    bound_ms, bound_by = me_sweep_bound(tables, P, C)
    times = {"ms": median_ms(lambda: sweep(p)),
             "plain_ms": median_ms(lambda: twin(profs["twin"]), 5),
             "device_us": device_us(lambda: sweep(p),
                                    DEVICE_NAMES["me_average_sweep"]),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "per_level_ms": median_ms(lambda: per_level(profs["levels"]), 10),
             "per_call_ms": median_ms(lambda: per_call(profs["calls"]), 5),
             "items": tables.n_items, "levels": tables.n_levels}
    report["me_average_sweep"] = {"max_abs_err": err, **times}
    print(f"  me_average_sweep [N={MAIN_N} NJ tree, {tables.n_items} "
          f"up-profiles in {tables.n_levels} levels]: rows bit for bit the "
          f"per-level and the per-call launches', max abs err {err:.3e} "
          f"against the twin; {times['ms']:.4f} ms launch to launch, "
          f"{times['device_us']:.2f} us on the device; the per-level "
          f"launches {times['per_level_ms']:.4f} ms, one launch per "
          f"up-profile {times['per_call_ms']:.3f} ms; twin "
          f"{times['plain_ms']:.3f} ms; bound {bound_ms:.4e} ms ({bound_by})")

    # the split test's list over the up-profiles just written
    args = (*store(p), p._ev, p._leaf_rows)
    got = st.me_dists_list(*args, iis, jjs).cpu().numpy()

    def per_quartet():
        return [st.me_dists(*args, (), None, None, iis[k:k + 6],
                            jjs[k:k + 6]).cpu() for k in range(0, len(iis), 6)]

    one = np.concatenate([x.numpy() for x in per_quartet()], axis=1)
    if not np.array_equal(got, one):
        raise AssertionError("me_dists_list: distances differ from me_dists' "
                             "calls of six pairs")
    exp = st.me_dists_list_ref(*args, iis, jjs).cpu().numpy()
    np.testing.assert_allclose(got, exp, err_msg="me_dists_list vs the twin",
                               **TOL)
    err = float(np.max(np.abs(got - exp)))
    bound_ms, bound_by = me_list_bound(iis, jjs, p._leaf_rows, P, C)
    times = {"ms": median_ms(lambda: st.me_dists_list(*args, iis, jjs)),
             "plain_ms": median_ms(lambda: st.me_dists_list_ref(
                 *args, iis, jjs), 5),
             "device_us": device_us(lambda: st.me_dists_list(*args, iis, jjs),
                                    DEVICE_NAMES["me_dists_list"]),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "per_call_ms": median_ms(per_quartet, 5), "pairs": len(iis)}
    report["me_dists_list"] = {"max_abs_err": err, **times}
    print(f"  me_dists_list [N={MAIN_N} split test, {len(iis)} pairs]: bit "
          "for bit me_dists' calls of six pairs, max abs err "
          f"{err:.3e} against the twin; {times['ms']:.4f} ms launch to "
          f"launch, {times['device_us']:.2f} us on the device; the serial "
          f"walk's {len(iis) // 6} calls {times['per_call_ms']:.3f} ms; twin "
          f"{times['plain_ms']:.3f} ms; bound {bound_ms:.4e} ms ({bound_by})")
    check_pieces(report, dev, p, iis, jjs)


# ------------------------------------------------------------- phase 2h
def me_pass_run(nj, batched_path):
    """The ME lengths, then the split test, on nj, through the whole-tree
    path (batched_path) or the serial walks on the per-call kernels:
    returns (SplitCount, debug counters, branch lengths, walls, launches of
    each)."""
    import dataclasses

    import torch

    from veryfasttree_tpu_torch.engine import batched, rearrange, supports

    lengths, splits = ((batched.update_branch_lengths_batched,
                        supports.test_splits_min_evo_batched) if batched_path
                       else (rearrange.update_branch_lengths,
                             supports.test_splits_min_evo))
    walls, launches = [], []

    def timed(fn, *args):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(nj, *args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append({k: w.launches for k, w in wrappers().items()
                         if w.launches})
        return out

    # the split test takes the lengths pass's sweep tables, as the pipeline does
    tables = timed(lengths)
    sc = timed(splits, *([tables] if batched_path else []))
    m = nj.tree.maxnode
    return (sc, dataclasses.asdict(nj.debug), nj.tree.branchlength[:m].copy(),
            walls, launches)


def phase_me_passes(report, dev):
    """The ME lengths and the split test at N=MAIN_N from the port's NJ
    tree, dense and two-tier: the whole-tree path (one me_average_sweep
    and one me_dists_list launch each, one fetch) against the serial walks
    through the per-call kernels (rearrange.update_branch_lengths,
    supports.test_splits_min_evo): the SplitCount, the debug counters and
    every branch length bit for bit; the walls and launches of both."""
    import numpy as np

    want = {"me_average_sweep": 1, "me_dists_list": 1}
    for label, kw in (("dense", {}), ("two-tier", {"two_tier": True})):
        start = spr_start(MAIN_N, dev, **kw)
        runs = {k: me_pass_run(engine_copy(start, dev), k == "batched")
                for k in ("batched", "serial")}
        (sc, dbg, bl, walls, launches), (sc_s, dbg_s, bl_s, walls_s,
                                          launches_s) = runs.values()
        print(f"  N={MAIN_N} {label}: lengths {walls[0]:.4f} s "
              f"({launches[0]}) against the serial walk's {walls_s[0]:.4f} s "
              f"({launches_s[0]}); split test {walls[1]:.4f} s "
              f"({launches[1]}) against {walls_s[1]:.4f} s ({launches_s[1]});"
              f" {sc}")
        if (sc.n_splits, sc.n_bad_splits, sc.d_worst_delta_unconstrained) != (
                sc_s.n_splits, sc_s.n_bad_splits,
                sc_s.d_worst_delta_unconstrained):
            raise AssertionError(f"{label}: SplitCount {sc}, the serial "
                                 f"walk's {sc_s}")
        if dbg != dbg_s:
            raise AssertionError(f"{label}: counters {dbg}, the serial "
                                 f"walk's {dbg_s}")
        if not np.array_equal(bl, bl_s):
            raise AssertionError(f"{label}: branch lengths differ from the "
                                 "serial walk's")
        if launches != [want, want]:
            raise AssertionError(f"{label}: the whole-tree passes launched "
                                 f"{launches}, not {want} each")
        if label == "dense":
            report.setdefault("me_average_sweep", {}).update(
                splits_s=walls[1], serial_splits_s=walls_s[1],
                lengths_s=walls[0], serial_lengths_s=walls_s[0])


# ------------------------------------------------------------- phase 2i
def phase_boot(report, dev):
    """The ME local bootstrap at N=MAIN_N from the port's NJ tree (1000
    resamples): the whole-tree path (supports.reliability_nj_list: one
    sweep of the up-profiles, one me_dist_pieces_list launch, the float64
    products and the decisions on the card, one fetch) against the serial
    walk (supports.reliability_nj, -bionj's path: a six-pair list and a
    fetch a split): every support and the count of suboptimal splits
    equal; the walls, the launches and the splits re-decided on the host
    by the reference's operations."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.engine import supports

    start = spr_start(MAIN_N, dev)
    start.options.n_bootstrap = 1000
    m = start.tree.maxnode
    runs = {}
    for label, fn in (("list", supports.reliability_nj_list),
                      ("serial", supports.reliability_nj)):
        nj = engine_copy(start, dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = fn(nj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers().items()
                    if w.launches}
        runs[label] = (nj.tree.support[:m].copy(),
                       nj.debug.n_suboptimal_splits, wall, launches, stats)
        print(f"  N={MAIN_N} {label}: {wall:.4f} s, launches {launches}, "
              f"{stats['splits']} splits, {nj.debug.n_suboptimal_splits} "
              f"suboptimal, re-decided on the host: "
              f"{stats['redecided_splits']} splits "
              f"({stats['redecided_entries']} entries)")
    (sup, sub, wall, launches, stats), (sup_s, sub_s, wall_s, _, _) = \
        runs.values()
    if not np.array_equal(sup, sup_s) or sub != sub_s:
        bad = np.flatnonzero(sup != sup_s)
        raise AssertionError(f"the list's supports differ from the serial "
                             f"walk's at {len(bad)} nodes {bad[:10]}; "
                             f"suboptimal {sub} against {sub_s}")
    want = {"me_average_sweep": 1, "me_dist_pieces_list": 1,
            "sh_resample_counts": 1}
    if launches != want:
        raise AssertionError(f"the list launched {launches}, not {want}")
    report.setdefault("me_dist_pieces_list", {}).update(
        boot_list_s=wall, boot_serial_s=wall_s,
        redecided_splits=stats["redecided_splits"],
        redecided_entries=stats["redecided_entries"])


# ------------------------------------------------------------- phase 2b
SPR_N = 500
SPR_COUNTERS = ("n_spr", "profile_ops", "profile_avg_ops")


def spr_start(n, dev, two_tier=False, protein=False, p=MAIN_P):
    """The port's NJ tree and ME store of synth_codes(n, p) on dev: the
    start of an SPR round.  protein: 20 codes under BLOSUM45 (matrix mode),
    as a protein -noml run."""
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.models import DistanceMatrix
    from veryfasttree_tpu_torch.options import Options

    opts = Options(n_codes=20 if protein else 4, ml_nni=0, n_bootstrap=0,
                   show_progress=False,
                   **({"two_tier_min": 0} if two_tier else {}))
    opts.derive_settings()
    nj = NeighbourJoining(opts, synth_codes(n, p, n_codes=opts.n_codes),
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
    through the host loop with the per-call kernels (its unfused body,
    USE_FUSED_JOIN off).  protein: 20 codes under BLOSUM45 (matrix
    mode)."""
    import torch

    from veryfasttree_tpu_torch.engine import epoch
    from veryfasttree_tpu_torch.engine import nj as nj_mod
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
    fused = nj_mod.USE_FUSED_JOIN
    if not kernel:
        epoch.epoch_supported = lambda nj_, tophits: False
        nj_mod.USE_FUSED_JOIN = False
    elif launch:
        epoch.run_epoch = lambda nj_, tophits, mj=None: run(
            nj_, tophits, mj, **launch)
    try:
        nj.fast_nj(max_joins)
        torch.cuda.synchronize()
    finally:
        epoch.epoch_supported, epoch.run_epoch = supported, run
        nj_mod.USE_FUSED_JOIN = fused
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


def phase_epoch(report, dev, probe):
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
    phase of each dense case; the bound from epoch_bound.  Then the refresh
    scans' time at N=MAIN_N, dense and two-tier (refresh_scan_times)."""
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
    refresh_scan_times(report, dev, probe)


def start_probe_build():
    """nvcc of csrc/nj_epoch.cu with -DVFT_PROBES (csrc/probes.cuh; as
    scripts/profile_me_kernels.py builds it) into build/epoch_probes/,
    started beside phase 1's build: returns (library path, process)."""
    from veryfasttree_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "epoch_probes")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libvft_nj_epoch_probes.so")
    src = "nj_epoch.cu"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(src, []),
         "-DVFT_PROBES", "-shared", "-o", path, str(_build.SRC_DIR / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, proc


def refresh_scan_times(report, dev, probe):
    """The join phase at N=MAIN_N, dense and two-tier, through the probe
    build of the epoch kernel (start_probe_build): the master's clock of
    the refresh scans' grid phases (probe_ns[2], from the first worker
    group's start to the last group's end of each scan phase), beside all
    grid phases' work.  The two-tier run's leaf rows take the code scan's
    body on the laid-out query."""
    import ctypes

    import torch

    from veryfasttree_tpu_torch.ops import _build

    path, proc = probe
    out = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"the probe build failed:\n{out[-4000:]}")
    lib, main = ctypes.CDLL(path), _build.library()
    routed = ("vft_nj_epoch_f32", "vft_nj_epoch_scratch")
    for name in routed:
        fn, ref = getattr(lib, name), getattr(main, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    reader = lib.vft_nj_epoch_profile_read
    reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], \
        ctypes.c_int

    class Routed:
        def __getattr__(self, name):
            return getattr(lib if name in routed else main, name)

    def read():
        buf = (ctypes.c_ulonglong * 19)()
        rc = reader(buf, 1)
        if rc:
            raise RuntimeError(f"vft_nj_epoch_profile_read: {rc}")
        return list(buf[16:19])

    saved, _build._lib = _build._lib, Routed()
    try:
        for label, kw in (("dense", {}), ("two-tier", {"two_tier": True})):
            read()
            reset_launches()
            nj = epoch_run(MAIN_N, dev, **kw)
            torch.cuda.synchronize()
            _, work_ns, scan_ns = read()
            t = wrappers()["nj_join_epoch"].totals
            print(f"  refresh scans [N={MAIN_N} {label}, probes on]: "
                  f"{scan_ns / 1e6:.4f} ms of grid-phase work "
                  f"({work_ns / 1e6:.4f} ms in all), {t['scans']} scans of "
                  f"{t['scan_rows']} rows ({scan_ns / 1e3 / t['scans']:.3f} "
                  f"us a scan), {nj.prof._leaf_rows} leaf rows in the store")
            if label == "two-tier":
                report.setdefault("nj_scan_codes", {}).update({
                    "two_tier_refresh_scan_ms": scan_ns / 1e6,
                    "two_tier_refresh_scans": t["scans"],
                    "two_tier_refresh_scan_rows": t["scan_rows"]})
    finally:
        _build._lib = saved


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
# At 20 codes (phases 2j, 7a) each quartet's deciding differences (its
# criteria less its first) must also agree within ML_CRITERIA_TOL_20 (up
# to a flip where the runs then part).  Read on the H100 up to the first
# flip: 0.022 and 0.054 against the JAX package's protein goldens (7a,
# P=300, 403 and 183 decisions), 0.052 between the card's round and the
# twins' round from the same state (2j, P=512, 67 quartets), each
# quartet's lengths there carrying the float32 searches of the quartets
# before it, and 0.028 with each of the 497 quartets decided by the twins
# from the card's own inputs.  A flip's two choices lie within
# ML_TWIN_NEAR_TIE in both runs, but in 2j's whole twin round within
# ML_ROUND_NEAR_TIE_20 (its flip at quartet 67 read 0.038 on the card,
# 0.014 in the twins).
ML_CRITERIA_TOL_20 = 0.1
ML_ROUND_NEAR_TIE_20 = 0.05
# phase 1's ptxas report (registers, stack, spills of every kernel), for
# phase 2j's print of the 20-code round kernels
PTXAS = {}
GTR = ([1.2, 3.1, 0.8, 1.1, 2.9, 1.0], [0.3, 0.2, 0.24, 0.26])


def ml_start(n, dev, model="jc", cat=False, approx=False, p=MAIN_P):
    """The port's NJ tree of synth_codes(n, p) on dev with its ME
    branch lengths and an ML store (Jukes-Cantor or GTR; "jtt" and "lg" a
    protein alignment of 20 codes, its NJ tree under BLOSUM45) with
    recomputed posteriors: the start of the default run's first ML lengths
    pass and NNI round (one rate), or with cat, of its later ones (the CAT
    20 rates fitted to the tree, engine/ml.set_ml_rates).  approx turns on
    -approxml's rough posteriors (protein only)."""
    from veryfasttree_tpu_torch.engine import ml, rearrange
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu_torch.models import TransitionMatrix

    protein = model in ("jtt", "lg")
    nj = spr_start(n, dev, protein=protein, p=p)
    nj.options.exact_ml = not approx
    rearrange.update_branch_lengths(nj)
    nj.ml = MLProfiles(nj, None if model == "jc" else
                       TransitionMatrix.jtt92() if model == "jtt" else
                       TransitionMatrix.lg08() if model == "lg" else
                       TransitionMatrix.gtr(*GTR))
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
                 "eigeninv", "eigentot", "near_p", "near_freq",
                 "post_counts"):
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
    # the posteriors' rough and exact positions (20 codes)
    ctr["aa_counts"] = tuple(nj.ml.post_counts.tolist())
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


def ml_decisions(fn, twin=None):
    """Run fn() with engine/ml.ml_quartet_nni logging its quartets:
    returns [(rows, choice, criteria)].  With twin (an engine on the CPU),
    each quartet is also decided by the twin from the same inputs (its four
    store rows copied in, the same lengths), and the twin's decisions come
    back as a second log."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import ml

    log, twin_log, orig = [], [], ml.ml_quartet_nni

    def entry(rows4, out):
        return (tuple(int(r) for r in rows4), int(out[0]),
                np.array(out[1], dtype=np.float64))

    def rec(nj_, rows4, lengths, nodes4=None):
        given = np.array(lengths, copy=True)
        out = orig(nj_, rows4, lengths, nodes4)
        log.append(entry(rows4, out))
        if twin is not None:
            rows = list(rows4)
            for name in ("codes", "W", "V"):
                getattr(twin.ml, name)[rows] = \
                    getattr(nj_.ml, name)[rows].cpu()
            twin_log.append(entry(rows4, orig(twin, rows4, given, nodes4)))
        return out

    ml.ml_quartet_nni = rec
    try:
        fn()
    finally:
        ml.ml_quartet_nni = orig
    return log if twin is None else (log, twin_log)


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


def first_flip(label, a, b, near_tie=ML_TWIN_NEAR_TIE, crit_tol=None):
    """The index of the first quartet two logs of the same round decide
    otherwise, or None; raises unless it is a near tie in both (its two
    criteria within near_tie of each other), if the logs part before it,
    or, with crit_tol, if before it a quartet's criteria less their first
    (the differences that decide) part by more than crit_tol.  Returns
    (index, the criteria's max abs difference up to it, the deciding
    differences' max abs difference up to it)."""
    import numpy as np

    err = dec = 0.0
    for k, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            raise AssertionError(f"{label}: quartet {k} differs ({x[0]}, "
                                 f"{y[0]})")
        err = max(err, float(np.max(np.abs(x[2] - y[2]))))
        here = float(np.max(np.abs((x[2] - x[2][0]) - (y[2] - y[2][0]))))
        dec = max(dec, here)
        if crit_tol is not None and here > crit_tol:
            raise AssertionError(f"{label}: quartet {k}'s deciding "
                                 f"differences part by {here:.3e} (limit "
                                 f"{crit_tol:.0e}): {x} {y}")
        if x[1] != y[1]:
            margins = [abs(c[x[1]] - c[y[1]]) for c in (x[2], y[2])]
            if max(margins) > near_tie:
                raise AssertionError(f"{label}: quartet {k} flips, not on a "
                                     f"near tie (margins {margins}, limit "
                                     f"{near_tie:.0e}): {x} {y}")
            return k, err, dec
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} and {len(b)} quartets")
    return None, err, dec


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
        flip, crit_err, _ = first_flip(f"ml_nni_round {label} twin",
                                       h["log"], t["log"])
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
RESAMPLE_WIDE = 5000            # a wider alignment for the counts kernel
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


def resample_replay(P, B, n_sms):
    """sh_resample_counts's kernel replayed in numpy, all its warps at once:
    the plan's chunk start states (resample_kernels.chunk_states), then
    each chunk's cycles from its state as a warp runs them: a cycle's first
    100 values the draws that fall in its block's resamples, counted into
    [P, B]; then its values 100 .. 1108, 32 a step, value j the value of
    j - 100 less that of j - 37 mod 2^30, the last 100 the next state."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import resample_kernels as rk

    plan = rk.resample_plan(P, B, n_sms)
    k0, k1 = plan.cycle_ranges()
    b0 = np.arange(len(k0), dtype=np.int64) * plan.R
    d0 = (b0 * P)[:, None, None]
    d1 = (np.minimum(b0 + plan.R, B) * P)[:, None, None]
    a = np.zeros((len(k0), plan.W, 1109), dtype=np.int64)
    a[..., :100] = rk.chunk_states(plan)
    start = k0[:, None] + plan.T * np.arange(plan.W, dtype=np.int64)
    counts = np.zeros((P, B), dtype=np.int64)
    for t in range(plan.T):
        k = start + t
        d = 100 * k[..., None] + np.arange(100)
        take = (k < k1[:, None])[..., None] & (d >= d0) & (d < d1)
        u = 9.31322574615479e-10 * a[..., :100].astype(np.float64)
        col = np.clip((u * P).astype(np.int64), 0, P - 1)
        np.add.at(counts, (col[take], d[take] // P), 1)
        for j in range(100, 1109, 32):
            hi = min(j + 32, 1109)
            a[..., j:hi] = (a[..., j - 100:hi - 100]
                            - a[..., j - 37:hi - 37]) & rk.MASK
        a[..., :100] = a[..., 1009:1109]
    return counts.astype(np.float64)


def check_resample(report, dev):
    """The counts kernel against its twin at B=SH_BOOT, P=MAIN_P (the main
    path's) and P=RESAMPLE_WIDE: equal.  Times: the kernel's launch to
    launch and device time, the twin's one run (a Python draw per
    column)."""
    import torch

    from veryfasttree_tpu_torch.ops import resample_kernels as rk

    B = SH_BOOT
    for P in (MAIN_P, RESAMPLE_WIDE):
        got = rk.sh_resample_counts(P, B, dev)
        t0 = time.perf_counter()
        want = rk.sh_resample_counts_ref(P, B)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not (got.cpu() == want).all() or int(want.sum()) != P * B:
            raise AssertionError(f"sh_resample_counts P={P}: differs from "
                                 "its twin")
        # the state in, the counts [P, B] float64 out; per draw its column
        # (five operations) and ten values of the recurrence (two each)
        bound_ms, bound_by = bound(400 + 8 * P * B, 25 * P * B)
        fn = lambda: rk.sh_resample_counts(P, B, dev)  # noqa: E731
        entry = {"max_abs_err": 0.0, "ms": median_ms(fn, runs=20),
                 "plain_ms": plain_ms,
                 "device_us": device_us(
                     fn, DEVICE_NAMES["sh_resample_counts"], runs=10),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None}
        plan = rk.resample_plan(
            P, B, torch.cuda.get_device_properties(dev).multi_processor_count)
        if P == MAIN_P:
            report.setdefault("sh_resample_counts", {}).update(entry)
        else:
            report["sh_resample_counts"].update(
                {f"p{P}_{k}": entry[k] for k in ("ms", "device_us",
                                                 "plain_ms", "bound_ms")})
        print(f"  sh_resample_counts [P={P} B={B}, {plan}]: equal to the "
              f"twin; kernel {entry['ms']:.4f} ms launch to launch, "
              f"{entry['device_us']:.2f} us on the device, twin "
              f"{plain_ms:.1f} ms, bound {bound_ms:.3e} ms ({bound_by})")


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
# the whole-tree kernels' device time per call before the chain redesign
# (us; PERF.md section 6, the earlier smokes on an H100 80GB HBM3 at 700
# W), printed beside this run's: the N=2000 NJ tree (Jukes-Cantor, CAT
# 20), the caterpillar of DEEP_N leaves, the balanced 2000-leaf protein
# tree (JTT, CAT 20, -approxml)
OLD_SWEEP_US = {("ml_posterior_sweep", "nj"): 77.26,
                ("ml_tree_loglk", "nj"): 42.59,
                ("ml_posterior_sweep", "caterpillar"): 1215.8,
                ("ml_tree_loglk", "caterpillar"): 111.8,
                ("ml_posterior_sweep", "balanced<20>"): 715.96,
                ("ml_tree_loglk", "balanced<20>"): 145.42}


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


def shaped_start(n, dev, shape, model, p=MAIN_P, seed=0, approx=False):
    """An engine on synth_codes(n, p) on dev (no NJ phase) whose tree is
    shaped_tree(shape), with an ML store under `model` (Jukes-Cantor or
    GTR; "jtt" a protein alignment of 20 codes, with -approxml's rough
    posteriors where approx is set; its averaged profiles) at CAT_N rates,
    the categories drawn from `seed`."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import ml
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.models import TransitionMatrix
    from veryfasttree_tpu_torch.options import Options

    C = 20 if model == "jtt" else 4
    opts = Options(n_codes=C, n_bootstrap=0, show_progress=False,
                   exact_ml=not approx)
    opts.derive_settings()
    nj = NeighbourJoining(opts, synth_codes(n, p, n_codes=C), None, None,
                          device=dev)
    shaped_tree(nj, shape, seed)
    nj.ml = MLProfiles(nj, None if model == "jc" else
                       TransitionMatrix.jtt92() if model == "jtt" else
                       TransitionMatrix.gtr(*GTR))
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


def per_level_sweep(ml, tables):
    """A SweepTables as it ran before ml_posterior_sweep: one ml_posterior
    launch per level, and once more for the level's items whose weight is
    at least 2, 3, ...: the same rows again (a level's sources do not
    change within it), each item's rough and exact positions counted as
    often as its weight."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    store = ml._store()
    for a, level in zip(tables.offsets, tables.levels()):
        w = tables.weights[a:a + len(level[0])]
        for k in range(1, int(w.max()) + 1):
            mk.ml_posterior(*store, *(np.asarray(x)[w >= k] for x in level))


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


def check_sweep(label, nj, dev, kernel_runs=True, old=None):
    """One posterior sweep and one tree log-likelihood with per-site sums
    over nj's tree (its TreeSweep): the kernels against the per-level
    launches (the rows bit for bit, the sums within SUM_RTOL) and against
    their twins on the card (TWIN_ROWS, TWIN_SITE), each on its own copy of
    nj.  Returns ({name: (max abs err against the twin, timing)}, the
    TreeSweep); with kernel_runs False the timings are left out.  old: the
    key of the tree in OLD_SWEEP_US, whose times are printed beside the
    new."""
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
    # the posteriors' rough and exact positions (20 codes; 0 at 4)
    counts = [c.post_counts.tolist() for c in (kern, lev, twin)]
    if counts[0] != counts[1]:
        raise AssertionError(f"ml_posterior_sweep {label}: rough/exact "
                             f"counts {counts[0]}, the per-level launches' "
                             f"{counts[1]}")
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
          f" from the twin's; rough/exact posterior positions {counts[0]} "
          f"(the twin's {counts[2]})")
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
    n_levels = {"ml_posterior_sweep": post.n_levels,
                "ml_tree_loglk": sw.loglk.n_levels}
    for name, fn, twin_fn, levels_fn, (bound_ms, bound_by) in runs:
        times = {"ms": median_ms(fn), "plain_ms": median_ms(twin_fn, 3),
                 "device_us": device_us(fn, DEVICE_NAMES[name]),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None, "per_level_ms": median_ms(levels_fn, 5)}
        out[name].append(times)
        was = OLD_SWEEP_US.get((name, old))
        print(f"  {name} [{label}]: {times['device_us']:.2f} us on the "
              f"device (before the chain redesign "
              f"{'not measured' if was is None else f'{was} us'}), "
              f"{times['device_us'] / n_levels[name]:.4f} us a level of "
              f"{n_levels[name]}; bound {bound_ms:.4e} ms ({bound_by}); "
              f"{times['ms']:.4f} ms launch to launch; the per-level "
              f"launches {times['per_level_ms']:.4f} ms; twin "
              f"{times['plain_ms']:.3f} ms")
    return out, sw


def check_fan_out(label, nj, dev):
    """The SH pass's up-profile sweep over nj's tree (ops/ml_round.
    up_sweep_tables: top-down, a parent's up-profile read by both of its
    children's, so by two chains; each item weighted by how often the host
    loop computes it), after nj's own recompute: the kernel's rows and
    rough/exact counts bit for bit per_level_sweep's, and within TWIN_ROWS
    of its twin on the card.  Returns (max abs err against the twin,
    timing)."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk
    from veryfasttree_tpu_torch.ops.ml_round import SHPass, up_sweep_tables

    copies = {k: ml_copy(nj, dev) for k in ("kernel", "levels", "twin")}
    tables = up_sweep_tables(copies["kernel"], SHPass(nj).nodes)
    ch = tables.chains
    mk.ml_posterior_sweep(*copies["kernel"].ml._store(), tables)
    per_level_sweep(copies["levels"].ml, tables)
    mk.ml_posterior_sweep_ref(*copies["twin"].ml._store(), tables)
    kern, lev, twin = (copies[k].ml for k in ("kernel", "levels", "twin"))
    diff = store_diff(kern, lev)
    counts = [c.post_counts.tolist() for c in (kern, lev, twin)]
    if diff or counts[0] != counts[1]:
        raise AssertionError(f"ml_posterior_sweep {label}: {diff} differ, "
                             f"rough/exact counts {counts[0]} against the "
                             f"per-level launches' {counts[1]}")
    rows = tables.targets
    err = 0.0
    for k in ("W", "V"):
        a = getattr(kern, k)[rows].cpu().numpy()
        b = getattr(twin, k)[rows].cpu().numpy()
        np.testing.assert_allclose(a, b, err_msg=f"ml_posterior_sweep "
                                   f"{label} {k} vs the twin", **TWIN_ROWS)
        err = max(err, float(np.max(np.abs(a - b))))
    store = kern._store()
    P, C = kern.W.shape[1], kern.V.shape[2]
    bound_ms, bound_by = sweep_bound(tables, P, C, kern.jc)
    us = device_us(lambda: mk.ml_posterior_sweep(*store, tables),
                   DEVICE_NAMES["ml_posterior_sweep"])
    print(f"  [{label}] up-profile sweep: {tables.n_items} items in "
          f"{tables.n_levels} levels (weights up to "
          f"{int(tables.weights.max())}), {ch.n_chains} chains, "
          f"{ch.n_slots} items read by another chain; rows and rough/exact "
          f"counts {counts[0]} bit for bit the per-level launches' (the "
          f"twin's {counts[2]}), max abs err {err:.3e} against the twin; "
          f"{us:.2f} us on the device, bound {bound_ms:.4e} ms ({bound_by})")
    return err


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
                             kernel_runs=model == "jc", old="nj")
        if model == "jc":
            err = check_fan_out(label + " CAT 20", nj, dev)
            out["ml_posterior_sweep"][0] = max(out["ml_posterior_sweep"][0],
                                               err)
        for name, (err, *times) in out.items():
            entry = report.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if times:
                entry.update(times[0])
    for model in ("jc", "gtr"):
        label = f"caterpillar N={DEEP_N} {model.upper()} CAT 20"
        nj = shaped_start(DEEP_N, dev, "caterpillar", model)
        out, sw = check_sweep(label, nj, dev, kernel_runs=model == "jc",
                              old="caterpillar")
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


def cons_columns(n, p, n_cols=16, seed=0, n_codes=4, gap=0.15):
    """A -constraints alignment for synth_codes(n, p, seed, n_codes): n
    strings of n_cols '0', '1' or '-' (names s0 .. s{N-1} as fasta_text):
    the even columns follow the founder groups (a random half of the
    founders on side 1), the odd ones are random bipartitions, and a share
    `gap` of the entries is '-'."""
    import numpy as np

    rng = np.random.default_rng(seed)        # synth_codes' founder draw
    n_founders = max(4, n // 20)
    rng.integers(0, n_codes, size=(n_founders, p))
    founder = rng.integers(0, n_founders, size=n)
    own = np.random.default_rng([seed, 1])   # the columns' own stream
    cols = [own.random(n_founders)[founder] < 0.5 if c % 2 == 0
            else own.random(n) < 0.5 for c in range(n_cols)]
    out = np.where(np.array(cols).T, "1", "0")
    out[own.random(out.shape) < gap] = "-"
    return ["".join(row) for row in out]


def cons_fasta(columns) -> str:
    return "".join(f">s{i}\n{c}\n" for i, c in enumerate(columns))


def fasta_text(codes, alphabet=ALPHA) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1} (as bench.py);
    protein codes with alphabet=CODES_STRING_AA."""
    return "".join(f">s{i}\n{''.join(alphabet[c] for c in row)}\n"
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
# refreshes (require_scans), no longer as launches of their own, and the
# single-call me_average's calls in the whole-tree passes' sweeps
DENSE_PATH = ("me_dists", "me_dists_list", "me_average_sweep",
              "me_spr_round", "me_nni_round", "nj_join_epoch")
# me_dists' single calls in the N=2000 -noml run, all in the NJ phase: the
# leaves' out-distances (1), the top-hits seeding (19) and the root's three
# pairs (3)
NJ_DISTS_CALLS = 23


def require_whole_tree_passes(label, counts):
    """The ME lengths and the split test ran as one sweep and one list
    each, and no single-call average ran."""
    me = {k: counts[k] for k in ("me_average", "me_average_sweep",
                                 "me_dists_list")}
    if me != {"me_average": 0, "me_average_sweep": 2, "me_dists_list": 2}:
        raise AssertionError(f"{label}: ME store launches {me}")


def require_scans(label):
    """The refresh scans of the run's join epoch (the bodies of nj_scan_dense
    and, in a two-tier store, of nj_scan_codes) ran: returns their count."""
    scans = wrappers()["nj_join_epoch"].totals["scans"]
    if scans == 0:
        raise AssertionError(f"{label}: the join epoch ran no refresh scan")
    return scans


def phase_golden(report, dev):
    from util import rf_distance

    with open(GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(GOLDEN + ".json") as f:
        golden_len = json.load(f)["total_len"]
    with open(NOML_GOLDEN + ".nwk") as f:
        boot_golden = f.read()
    with open(NOML_GOLDEN + ".json") as f:
        noml = json.load(f)
    fasta = fasta_text(synth_codes(500, 500, seed=0))
    layouts = (("dense", {}), ("two-tier", {"two_tier_min": 0}))
    trees = {}
    for label, overrides in layouts:
        nw, nj, wall, counts = counted_run(fasta, dev, **overrides)
        rf, n_splits = rf_distance(nw, golden)
        print(f"  N=500 {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX "
              f"golden, byte-identical {nw == golden}, tree length "
              f"{nj.total_len():.6f} (golden {golden_len:.6f}), launches "
              f"{counts}")
        if rf != 0:
            raise AssertionError(f"{label}: RF {rf} to the golden tree")
        require_launched(label, counts, DENSE_PATH)
        require_whole_tree_passes(label, counts)
        require_scans(label)
        trees[label] = nw
    if trees["dense"] != trees["two-tier"]:
        raise AssertionError("two-tier and dense Newick differ")

    # -nt -noml: the ME local bootstrap's supports from 1000 resamples
    for label, overrides in layouts:
        nw, nj, wall, counts = counted_run(fasta, dev, n_bootstrap=1000,
                                           **overrides)
        print(f"  N=500 {label} -nt -noml: {wall:.2f} s (boot_s "
              f"{nj.timings['boot_s']:.4f} s, {nj.boot_stats}), "
              f"byte-identical to the JAX golden {nw == boot_golden}, "
              f"suboptimal splits {nj.debug.n_suboptimal_splits} (golden "
              f"{noml['n_suboptimal_splits']})")
        if nw != boot_golden or \
                nj.debug.n_suboptimal_splits != noml["n_suboptimal_splits"]:
            raise AssertionError(f"{label} -nt -noml: the Newick with "
                                 "supports differs from the golden")
        require_launched(label, counts, DENSE_PATH + (
            "me_dist_pieces_list", "sh_resample_counts"))

    # -makematrix: one scan of each sequence against every row
    for (label, overrides), scan in zip(layouts, ("nj_scan_dense",
                                                  "nj_scan_codes")):
        out, _, wall, counts = counted_run(fasta, dev, make_matrix=True,
                                           **overrides)
        sha = hashlib.sha256(out.encode()).hexdigest()
        print(f"  N=500 {label} -makematrix: {wall:.2f} s, {len(out)} bytes, "
              f"SHA-256 {sha[:16]}... (golden "
              f"{noml['makematrix_sha256'][:16]}...), {scan} launches "
              f"{counts[scan]}")
        if sha != noml["makematrix_sha256"]:
            raise AssertionError(f"{label} -makematrix: SHA-256 differs from "
                                 "the golden's")
        if counts[scan] != 500:
            raise AssertionError(f"{label} -makematrix: {counts[scan]} "
                                 f"{scan} launches, not one a sequence")
        report.setdefault(scan, {})["makematrix_launches"] = counts[scan]

    # -intree: the ME rounds and lengths from the N=500 golden tree
    nw, _, wall, counts = counted_run(fasta, dev,
                                      intree_file=GOLDEN + ".nwk")
    print(f"  N=500 -nosupport -intree {os.path.relpath(GOLDEN, REPO)}.nwk: "
          f"{wall:.2f} s, byte-identical to the JAX golden "
          f"{nw == noml['intree_newick']}, nj_join_epoch launches "
          f"{counts['nj_join_epoch']}")
    if nw != noml["intree_newick"] or counts["nj_join_epoch"]:
        raise AssertionError("-intree: the Newick differs from the golden, "
                             "or the NJ phase ran")

    # the same input through the command line, in a process of its own:
    # -nt -noml with its supports, the topology RF 0 to the -nosupport
    # golden and the Newick the supports golden's
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "n500.fasta")
        with open(path, "w") as f:
            f.write(fasta)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-noml",
             "-threads", "1", "-quiet", path], cwd=REPO, capture_output=True,
            text=True, timeout=600, check=False)
    rf = rf_distance(res.stdout, golden)[0] if res.returncode == 0 else None
    print(f"  N=500 command line -nt -noml: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.2f} s, RF {rf} to the JAX golden, "
          f"byte-identical to the supports golden "
          f"{res.stdout == boot_golden}")
    if res.returncode != 0 or rf != 0 or res.stdout != boot_golden:
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
            MAIN_RUNS["noml"] = (wall, dict(nj.timings))
            sha = hashlib.sha256(nw.encode()).hexdigest()
            print(f"  Newick SHA-256 {sha[:16]}... (recorded {NOML_MAIN_SHA}...)")
            if not sha.startswith(NOML_MAIN_SHA):
                raise AssertionError(f"{label}: Newick SHA-256 {sha}, recorded "
                                     f"{NOML_MAIN_SHA}...")
            require_launched(label, counts, DENSE_PATH)
            require_whole_tree_passes(label, counts)
            if counts["me_dists"] > NJ_DISTS_CALLS:
                raise AssertionError(f"{label}: {counts['me_dists']} "
                                     "single me_dists calls")
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
                  f"{counts['me_average']}, me_average_sweep "
                  f"{counts['me_average_sweep']}, me_dists "
                  f"{counts['me_dists']} and its list "
                  f"{counts['me_dists_list']}; split test "
                  f"{t['splits_s']:.4f} s, lengths {t['lengths_s']:.4f} s")
            for name, count in counts.items():
                if name not in ML_KERNELS:
                    report.setdefault(name, {})["launches"] = count
        elif label == "two-tier":
            report["nj_scan_codes"]["two_tier_epoch_scans"] = \
                require_scans(label)
    if runs["two-tier"] != runs["cold"] or runs["warm"] != runs["cold"]:
        raise AssertionError("the three runs gave different trees")

    # -nt -noml: the same input with the ME local bootstrap's supports
    # (1000 resamples): its launches are the new kernel's main path
    nw, nj, wall, counts = counted_run(fasta, dev, n_bootstrap=1000)
    t = nj.timings
    boot = {k: counts[k] for k in ("me_dist_pieces_list", "sh_resample_counts",
                                   "me_average_sweep", "me_dists_list")}
    print(f"  N={n} P={MAIN_P} -nt -noml (supports): wall {wall:.2f} s; "
          f"split test {t['splits_s']:.4f} s, local bootstrap "
          f"{t['boot_s']:.4f} s ({nj.boot_stats}); launches {boot}")
    require_launched("supports", counts, DENSE_PATH + (
        "me_dist_pieces_list", "sh_resample_counts"))
    if boot != {"me_dist_pieces_list": 1, "sh_resample_counts": 1,
                "me_average_sweep": 2, "me_dists_list": 2}:
        raise AssertionError(f"supports: the bootstrap's launches {boot}")
    if re.sub(r"\)[\d.]+:", "):", nw) != runs["cold"]:
        raise AssertionError("supports: the tree differs from the -nosupport "
                             "runs'")
    report.setdefault("me_dist_pieces_list", {}).update(
        launches=counts["me_dist_pieces_list"], noml_wall_s=wall,
        boot_s=t["boot_s"], splits_s=t["splits_s"])
    report.setdefault("sh_resample_counts", {})["noml_launches"] = \
        counts["sh_resample_counts"]


# ------------------------------------------------------------- phases 5, 6
ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")


def run_ml(fasta, dev, log_out=None, **overrides):
    """One ML run through run_pipeline with every launch count set to 0
    just before it.  Returns (newick, nj, wall, counts, per-round
    (LogLk, NNIs), final LogLk); the LogLk values are the run's log
    lines, whose text goes into the list log_out where given."""
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
    if log_out is not None:
        log_out.append(text)
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
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt",
             "-threads", "1", "-quiet", path], cwd=REPO, capture_output=True,
            text=True, timeout=600, check=False)
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
    MAIN_RUNS["ml"] = (wall, dict(t))
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
    sha = hashlib.sha256(nw.encode()).hexdigest()
    print(f"  Newick SHA-256 {sha[:16]}... (recorded {ML_MAIN_SHA}...)")
    if f"{final:.3f}" != ML_MAIN_LOGLK or not sha.startswith(ML_MAIN_SHA):
        raise AssertionError(f"final LogLk {final:.3f}, Newick SHA-256 {sha}; "
                             f"recorded {ML_MAIN_LOGLK}, {ML_MAIN_SHA}...")
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
    # and the ME lengths as one sweep and one list
    want = {"ml_posterior": 1, "ml_pair_loglk": 1,
            "ml_posterior_sweep": CAT_N + 3,
            "ml_tree_loglk": CAT_N + len(rounds) + 1,
            "me_average": 0, "me_average_sweep": 1, "me_dists_list": 1}
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


# ------------------------------------------------------------- phase 2j
def protein_round_case(report, dev):
    """One ML lengths pass, then one ML NNI round, at 20 codes (JTT, CAT 20
    rates fitted to the port's NJ tree of a protein alignment, N=SPR_N,
    -approxml's rough posteriors off as in the default run) through one
    launch of each kernel, through the host loops with the per-call
    kernels (tree, branch lengths, NNIStats, counters, the rough and exact
    posterior counts and the node and up-profile rows bit for bit) and
    through the plain twins on CPU copies, the pass from the start and the
    round from the kernel's state after its pass (the tree LogLk after the
    pass within ML_TWIN_RTOL; each quartet's deciding differences within
    ML_CRITERIA_TOL_20; the round's tree, NNI count, counters, max_delta
    and LogLk (ML_TWIN_RTOL) as the kernel's, unless a quartet decision
    flips on a near tie, ML_ROUND_NEAR_TIE_20, where the trees part); and
    every quartet of the card's round decided again by the twins from the
    card's inputs (the deciding differences within ML_CRITERIA_TOL_20, a
    flip only on a near tie, ML_TWIN_NEAR_TIE).  Reports the kernels' device
    times, walls and bounds under ml_nni_round<20> and
    ml_lengths_pass<20>."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.engine import ml, rearrange
    from veryfasttree_tpu_torch.ops import _build, ml_round

    cpu = torch.device("cpu")
    lengths, nni = ml_round.ml_lengths_pass, ml_round.ml_nni_round
    label = f"N={SPR_N} JTT CAT 20"
    start = ml_start(SPR_N, dev, "jtt", cat=True)
    # the first launch of each 20-code kernel in the process loads it (some
    # seconds): once each on a copy before the timed runs
    warm = ml_copy(start, dev)
    lengths(warm)
    nni(warm, 0, 2, rearrange.NNIStats.init(warm))
    runs = {}
    for name, where, kernel in (("kernel", dev, True),
                                ("host loop", dev, False),
                                ("twin", cpu, True)):
        nj = ml_copy(start, where)
        stats = rearrange.NNIStats.init(nj)
        if kernel:
            steps = (("pass", lambda: lengths(nj)),
                     ("round", lambda: nni(nj, 0, 2, stats)))
        else:
            steps = (("pass", lambda: ml.optimize_all_branch_lengths(nj)),
                     ("round", lambda: rearrange.do_nni(nj, 0, 2, True,
                                                        stats)))
        run = {}
        reset_launches()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)         # the twin's tiny ops only contend
        for what, fn in steps:
            if name == "twin" and what == "round":
                # the twins' round from the kernel's state after its pass,
                # not from their own pass's lengths: the decisions then part
                # only by the round's own float32 searches
                nj = ml_copy(after_pass, where)
                stats = rearrange.NNIStats.init(nj)
            if name == "host loop":
                rows = record_ml_rows(nj)
            out = []
            t0 = time.perf_counter()
            if name != "kernel" and what == "round":
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
            if name == "kernel" and what == "pass":
                after_pass = ml_copy(nj, cpu)
        torch.set_num_threads(threads)
        run.update(layout=nni.tree_layout, scratch=nni.scratch_floats,
                   pass_totals=dict(lengths.totals),
                   round_totals=dict(nni.totals),
                   launches=(lengths.launches, nni.launches))
        runs[name] = run
    k, h, t = runs["kernel"], runs["host loop"], runs["twin"]
    if k["launches"] != (1, 1):
        raise AssertionError(f"ml round kernels {label}: launches "
                             f"{k['launches']}, not one each")
    for what in ("pass", "round"):
        diff = ml_diff(h[what], k[what])
        if diff:
            raise AssertionError(f"ml round kernels {label}: after the "
                                 f"{what}, {diff} differ between the kernel "
                                 "and the host loop")
    P, C = start.ml.W.shape[1], start.ml.V.shape[2]
    print(f"  ml_lengths_pass<20> [{label}]: bit for bit the host loop's; one "
          f"launch, {k['pass_s']:.3f} s (the host loop {h['pass_s']:.3f} s), "
          f"LogLk {k['pass_loglk']:.3f}; {k['pass_totals']}")
    print(f"  ml_nni_round<20> [{label}]: bit for bit the host loop's; one "
          f"launch, {k['round_s']:.3f} s (the host loop {h['round_s']:.3f} "
          f"s), {k['round'][1]['round']} (NNIs, max delta), LogLk "
          f"{k['round_loglk']:.3f}, tree in {k['layout']}, {k['scratch']} "
          "floats of device scratch (the quartet temporaries, in the group "
          f"blocks' shared memory where they fit); {k['round_totals']}")
    # the layout of the groups (ml_round.GROUP blocks each): no quartet
    # piece in device scratch at P=512, round or pass
    for wrapper in (lengths, nni):
        lay = wrapper.layout
        print(f"  {wrapper.__name__}<20> layout: a cluster of {lay['blocks']} "
              f"blocks (groups of k={lay['group']}), "
              f"{lay['smem_bytes']} bytes of dynamic shared memory a block "
              f"(a group block's {lay['group_smem_bytes']}), "
              f"{lay['local_positions']} positions a group block, "
              f"{lay['scratch_floats']} floats of device scratch")
        if k["scratch"] or lay["scratch_floats"]:
            raise AssertionError(f"{wrapper.__name__}<20> [{label}]: "
                                 f"{lay['scratch_floats']} floats of device "
                                 f"scratch at P={P}")
    for kernel in ("ml_nni_round_kernel", "ml_lengths_pass_kernel"):
        if PTXAS:
            print(f"  {kernel}<20> (ptxas): "
                  f"{_build.kernel_resources(PTXAS, kernel, 20)}")
    rel = {what: abs(t[f"{what}_loglk"] - k[f"{what}_loglk"])
           / abs(k[f"{what}_loglk"]) for what in ("pass", "round")}
    # every quartet of the round decided again by the twins from the card's
    # own inputs: the host loop on the card (bit for bit the kernel) from the
    # kernel's state after its pass, each quartet's rows copied to a twin
    # engine on the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    nj = ml_copy(after_pass, dev)
    card_log, twin_log = ml_decisions(
        lambda: rearrange.do_nni(nj, 0, 2, True, rearrange.NNIStats.init(nj)),
        ml_copy(after_pass, cpu))
    torch.set_num_threads(threads)
    if [x[:2] for x in card_log] != [x[:2] for x in h["log"]]:
        raise AssertionError(f"ml round kernels {label}: the host loop's "
                             "round from the kernel's pass decides otherwise")
    q_dec = max(float(np.max(np.abs((x[2] - x[2][0]) - (y[2] - y[2][0]))))
                for x, y in zip(card_log, twin_log))
    q_flips = [(q, [abs(c[x[1]] - c[y[1]]) for c in (x[2], y[2])])
               for q, (x, y) in enumerate(zip(card_log, twin_log))
               if x[1] != y[1]]
    print(f"  twins on the CPU [{label}], each of the round's "
          f"{len(card_log)} quartets from the card's inputs: deciding "
          f"differences within {q_dec:.3e} (limit {ML_CRITERIA_TOL_20:.0e}); "
          f"{len(q_flips)} decisions flip (quartet, margins on the card and "
          f"in the twins: {q_flips}; limit {ML_TWIN_NEAR_TIE:.0e})")
    if q_dec > ML_CRITERIA_TOL_20 or any(max(m) > ML_TWIN_NEAR_TIE
                                         for _, m in q_flips):
        raise AssertionError(f"ml round kernels {label}: the twins decide "
                             "the card's quartets otherwise")
    flip, crit_err, dec_err = first_flip(
        f"ml_nni_round<20> {label} twin", h["log"], t["log"],
        ML_ROUND_NEAR_TIE_20, ML_CRITERIA_TOL_20)
    margins = None if flip is None else [
        abs(c[h["log"][flip][1]] - c[t["log"][flip][1]])
        for c in (h["log"][flip][2], t["log"][flip][2])]
    print(f"  twins on the CPU [{label}]: lengths pass {t['pass_s']:.3f} s, "
          f"LogLk {t['pass_loglk']:.3f} ({rel['pass']:.2e} relative); NNI "
          f"round from the kernel's pass {t['round_s']:.3f} s, "
          f"{t['round'][1]['round']}, LogLk {t['round_loglk']:.3f} "
          f"({rel['round']:.2e} relative), {len(t['log'])} quartets, "
          + (f"the same decisions, criteria within {crit_err:.3e} (deciding "
             f"differences {dec_err:.3e}); counters {t['round'][1]}"
             if flip is None else
             f"a near tie flips at quartet {flip} of {len(h['log'])} "
             f"(margins {margins[0]:.4f} on the card, {margins[1]:.4f} in "
             f"the twins; criteria within {crit_err:.3e}, deciding "
             f"differences {dec_err:.3e} up to it)"))
    # after a flip the two rounds' trees part: the round is then held by
    # the quartets decided from the card's inputs above
    if rel["pass"] > ML_TWIN_RTOL or (flip is None
                                      and rel["round"] > ML_TWIN_RTOL):
        raise AssertionError(f"ml round kernels {label}: tree LogLk {rel} "
                             "relative from the twins'")
    (k_nni, k_max), (t_nni, t_max) = (r["round"][1]["round"] for r in (k, t))
    trees = [{n: r["round"][0][n] for n in ("parent", "children", "n_child")}
             for r in (k, t)]
    if flip is None and (
            k_nni != t_nni or abs(k_max - t_max) > ML_TWIN_NEAR_TIE
            or any(not np.array_equal(trees[0][n], trees[1][n])
                   for n in trees[0])
            or {c: v for c, v in k["round"][1].items() if c != "round"}
            != {c: v for c, v in t["round"][1].items() if c != "round"}):
        same = {n: np.array_equal(trees[0][n], trees[1][n]) for n in trees[0]}
        raise AssertionError(f"ml round kernels {label}: {k['round'][1]}, "
                             f"the twins' {t['round'][1]}; trees {same}")
    for wrapper, what in ((lengths, "pass"), (nni, "round")):
        def one(wrapper=wrapper):
            nj = ml_copy(start, dev)
            if wrapper is nni:
                wrapper(nj, 0, 2, rearrange.NNIStats.init(nj))
            else:
                wrapper(nj)

        name = wrapper.__name__
        dev_us = device_us(one, DEVICE_NAMES[name], runs=2)
        totals = k[f"{what}_totals"]
        bound_ms, bound_by, n_bytes, n_ops = ml_round_bound(
            totals, h[f"{what}_rows"], P, C, False)
        per, unit = (totals["quartets"], "quartet optimization") \
            if wrapper is nni else (totals["searches"], "line search")
        report[f"{name}<20>"] = {
            "max_abs_err": abs(t[f"{what}_loglk"] - k[f"{what}_loglk"]),
            "ms": 1e3 * k[f"{what}_s"], "plain_ms": 1e3 * t[f"{what}_s"],
            "host_loop_ms": 1e3 * h[f"{what}_s"], "device_us": dev_us,
            "device_us_per_node": dev_us / (SPR_N - 2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "scratch_floats": k["scratch"], "tree_layout": k["layout"]}
        print(f"  {name}<20> [{label}]: device {dev_us / 1e3:.3f} ms for the "
              f"{what} ({dev_us / max(per, 1):.3f} us per {unit}); "
              f"{h[f'{what}_rows']} rows read or written, {n_ops:.4e} "
              f"operations: bound {bound_ms:.4e} ms ({bound_by}; bytes "
              f"{1e3 * n_bytes / HBM_BYTES_PER_S:.4e} ms, operations "
              f"{1e3 * n_ops / F32_OPS_PER_S:.4e} ms)")
    # a row for each group size the kernels take: the pass and the round
    # from the same start, bit for bit the host loop's, and their device
    # times (the default, ml_round.GROUP, is the one reported above)
    for k_blocks in ml_round.GROUPS:
        row = {}
        for wrapper, what in ((lengths, "pass"), (nni, "round")):
            def one(wrapper=wrapper, k_blocks=k_blocks):
                nj = ml_copy(start, dev)
                if wrapper is nni:
                    wrapper(nj, 0, 2, rearrange.NNIStats.init(nj),
                            group=k_blocks)
                else:
                    wrapper(nj, group=k_blocks)
                return nj

            nj = ml_copy(start, dev)
            stats = rearrange.NNIStats.init(nj)
            lengths(nj, group=k_blocks)
            got = ml_state(nj)
            if what == "round":
                ml.tree_loglk(nj)       # as the runs above, between the two
                res = nni(nj, 0, 2, stats, group=k_blocks)
                got = ml_state(nj, stats, res)
            diff = ml_diff(h[what], got)
            if diff:
                raise AssertionError(f"{wrapper.__name__}<20> with groups of "
                                     f"{k_blocks} blocks: {diff} differ from "
                                     f"the host loop (counters {got[1]}, the "
                                     f"host loop's {h[what][1]})")
            us = device_us(one, DEVICE_NAMES[wrapper.__name__], runs=2)
            per = k[f"{what}_totals"]["quartets" if what == "round"
                                      else "searches"]
            row[what] = {"device_us": us, "us_per_item": us / max(per, 1),
                         **wrapper.layout}
        report["ml_nni_round<20>"].setdefault("groups", {})[k_blocks] = row
        r, ps = row["round"], row["pass"]
        print(f"  groups of k={k_blocks}: round {r['device_us'] / 1e3:.3f} ms "
              f"({r['us_per_item']:.2f} us per quartet optimization, "
              f"{r['blocks']} blocks, {r['smem_bytes']} bytes of shared "
              f"memory a block, {r['scratch_floats']} floats of scratch), "
              f"pass {ps['device_us'] / 1e3:.3f} ms ({ps['us_per_item']:.2f} "
              f"us per line search, {ps['blocks']} blocks); bit for bit the "
              "host loop's")


def check_gate(report, dev):
    """ml_posterior at 20 codes with -approxml's rough-posterior gate on a
    random JTT store of the N=MAIN_N layout: the SH pass's list shape (2S
    posteriors into the list-pass rows), half of leaf pairs at short
    lengths (mostly rough) and half of internal rows, against the twin on
    the card: codes and weights equal, vectors within 1e-6, the rough and
    exact counts equal (and neither 0).  Timed as phase 2's lists;
    reported under ml_posterior<20>."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    codes, W, V, m = ml_store_case(20, "jtt", gen, dev, approx=True)
    n_rows, P = codes.shape
    rng = np.random.default_rng(20)
    K, half = LIST_POSTERIORS, LIST_POSTERIORS // 2
    r1 = np.concatenate([rng.integers(0, MAIN_N, half),
                         rng.integers(MAIN_N, 2 * MAIN_N, K - half)])
    r2 = np.concatenate([rng.integers(0, MAIN_N, half),
                         rng.integers(0, 2 * MAIN_N, K - half)])
    lens = np.concatenate([rng.uniform(5e-4, 0.05, half),
                           rng.uniform(5e-4, 0.5, K - half)])
    args = (n_rows - 2 * MAIN_N + np.arange(K), r1, r2, lens,
            rng.permutation(lens))
    outs, counts = [], []
    for fn in (mk.ml_posterior, mk.ml_posterior_ref):
        c, w, v = codes.clone(), W.clone(), V.clone()
        m.counts.zero_()
        fn(c, w, v, m, *args)
        outs.append((c, w, v))
        counts.append(m.counts.tolist())
    (c1, w1, v1), (c2, w2, v2) = outs
    err = float((v1 - v2).abs().max())
    if not (torch.equal(c1, c2) and torch.equal(w1, w2)) or err > 1e-6:
        raise AssertionError(f"ml_posterior<20> gate: rows {err:.3e} from "
                             "the twin's (codes, weights equal: "
                             f"{torch.equal(c1, c2)}, {torch.equal(w1, w2)})")
    if counts[0] != counts[1] or min(counts[0]) == 0:
        raise AssertionError(f"ml_posterior<20> gate: rough/exact counts "
                             f"{counts[0]}, the twin's {counts[1]}")
    del outs, c1, w1, v1, c2, w2, v2
    lst = (codes.clone(), W.clone(), V.clone(), m, *args)
    n_distinct = len(np.unique(np.concatenate([r1, r2])))
    times = timing("ml_posterior", lambda: mk.ml_posterior(*lst),
                   lambda: mk.ml_posterior_ref(*lst),
                   (n_distinct + K) * ml_row_bytes(P, 20) + 4 * P,
                   K * P * ml_ops(20, False)[2], twin_runs=5)
    report["ml_posterior<20>"] = {"max_abs_err": err, "list_k": K,
                                  "rough_exact": counts[0], **times}
    print(f"  ml_posterior<20> [{n_rows}x{P} JTT, -approxml gate, {K} "
          f"posteriors]: rough/exact positions {counts[0]} (the twin's "
          f"{counts[1]}), max abs err {err:.3e}; kernel {times['ms']:.4f} "
          f"ms launch to launch, {times['device_us']:.3f} us on the device, "
          f"twin {times['plain_ms']:.4f} ms, bound {times['bound_ms']:.3e} "
          f"ms ({times['bound_by']})")


def phase_protein_kernels(report, dev):
    """The ML kernels at 20 codes: the round kernels (protein_round_case),
    the rough-posterior gate (check_gate), and the whole-tree sweep and
    tree log-likelihood (check_sweep) on a balanced tree of MAIN_N leaves of
    a protein alignment (JTT, CAT 20, the gate on), whose rough and exact
    counts must equal the per-level launches'."""
    protein_round_case(report, dev)
    check_gate(report, dev)
    nj = shaped_start(MAIN_N, dev, "balanced", "jtt", approx=True)
    out, _ = check_sweep(f"balanced N={MAIN_N} JTT CAT 20 -approxml", nj, dev,
                         old="balanced<20>")
    for name, (err, times) in out.items():
        report[f"{name}<20>"] = {"max_abs_err": err, **times}
    nj = shaped_start(DEEP_N, dev, "caterpillar", "jtt", approx=True)
    out, sw = check_sweep(f"caterpillar N={DEEP_N} JTT CAT 20 -approxml", nj,
                          dev, old="caterpillar<20>")
    if sw.posteriors.n_levels < DEEP_N - 3:
        raise AssertionError(f"20-code caterpillar: {sw.posteriors.n_levels} "
                             "levels")
    for name, (err, times) in out.items():
        entry = report[f"{name}<20>"]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry.update({f"deep_{k}": v for k, v in times.items()
                      if k in ("ms", "device_us", "per_level_ms",
                               "bound_ms")})


# ------------------------------------------------------------- phases 7a, 7b
SHARE = re.compile(r"approximate-posteriors ([\d.]+)%")


def run_protein(fasta, dev, **overrides):
    """run_ml of a protein run (n_codes 20, the stats block printed):
    also returns the approximate-posteriors share of its stats line."""
    log = []
    out = run_ml(fasta, dev, log, n_codes=20, verbose=2, **overrides)
    shares = SHARE.findall(log[0])
    return (*out, shares[-1] if shares else None)


def host_loop_rounds(fn):
    """Run fn() with every ML NNI round through the host loop with the
    per-call kernels (engine/rearrange.do_nni; bit for bit the round
    kernel, phase 2j) and engine/ml.ml_quartet_nni logging its decisions:
    returns (fn's result, [(rows, choice, criteria)])."""
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.ops import ml_round

    orig, out = ml_round.ml_nni_round, []
    ml_round.ml_nni_round = \
        lambda nj, i, n, stats, **kw: rearrange.do_nni(nj, i, n, True, stats)
    try:
        log = ml_decisions(lambda: out.append(fn()))
    finally:
        ml_round.ml_nni_round = orig
    return out[0], log


def golden_flip(label, suffix, rerun, newick):
    """Where the port's tree is not the golden's: rerun() the same run with
    the ML NNI rounds through the host loop, its decisions logged
    (host_loop_rounds), which must give the same Newick, and find the first
    decision it takes otherwise than the JAX package's (the golden's
    _decisions.json): before it each quartet's deciding differences within
    ML_CRITERIA_TOL_20 of the golden's, and it a near tie (first_flip).
    Returns (index, count, margins, the deciding differences' max abs
    difference up to it)."""
    import numpy as np

    out, log = host_loop_rounds(rerun)
    if out[0] != newick:
        raise AssertionError(f"{label}: the host loop's Newick is not the "
                             "round kernel's")
    with open(PROTEIN_GOLDEN + suffix + "_decisions.json") as f:
        golden = [(tuple(rows), choice, np.array(crit, dtype=np.float64))
                  for rows, choice, crit in json.load(f)]
    flip, _, dec_err = first_flip(f"{label} against the JAX package", golden,
                                  log, ML_TWIN_NEAR_TIE, ML_CRITERIA_TOL_20)
    if flip is None:
        raise AssertionError(f"{label}: the trees differ, but no ML NNI "
                             "decision does")
    margins = [abs(c[golden[flip][1]] - c[log[flip][1]])
               for c in (golden[flip][2], log[flip][2])]
    return flip, len(golden), margins, dec_err


def phase_protein_golden(dev):
    """The default protein run (JTT, CAT 20, SH-like supports from 1000
    resamples), -lg -gamma and -approxml at N=PROTEIN_GOLDEN_N,
    P=PROTEIN_GOLDEN_P against the JAX package's trees
    (scripts/make_torch_port_protein_golden.py): RF 0 and the final LogLk
    within 1e-4 relative; the ML-NNIs per round and the
    approximate-posteriors share printed beside the golden's, the rough
    count 0 without -approxml, and with it, where the trees agree, the
    share within 0.02 points and the rough and exact counts within
    PROTEIN_COUNT_RTOL of the golden's.  Where the RF is not 0, the trees
    must part at an ML NNI decision that is a near tie, the decisions
    before it alike (golden_flip), which is printed with its margins."""
    from veryfasttree_tpu_torch.constants import CODES_STRING_AA

    from util import rf_distance

    fasta = fasta_text(synth_codes(PROTEIN_GOLDEN_N, PROTEIN_GOLDEN_P, seed=0,
                                   n_codes=20), CODES_STRING_AA)
    for suffix, overrides in (("", {}), ("_lg_gamma", {
            "use_lg": True, "gamma_loglk": True}),
            ("_approxml", {"exact_ml": False})):
        with open(PROTEIN_GOLDEN + suffix + ".nwk") as f:
            golden = f.read()
        with open(PROTEIN_GOLDEN + suffix + ".json") as f:
            meta = json.load(f)
        label = (f"N={PROTEIN_GOLDEN_N} P={PROTEIN_GOLDEN_P} protein "
                 f"{suffix[1:].replace('_', ' -') or 'default'}")
        nw, nj, wall, counts, rounds, final, share = run_protein(
            fasta, dev, **overrides)
        rf, n_splits = rf_distance(nw, golden)
        rel = abs(final - meta["final_loglk"]) / abs(meta["final_loglk"])
        print(f"  {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX "
              f"golden, final LogLk {final:.3f} (golden "
              f"{meta['final_loglk']:.3f}, rel diff {rel:.2e}); ML-NNIs per "
              f"round {[r[1] for r in rounds]} (golden {meta['round_nnis']});"
              f" approximate-posteriors {share}% (golden "
              f"{meta['approx_share']}%), rough/exact "
              f"{nj.debug.n_aa_posterior_rough}/"
              f"{nj.debug.n_aa_posterior_exact} (golden "
              f"{meta['n_aa_posterior_rough']}/"
              f"{meta['n_aa_posterior_exact']}); launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if not rel <= 1e-4:
            raise AssertionError(f"{label}: RF {rf}, final LogLk rel diff "
                                 f"{rel:.2e}")
        rough, exact = (nj.debug.n_aa_posterior_rough,
                        nj.debug.n_aa_posterior_exact)
        if not overrides.get("exact_ml", True):
            # -approxml: the share within 0.02 points and each count within
            # PROTEIN_COUNT_RTOL of the golden's (where the trees agree: the
            # counts follow the run's searches)
            off = [abs(x - meta[k]) / meta[k] for x, k in (
                (rough, "n_aa_posterior_rough"),
                (exact, "n_aa_posterior_exact"))]
            print(f"  {label}: rough/exact counts {off[0]:.2e}, {off[1]:.2e}"
                  f" relative from the golden's")
            if rf == 0 and (abs(float(share) - float(meta["approx_share"]))
                            > 0.02
                            or max(off) > PROTEIN_COUNT_RTOL):
                raise AssertionError(f"{label}: approximate-posteriors "
                                     f"{share}%, counts {rough}/{exact}, "
                                     "against the golden's")
        elif rough != 0 or meta["n_aa_posterior_rough"] != 0:
            raise AssertionError(f"{label}: {rough} rough positions (golden "
                                 f"{meta['n_aa_posterior_rough']}) without "
                                 "-approxml")
        if rf != 0:
            flip, n_dec, margins, dec_err = golden_flip(
                label, suffix, lambda: run_protein(fasta, dev, **overrides),
                nw)
            print(f"  {label}: the trees part at ML NNI decision {flip} of "
                  f"{n_dec}, a near tie: its two choices {margins[0]:.2e} "
                  f"apart in the JAX package, {margins[1]:.2e} in the port "
                  f"(limit {ML_TWIN_NEAR_TIE:.0e}); the deciding differences"
                  f" within {dec_err:.3e} up to it (limit "
                  f"{ML_CRITERIA_TOL_20:.0e})")


def phase_protein_main(report, dev):
    """The default protein run at N=PROTEIN_N, P=PROTEIN_P: the protein ML
    main path (BASELINE.json's ~5k-taxa JTT+CAT config), warm (phase 7a ran
    the code).  The launch counts are reset just before it and read just
    after it: ml_nni_round and ml_lengths_pass launched at 20 codes (their
    scratch and tree layout printed), ml_posterior and ml_pair_loglk only in
    the SH pass's lists, the CAT fit in whole-tree sweeps only (CAT_N + 2
    sweeps, CAT_N tree log-likelihoods)."""
    from veryfasttree_tpu_torch.constants import CODES_STRING_AA
    from veryfasttree_tpu_torch.ops import ml_round

    from util import newick_splits

    n = PROTEIN_N
    fasta = fasta_text(synth_codes(n, PROTEIN_P, seed=0, n_codes=20),
                       CODES_STRING_AA)
    ((nw, nj, wall, counts, rounds, final, share), cat), sh, sh_pass = \
        sh_launches(lambda: cat_launches(lambda: run_protein(fasta, dev)))
    t = nj.timings
    nj_s = t["store_s"] + t["tophits_s"] + t["joins_s"]
    print(f"  N={n} P={PROTEIN_P} protein default: wall {wall:.2f} s; NJ "
          f"{nj_s:.3f} s (store {t['store_s']:.3f}, top-hits "
          f"{t['tophits_s']:.3f}, joins {t['joins_s']:.3f}), ME NNI "
          f"{t['nni_s']:.3f} s, SPR {t['spr_s']:.3f} s, ME lengths "
          f"{t['lengths_s']:.3f} s, ML lengths {t['ml_lengths_s']:.3f} s, ML "
          f"NNI {t['ml_nni_s']:.3f} s ({len(rounds)} rounds), CAT "
          f"{t['cat_s']:.3f} s, SH {t['sh_s']:.3f} s; final LogLk "
          f"{final:.3f}; ML-NNIs per round {[r[1] for r in rounds]}; "
          f"approximate-posteriors {share}% (rough/exact "
          f"{nj.debug.n_aa_posterior_rough}/{nj.debug.n_aa_posterior_exact});"
          f" launches {counts}")
    _, leaves = newick_splits(nw)
    if len(leaves) != n or not math.isfinite(final):
        raise AssertionError(f"{len(leaves)} leaves, final LogLk {final}")
    require_launched("protein main path", counts, ML_PATH + (
        "nj_join_epoch", "me_spr_round", "me_nni_round"))
    rounds_t, pass_t = (wrappers()[k].totals
                        for k in ("ml_nni_round", "ml_lengths_pass"))
    print(f"  ML round kernels at 20 codes: ml_nni_round "
          f"{counts['ml_nni_round']} launches ({rounds_t['quartets']} quartet"
          f" optimizations, {rounds_t['n_ml_nni']} NNIs, "
          f"{rounds_t['speculative']} speculative AC/AD discarded), "
          f"ml_lengths_pass {counts['ml_lengths_pass']} launches "
          f"({pass_t['searches']} line searches); the tree in "
          f"{ml_round.ml_nni_round.tree_layout}, "
          f"{ml_round.ml_nni_round.scratch_floats} floats of device scratch;"
          f" round layout {ml_round.ml_nni_round.layout}")
    print(f"  SH pass: sh_s {t['sh_s']:.3f} s, {sh_pass.S} splits; launches "
          f"{ {k: v for k, v in sh.items() if v} }; CAT fit: cat_s "
          f"{t['cat_s']:.3f} s, launches "
          f"{ {k: v for k, v in cat.items() if v} }")
    for name in ("ml_posterior", "ml_pair_loglk"):
        if counts[name] != sh.get(name, 0):
            raise AssertionError(f"{name}: {counts[name]} launches in the "
                                 f"run, {sh.get(name, 0)} in the SH pass")
    want = {"ml_posterior_sweep": CAT_N + 2, "ml_tree_loglk": CAT_N}
    if any(cat.get(k) != v for k, v in want.items()) \
            or sum(cat.values()) != sum(want.values()):
        raise AssertionError(f"the CAT fit launched {cat}, not {want}")
    for entry, name in PROTEIN_KERNELS.items():
        report.setdefault(entry, {})["launches"] = counts[name]
    report["ml_nni_round<20>"].update(
        main_path_scratch_floats=ml_round.ml_nni_round.scratch_floats,
        main_path_tree_layout=ml_round.ml_nni_round.tree_layout,
        main_path_layout=ml_round.ml_nni_round.layout)


# -------------------------------------------------------------- phase 8
CONS_N, CONS_COLS = 500, 16
# -constraints: the JAX package's trees (scripts/make_torch_port_
# constraints_golden.py): -nt -noml at N=500, the default -nt run at N=200
CONS_GOLDEN = os.path.join(REPO, "tests", "data",
                           "torch_port_constraints_golden_n500_p500")
CONS_ML_GOLDEN = os.path.join(REPO, "tests", "data",
                              "torch_port_constraints_ml_golden_n200_p500")
# the protein start of ml_nni_round<20>'s check
CONS_PROTEIN_N, CONS_PROTEIN_P = 300, 300
# the wrappers of the four constrained kernels, with the kernels' names as
# torch.profiler shows them
CONS_KERNELS = {"nj_join_epoch": "nj_epoch_cons_kernel",
                "me_nni_round": "me_nni_round_cons_kernel",
                "me_spr_round": "me_spr_round_cons_kernel",
                "ml_nni_round": "ml_nni_round_cons_kernel"}
# the unconstrained main-path runs' walls and phase splits (phases 4, 6),
# printed beside the constrained ones
MAIN_RUNS = {}


def cons_counts(columns):
    """(nOn, nOff) [n, n_cols] int64 of a constraint alignment whose rows
    are the alignment's unique sequences in order."""
    import numpy as np

    a = np.array([list(c) for c in columns])
    return (a == "1").astype(np.int64), (a == "0").astype(np.int64)


def cons_start(n, dev, p=MAIN_P, protein=False, kernel=True):
    """The port's NJ phase on synth_codes(n, p) on dev under the
    constraints cons_columns(n, p) (protein: 20 codes under BLOSUM45), its
    joins through the constrained epoch kernel or, kernel=False, the host
    loop with the per-call kernels."""
    import torch

    from veryfasttree_tpu_torch.engine import epoch
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.models import DistanceMatrix
    from veryfasttree_tpu_torch.options import Options

    C = 20 if protein else 4
    opts = Options(n_codes=C, ml_nni=0, n_bootstrap=0, show_progress=False)
    opts.derive_settings()
    nj = NeighbourJoining(
        opts, synth_codes(n, p, n_codes=C),
        DistanceMatrix.blosum45() if protein else None, None,
        cons_counts(cons_columns(n, p, CONS_COLS, n_codes=C)), device=dev)
    supported = epoch.epoch_supported
    if not kernel:
        epoch.epoch_supported = lambda nj_, tophits: False
    try:
        nj.fast_nj()
        torch.cuda.synchronize()
    finally:
        epoch.epoch_supported = supported
    return nj


def cons_copy(nj, dev, ml_store=False):
    """engine_copy (ml_copy with ml_store) of nj with constraint counts of
    its own."""
    c = ml_copy(nj, dev) if ml_store else engine_copy(nj, dev)
    c.con_on, c.con_off = nj.con_on.copy(), nj.con_off.copy()
    return c


def cons_diff(a, b):
    """'counts' where two engines' constraint counts differ, else None."""
    import numpy as np

    same = np.array_equal(a.con_on, b.con_on) and \
        np.array_equal(a.con_off, b.con_off)
    return None if same else "counts"


def cons_ml_start(nj, model):
    """An ML store (Jukes-Cantor or JTT, one rate, recomputed posteriors)
    on nj after its ME branch lengths: the start of the first ML NNI
    round."""
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu_torch.models import TransitionMatrix

    rearrange.update_branch_lengths(nj)
    nj.ml = MLProfiles(nj, None if model == "jc" else TransitionMatrix.jtt92())
    nj.ml.recompute_ml_profiles()
    return nj


def cons_write(n, p, tmp):
    path = os.path.join(tmp, f"cons_n{n}.fasta")
    with open(path, "w") as f:
        f.write(cons_fasta(cons_columns(n, p, CONS_COLS)))
    return path


def phase_constraints(report, dev):
    """-constraints (CONS_COLS columns of cons_columns: half following the
    founder groups, half random bipartitions, 15% '-').  (a) At N=CONS_N:
    the join phase through the constrained epoch kernel against the host
    loop with the per-call kernels (every array of epoch_state and the
    counts bit for bit); from its tree one ME NNI round and one SPR round,
    each through its constrained kernel and the host loop (tree, NNIStats,
    counters, rows and counts bit for bit, deltas and supports as below); the ME split test as one list launch
    against the serial walk (SplitCount equal, constraint fields
    included); an ML store on that tree (JC, one rate) and one ML NNI round
    through the constrained kernel and the host loop (bit for bit, counts
    unchanged), then the SH pass against the host loop's split test
    (SplitCount equal); ml_nni_round<20> likewise on the protein start
    (CONS_PROTEIN_N, JTT).  The ME deltas and supports are held within
    NNI_DELTA_ATOL plus two ulps of the largest criterion the penalties
    allow (each relevant constraint adds at most twice the weight):
    log1p's last bit, as in phase 2c, moves a criterion that large by an
    ulp.  Each constrained kernel's device time
    (torch.profiler, its own kernel's name) goes into its kernels entry
    (cons_device_us).  (b) The JAX package's trees: -nt -noml at N=500
    byte-identical, the default run at N=200 RF 0 and final LogLk within
    1e-4 relative.  (c) -nt -noml and -nt at N=MAIN_N, P=MAIN_P, warm,
    with the launch counts reset just before each run: the constrained
    kernels launched; the phase split, SplitCount and wall beside the
    unconstrained runs of phases 4 and 6."""
    import dataclasses

    import numpy as np
    import torch

    from util import newick_splits, rf_distance
    from veryfasttree_tpu_torch.engine import ml, rearrange, spr, supports
    from veryfasttree_tpu_torch.ops import ml_round, nni_kernels, spr_kernels

    def entry(name):
        return report.setdefault(name, {"max_abs_err": 0.0})

    # (a) the kernels against their host loops
    t0 = time.perf_counter()
    start = cons_start(CONS_N, dev)
    wall = time.perf_counter() - t0
    reset_launches()
    host = cons_start(CONS_N, dev, kernel=False)
    diff = epoch_diff(epoch_state(start), epoch_state(host))
    diff += [cons_diff(start, host)] if cons_diff(start, host) else []
    if diff:
        raise AssertionError(f"nj_join_epoch under constraints: {diff} "
                             "differ from the host loop's")
    dev_us = device_us(lambda: cons_start(CONS_N, dev),
                       [CONS_KERNELS["nj_join_epoch"]], runs=3)
    entry("nj_join_epoch").update(
        cons_device_us=dev_us, cons_ms=1e3 * wall,
        cons_source="veryfasttree_tpu_torch/csrc/nj_epoch_cons.cu")
    print(f"  nj_join_epoch [N={CONS_N}, {CONS_COLS} constraints]: bit for "
          f"bit the host loop's (join log, tree, per-node arrays, rows, "
          f"top hits, counters, counts); device {dev_us / 1e3:.3f} ms for the "
          f"join phase ({dev_us / (CONS_N - 3):.3f} us a join)")

    def round_pair(name, kern, host_loop, state, diff_of, runs=10):
        out = {}
        for label, fn in (("kernel", kern), ("host loop", host_loop)):
            nj = cons_copy(start, dev)
            stats = rearrange.NNIStats.init(nj)
            t = time.perf_counter()
            res = fn(nj, stats)
            torch.cuda.synchronize()
            out[label] = (state(nj, stats, res), nj, time.perf_counter() - t)
        what = diff_of(out["host loop"][0], out["kernel"][0])
        what = what or cons_diff(out["host loop"][1], out["kernel"][1])
        if what:
            raise AssertionError(f"{name} under constraints: {what} differ "
                                 "from the host loop's")

        def one():
            nj = cons_copy(start, dev)
            kern(nj, rearrange.NNIStats.init(nj))

        us = device_us(one, [CONS_KERNELS[name]], runs=runs)
        entry(name).update(cons_device_us=us,
                           cons_ms=1e3 * out["kernel"][2])
        print(f"  {name} [N={CONS_N}, {CONS_COLS} constraints]: bit for bit "
              f"the host loop's (tree, counters, rows, counts); "
              f"{out['kernel'][2]:.3f} s (the host loop "
              f"{out['host loop'][2]:.3f} s), device {us / 1e3:.3f} ms")
        return out["kernel"][1]

    # the deltas and supports: log1p's last bit (NNI_DELTA_ATOL), carried
    # into criteria as large as the penalties (each term at most twice the
    # weight), two of whose ulps a difference may take
    w = start.options.constraint_weight
    delta_atol = NNI_DELTA_ATOL + 2 * 2.0 ** -52 * (6 + 2 * w * CONS_COLS)

    def nni_check(a, b):
        what, _, gap = nni_diff(a, b)
        print(f"  me_nni_round: deltas and supports within {gap:.3e} of the "
              f"host loop's (limit {delta_atol:.3e})")
        return what or ("deltas or supports" if gap > delta_atol else None)

    after_nni = round_pair(
        "me_nni_round", lambda nj, st: nni_kernels.nni_round(nj, 0, 2, st),
        lambda nj, st: rearrange.do_nni(nj, 0, 2, False, st),
        nni_state, nni_check)
    round_pair("me_spr_round",
               lambda nj, st: spr_kernels.spr_round(nj, 0, 2),
               lambda nj, st: spr.run_spr(nj, 0, 2),
               lambda nj, st, res: spr_state(nj),
               lambda a, b: spr_diff(a, b)[0], runs=3)
    sc_list = supports.test_splits_min_evo_batched(cons_copy(after_nni, dev))
    sc_walk = supports.test_splits_min_evo(cons_copy(after_nni, dev))
    if sc_list != sc_walk:
        raise AssertionError(f"the ME split test under constraints: "
                             f"{sc_list}, the serial walk {sc_walk}")
    print(f"  ME split test [N={CONS_N}]: the list's SplitCount is the serial "
          f"walk's: {dataclasses.asdict(sc_list)}")

    for label, nj0, model, name in (
            (f"N={CONS_N} JC", start, "jc", "ml_nni_round"),
            (f"N={CONS_PROTEIN_N} JTT", None, "jtt", "ml_nni_round<20>")):
        if nj0 is None:
            nj0 = cons_start(CONS_PROTEIN_N, dev, p=CONS_PROTEIN_P,
                             protein=True)
        ml_start_ = cons_ml_start(cons_copy(nj0, dev), model)
        out = {}
        for how in ("kernel", "host loop"):
            nj = cons_copy(ml_start_, dev, ml_store=True)
            stats = rearrange.NNIStats.init(nj)
            reset_launches()
            t = time.perf_counter()
            res = ml_round.ml_nni_round(nj, 0, 2, stats) if how == "kernel" \
                else rearrange.do_nni(nj, 0, 2, True, stats)
            torch.cuda.synchronize()
            out[how] = (ml_state(nj, stats, res), nj, time.perf_counter() - t)
            if how == "kernel" and ml_round.ml_nni_round.cons_launches != 1:
                raise AssertionError(f"{name}: the constrained kernel did not "
                                     "run the round")
        what = ml_diff(out["host loop"][0], out["kernel"][0])
        what += [cons_diff(ml_start_, out["kernel"][1])] \
            if cons_diff(ml_start_, out["kernel"][1]) else []
        if what:
            raise AssertionError(f"{name} [{label}] under constraints: {what} "
                                 "differ from the host loop's (or the counts "
                                 "changed)")
        sc_pass = ml_round.sh_pass(cons_copy(out["kernel"][1], dev, True))
        sc_loop = ml.test_splits_ml(cons_copy(out["kernel"][1], dev, True))
        if sc_pass != sc_loop:
            raise AssertionError(f"the SH pass under constraints: {sc_pass}, "
                                 f"the host loop {sc_loop}")

        def one():
            nj = cons_copy(ml_start_, dev, ml_store=True)
            ml_round.ml_nni_round(nj, 0, 2, rearrange.NNIStats.init(nj))

        us = device_us(one, [CONS_KERNELS["ml_nni_round"]], runs=3)
        entry(name).update(cons_device_us=us, cons_ms=1e3 * out["kernel"][2])
        print(f"  {name} [{label}, {CONS_COLS} constraints]: bit for bit the "
              f"host loop's (tree, lengths, NNIStats, criteria's deltas and "
              f"supports, counters, rows; counts unchanged); "
              f"{out['kernel'][2]:.3f} s (the host loop "
              f"{out['host loop'][2]:.3f} s), device {us / 1e3:.3f} ms; the SH "
              f"pass's SplitCount is the host loop's: "
              f"{dataclasses.asdict(sc_pass)}")

    from veryfasttree_tpu_torch.options import ml_options, noml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    def run(n, opts):
        out, log = io.StringIO(), io.StringIO()
        reset_launches()
        t = time.perf_counter()
        nj, sc = run_pipeline(opts, io.StringIO(fasta_text(synth_codes(
            n, MAIN_P))), out, log_fp=log, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        cons = {k: wrappers()[k].cons_launches for k in CONS_KERNELS}
        final = FINAL.findall(log.getvalue())
        return out.getvalue(), nj, sc, wall, cons, \
            float(final[-1]) if final else None

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the JAX package's trees
        with open(CONS_GOLDEN + ".nwk") as f:
            golden = f.read()
        nw, nj, sc, wall, cons, _ = run(500, noml_options(
            constraints_file=cons_write(500, MAIN_P, tmp)))
        if nw != golden:
            raise AssertionError(f"-nt -noml -constraints N=500: RF "
                                 f"{rf_distance(nw, golden)[0]} to the JAX "
                                 "golden, not byte-identical")
        print(f"  -nt -noml -constraints N=500: byte-identical to the JAX "
              f"golden, {wall:.2f} s, constrained launches {cons}")
        with open(CONS_ML_GOLDEN + ".nwk") as f:
            golden = f.read()
        with open(CONS_ML_GOLDEN + ".json") as f:
            meta = json.load(f)
        nw, nj, sc, wall, cons, final = run(ML_GOLDEN_N, ml_options(
            constraints_file=cons_write(ML_GOLDEN_N, MAIN_P, tmp)))
        rf, n_splits = rf_distance(nw, golden)
        rel = abs(final - meta["final_loglk"]) / abs(meta["final_loglk"])
        print(f"  -nt -constraints N={ML_GOLDEN_N}: {wall:.2f} s, RF "
              f"{rf}/{n_splits} to the JAX golden, final LogLk {final:.3f} "
              f"(golden {meta['final_loglk']:.3f}, rel diff {rel:.2e}); "
              f"SplitCount {dataclasses.asdict(sc)} (golden "
              f"{meta['split_count']}); constrained launches {cons}")
        if rf != 0 or not rel <= 1e-4:
            raise AssertionError(f"-nt -constraints N={ML_GOLDEN_N}: RF {rf}, "
                                 f"final LogLk rel diff {rel:.2e}")

        # (c) full width, warm
        path = cons_write(MAIN_N, MAIN_P, tmp)
        for key, opts in (("noml", noml_options(constraints_file=path)),
                          ("ml", ml_options(constraints_file=path))):
            nw, nj, sc, wall, cons, final = run(MAIN_N, opts)
            _, leaves = newick_splits(nw)
            want = ("nj_join_epoch", "me_nni_round", "me_spr_round") + (
                ("ml_nni_round",) if key == "ml" else ())
            missing = [k for k in want if not cons[k]]
            if len(leaves) != MAIN_N or missing or sc.n_splits != MAIN_N - 3 \
                    or (final is not None and not math.isfinite(final)):
                raise AssertionError(
                    f"-nt{' -noml' * (key == 'noml')} -constraints N={MAIN_N}"
                    f": {len(leaves)} leaves, {sc.n_splits} splits, final "
                    f"LogLk {final}, constrained kernels not launched "
                    f"{missing}")
            for k in want:
                entry(k)[f"cons_launches_{key}"] = cons[k]
            free_wall, free_t = MAIN_RUNS.get(key, (None, {}))
            timings = {k: round(v, 4) for k, v in nj.timings.items()}
            print(f"  -nt{' -noml' * (key == 'noml')} -constraints N={MAIN_N}"
                  f" P={MAIN_P}, warm: wall {wall:.2f} s (unconstrained "
                  f"{free_wall if free_wall is None else round(free_wall, 2)}"
                  f" s); timings {timings}; unconstrained "
                  f"{ {k: round(v, 4) for k, v in free_t.items()} }; "
                  f"SplitCount {dataclasses.asdict(sc)}"
                  f"{'' if final is None else f'; final LogLk {final:.3f}'}; "
                  f"constrained launches {cons}")



# ------------------------------------------------------------- phase 9
THREADS = 8                     # the JAX package's accelerator default
THREADS_GOLDEN = os.path.join(REPO, "tests", "data",
                              "torch_port_threads_golden_n500_p500")
THREADS_ML_GOLDEN = os.path.join(REPO, "tests", "data",
                                 "torch_port_threads_ml_golden_n200_p500")
# the kernels both -threads runs launch, those the default run adds, and
# the serial tier's round kernels, which neither may launch
THREADS_PATH = ("me_dists_list", "me_average_sweep", "nj_join_epoch")
THREADS_ML_PATH = ("ml_quartet_opt", "ml_opt_branch", "ml_posterior")
SERIAL_ROUNDS = ("me_nni_round", "me_spr_round", "ml_nni_round",
                 "ml_lengths_pass")
# the ME rounds' deltas and supports on the card against the twins': sums
# of log-corrected distances that the kernels and the twins add in their
# own orders (me_dists_list against its twin within 1e-12, phase 2)
THREADS_DELTA_ATOL = 1e-9
# the ML functions on the card against the twins (4 codes; ROADMAP Queue 3):
# each quartet's criteria, and each length within 1e-4 + 2e-3 x length
THREADS_CRIT_TOL = 2e-2
# the tree LogLk after the card's lengths pass and ML NNI round against
# the twins', relative: about 7 and 3.5 times the largest read on the H100
# (1.38e-8, 2.87e-7).  A pass with one sweep a level instead of two lies
# 1.5e-4 from the whole pass at this start (on the CPU; PERF.md, section
# 6).  A round with a flip on a near tie is held to ML_TWIN_RTOL
THREADS_PASS_RTOL = 1e-7
THREADS_ROUND_RTOL = 1e-6
# (c)'s runs: the default run and the -noml run, both at N=500.  A -noml
# run at N=MAIN_N took the whole smoke to 1025 s of its 1200 s, and the
# default run at N=MAIN_N (38.8-43.7 s) left phase 11 too little room
# (PERF.md, section 6)
THREADS_MAIN = ((True, 500), (False, 500))


def length_gap(a, b):
    """The largest |a - b| over 1e-4 + 2e-3 |b| of two length arrays: at
    most 1 within the tolerance."""
    import numpy as np

    return float(np.max(np.abs(a - b) / (1e-4 + 2e-3 * np.abs(b))))


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def side_me_nni(start, dev):
    """One batched ME NNI round on a copy of start on dev: (nni_state,
    wall, launches)."""
    from veryfasttree_tpu_torch.engine import batched, rearrange

    nj = engine_copy(start, dev)
    stats = rearrange.NNIStats.init(nj)
    reset_launches()
    t = time.perf_counter()
    res = batched.do_nni_batched(nj, 0, 2, False, stats)
    sync(dev)
    return nni_state(nj, stats, res), time.perf_counter() - t, \
        {k: v for k, v in launch_counts().items() if v}


def side_spr(start, dev, n_threads):
    """One partitioned SPR round at -threads n_threads on a copy of start
    on dev: (spr_state, wall, lockstep steps, launches)."""
    from veryfasttree_tpu_torch.engine import spr_batched

    nj = engine_copy(start, dev)
    nj.options = dataclasses.replace(start.options, threads=n_threads)
    reset_launches()
    steps = spr_batched.run_spr_batched.steps
    t = time.perf_counter()
    spr_batched.run_spr_batched(nj, 0, 2)
    sync(dev)
    return spr_state(nj), time.perf_counter() - t, \
        spr_batched.run_spr_batched.steps - steps, \
        {k: v for k, v in launch_counts().items() if v}


def side_lists(ml_nj, dev):
    """ml_posterior with bl= (the children of every internal node of two
    into the list-pass rows at their lengths) and ml_opt_branch with bl=
    (each first child's branch against that posterior) on a copy of ml_nj
    on dev:
    (the posteriors' W and V, the lengths after, the searches' f(x))."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    nj = ml_copy(ml_nj, dev)
    ml, kids, targets, lims = list_case(nj)
    bl = ml.lengths_tensor(nj.tree.branchlength[: nj.tree.maxnodes])
    mk.ml_posterior(*ml._store(), targets, kids[:, 0], kids[:, 1],
                    kids[:, 0], kids[:, 1], bl=bl, lo=float(ml.min_len))
    _, fx, _ = mk.ml_opt_branch(*ml._store(), kids[:, 0], targets,
                                kids[:, 0], *lims, bl=bl)
    return ({k: getattr(ml, k)[targets].cpu().numpy() for k in ("W", "V")},
            bl.cpu().numpy(), fx.cpu().numpy().astype(np.float64))


def list_case(nj):
    """(store, children [K, 2] of the internal nodes of two, K list-pass
    rows, the line searches' limits) of side_lists."""
    import numpy as np

    tree, ml, opts = nj.tree, nj.ml, nj.options
    nodes = np.array([n for n in range(nj.n_seqs, tree.maxnode)
                      if n != tree.root and tree.n_child[n] == 2])
    return ml, tree.children[nodes], ml.scratch_rows_for(len(nodes)), (
        opts.ml_min_branch_length, 6.0, opts.ml_ftol_branch_length,
        opts.ml_min_branch_length_tolerance)


def side_ml_lengths(ml_nj, dev):
    """One batched ML lengths pass on a copy of ml_nj on dev: (lengths,
    wall, launches, the tree LogLk after it)."""
    from veryfasttree_tpu_torch.engine import batched, ml

    nj = ml_copy(ml_nj, dev)
    reset_launches()
    t = time.perf_counter()
    batched.optimize_all_branch_lengths_batched(nj)
    wall = time.perf_counter() - t
    counts = {k: v for k, v in launch_counts().items() if v}
    nj.ml.recompute_ml_profiles()
    return nj.tree.branchlength.copy(), wall, counts, ml.tree_loglk(nj)


def side_ml_nni(ml_nj, dev):
    """One batched ML NNI round on a copy of ml_nj on dev: (the quartet
    list's rows, choices and criteria, the tree arrays and lengths, the
    ages, (n_nni, max_delta), wall, launches, the tree LogLk after it)."""
    from torch_thread_runs import Decisions

    from veryfasttree_tpu_torch.engine import batched, ml, rearrange
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles

    nj = ml_copy(ml_nj, dev)
    stats = rearrange.NNIStats.init(nj)
    reset_launches()
    t = time.perf_counter()
    with Decisions(MLProfiles) as rec:
        res = batched.do_nni_batched(nj, 0, 2, True, stats)
    wall = time.perf_counter() - t
    counts = {k: v for k, v in launch_counts().items() if v}
    tree = {k: getattr(nj.tree, k).copy()
            for k in ("parent", "children", "n_child", "branchlength")}
    return rec.log[0], tree, stats.age.copy(), res, wall, counts, \
        ml.tree_loglk(nj)


def side_split(ml_nj, dev):
    """The split test -threads > 1 takes (the SH pass, SH_BOOT resamples)
    on a copy of ml_nj on dev: (SplitCount, supports, launches)."""
    from veryfasttree_tpu_torch.ops import ml_round

    nj = ml_copy(ml_nj, dev)
    nj.options = dataclasses.replace(nj.options, n_bootstrap=SH_BOOT,
                                     threads=THREADS)
    reset_launches()
    sc = ml_round.sh_pass(nj)
    return sc, nj.tree.support.copy(), \
        {k: v for k, v in launch_counts().items() if v}


THREADS_SIDES = ("me_nni", f"spr_{THREADS}", "spr_12", "lists", "ml_lengths",
                 "ml_nni", "split")


def threads_side(name, start, ml_nj, dev):
    """The side_* function of phase 9(a) called `name` (THREADS_SIDES), on
    dev."""
    if name == "me_nni":
        return side_me_nni(start, dev)
    if name.startswith("spr_"):
        return side_spr(start, dev, int(name[len("spr_"):]))
    return {"lists": side_lists, "ml_lengths": side_ml_lengths,
            "ml_nni": side_ml_nni, "split": side_split}[name](ml_nj, dev)


def threads_start(dev):
    """Phase 9(a)'s start on dev: the N=SPR_N NJ tree and ME store, and a
    copy of it with the ME lengths and a Jukes-Cantor ML store."""
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles

    start = spr_start(SPR_N, dev)
    ml_nj = engine_copy(start, dev)
    rearrange.update_branch_lengths(ml_nj)
    ml_nj.ml = MLProfiles(ml_nj, None)
    ml_nj.ml.recompute_ml_profiles()
    return start, ml_nj


def start_threads_twins(starts, tmp):
    """The twins of phase 9(a): CPU copies of the card's start in
    tmp/start.pkl, and one process a side (chip_smoke.py --twins tmp name,
    on the CPU only, one thread each), started once the card's sides have
    run, so that no timed phase runs beside them: returns the processes by
    name."""
    import pickle

    import torch

    cpu = torch.device("cpu")
    start, ml_nj = starts
    with open(os.path.join(tmp, "start.pkl"), "wb") as f:
        pickle.dump((engine_copy(start, cpu), ml_copy(ml_nj, cpu)), f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = {}
    for name in THREADS_SIDES:
        with open(os.path.join(tmp, f"twin_{name}.log"), "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--twins", tmp,
                 name], env=env, cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT)
    return procs


def twins_main(tmp, name) -> int:
    """chip_smoke.py --twins tmp name: the side `name` on the CPU from
    tmp/start.pkl, with its seconds, into tmp/twin_{name}.pkl."""
    import pickle

    import torch

    for sub in ("", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    torch.set_num_threads(1)       # the host loops' tiny ops only contend
    with open(os.path.join(tmp, "start.pkl"), "rb") as f:
        start, ml_nj = pickle.load(f)
    t = time.perf_counter()
    side = threads_side(name, start, ml_nj, torch.device("cpu"))
    with open(os.path.join(tmp, f"twin_{name}.pkl"), "wb") as f:
        pickle.dump((side, time.perf_counter() - t), f)
    return 0


def wait_twins(procs, tmp):
    """The twins' sides by name once every process has ended, and their
    seconds by name."""
    import pickle

    twin, seconds = {}, {}
    for name, proc in procs.items():
        proc.wait(timeout=600)
        if proc.returncode != 0:
            with open(os.path.join(tmp, f"twin_{name}.log")) as f:
                raise AssertionError(f"the twin {name} exited "
                                     f"{proc.returncode}:\n"
                                     f"{f.read()[-3000:]}")
        with open(os.path.join(tmp, f"twin_{name}.pkl"), "rb") as f:
            twin[name], seconds[name] = pickle.load(f)
    return twin, seconds


def threads_twins(report, ml_nj, card, twin, dev):
    """(a): the batched functions' results on the card (card, from the
    start whose ML copy is ml_nj) against the twins' (twin), by name."""
    import numpy as np

    state, wall, counts = card["me_nni"]
    what, _, gap = nni_diff(twin["me_nni"][0], state)
    print(f"  ME NNI round [N={SPR_N}]: {state[1]['n_nni_round']} NNIs; the "
          f"twins' tree, rows, NNIStats ages and counters "
          f"{'equal' if what is None else what}, deltas and supports within "
          f"{gap:.3e}; {wall:.3f} s on the card (twins "
          f"{twin['me_nni'][1]:.3f} s), launches {counts}")
    if what is not None or gap > THREADS_DELTA_ATOL \
            or counts != {"me_average_sweep": 2, "me_dists_list": 1}:
        raise AssertionError(f"do_nni_batched: {what} differ from the twins'"
                             f" (deltas within {gap:.3e}), launches {counts}")
    for n_threads in (THREADS, 12):
        key = f"spr_{n_threads}"
        state, wall, steps, counts = card[key]
        what, _ = spr_diff(twin[key][0], state)
        print(f"  SPR round -threads {n_threads} [N={SPR_N}]: "
              f"{state[1]['n_spr']} SPR moves in {steps} lockstep steps "
              f"(twins {twin[key][2]}); the twins' tree, rows and counters "
              f"{'equal' if what is None else what}; {wall:.3f} s on the "
              f"card (twins {twin[key][1]:.3f} s), launches {counts}")
        if what is not None or steps != twin[key][2] \
                or counts.get("me_dists_list") != steps:
            raise AssertionError(f"run_spr_batched -threads {n_threads}: "
                                 f"{what} differ from the twins' (or "
                                 f"{counts} for {steps} steps)")
        report.setdefault("me_dists_list", {})[f"threads_{n_threads}_spr"] = \
            {"steps": steps, "wall_s": wall}

    # the device-length lists: bit for bit the host-length lists on the
    # card, and against the twins
    (rows, bl, fx), (rows_t, bl_t, fx_t) = card["lists"], twin["lists"]
    same = device_lists_same(ml_nj, dev, rows, bl)
    row_err = float(np.max(np.abs(rows["V"] - rows_t["V"])))
    fx_err = float(np.max(np.abs(fx - fx_t)))
    print(f"  ml_posterior, ml_opt_branch with bl= [{len(fx)} items]: bit for "
          f"bit the host-length lists {same}; against the twins: rows within "
          f"{row_err:.2e}, -LogLk at the optimum within {fx_err:.2e}, lengths "
          f"within {length_gap(bl, bl_t):.3f} of the tolerance")
    np.testing.assert_allclose(rows["V"], rows_t["V"], **TWIN_ROWS,
                               err_msg="ml_posterior with bl= against its twin")
    if not same or fx_err > ML_TWIN_NEAR_TIE:
        raise AssertionError("the device-length lists differ from the "
                             "host-length lists, or their searches' optima "
                             "from the twins'")

    lengths, wall, counts, loglk = card["ml_lengths"]
    rel = abs(loglk - twin["ml_lengths"][3]) / abs(twin["ml_lengths"][3])
    print(f"  ML lengths pass [N={SPR_N}]: tree LogLk {loglk:.4f} (twins "
          f"{twin['ml_lengths'][3]:.4f}, rel diff {rel:.2e}); "
          f"{lengths_report(lengths, twin['ml_lengths'][0])}; {wall:.3f} s "
          f"on the card (twins {twin['ml_lengths'][1]:.3f} s), launches "
          f"{counts}")
    if rel > THREADS_PASS_RTOL:
        raise AssertionError(f"the batched lengths pass: tree LogLk rel diff "
                             f"{rel:.2e} from the twins' (limit "
                             f"{THREADS_PASS_RTOL:.0e})")
    report.setdefault("ml_opt_branch", {})["threads_pass_launches"] = \
        counts.get("ml_opt_branch", 0)

    (rows_c, ch_c, cr_c), tree_c, age_c, res_c, wall, counts, loglk = \
        card["ml_nni"]
    (rows_t, ch_t, cr_t), tree_t, age_t, res_t = twin["ml_nni"][:4]
    if not np.array_equal(rows_c, rows_t):
        raise AssertionError("the ML NNI round's quartets differ")
    err = float(np.max(np.abs(cr_c - cr_t)))
    flips = [(int(k), [round(float(abs(c[k, ch_c[k]] - c[k, ch_t[k]])), 6)
                       for c in (cr_c, cr_t)])
             for k in np.flatnonzero(ch_c != ch_t)]
    print(f"  ML NNI round [N={SPR_N}]: {res_c[0]} NNIs of {len(rows_c)} "
          f"quartets (twins {res_t[0]}); criteria within {err:.3e} of the "
          f"twins'; flips with their margins {flips}; {wall:.3f} s on the "
          f"card (twins {twin['ml_nni'][4]:.3f} s), launches {counts}")
    if err > THREADS_CRIT_TOL or any(max(m) > ML_TWIN_NEAR_TIE
                                     for _, m in flips):
        raise AssertionError(f"the batched ML NNI round: criteria within "
                             f"{err:.3e}, flips {flips}")
    same = all(np.array_equal(tree_c[k], tree_t[k])
               for k in ("parent", "children", "n_child")) \
        and np.array_equal(age_c, age_t) and res_c[0] == res_t[0]
    rel = abs(loglk - twin["ml_nni"][6]) / abs(twin["ml_nni"][6])
    # a flip on a near tie moves one NNI, and the conflicts it decides
    limit = ML_TWIN_RTOL if flips else THREADS_ROUND_RTOL
    print(f"  ML NNI round: the twins' tree, ages and NNIs equal {same}; "
          f"tree LogLk {loglk:.4f} (twins {twin['ml_nni'][6]:.4f}, rel diff "
          f"{rel:.2e}, limit {limit:.0e}); "
          f"{lengths_report(tree_c['branchlength'], tree_t['branchlength'])}")
    if (not same and not flips) or rel > limit:
        raise AssertionError(f"the batched ML NNI round differs from the "
                             f"twins' (tree alike {same}, flips {flips}, "
                             f"tree LogLk rel diff {rel:.2e})")
    report.setdefault("ml_quartet_opt", {})["threads_round_launches"] = \
        counts.get("ml_quartet_opt", 0)

    (sc_c, sup_c, counts), (sc_t, sup_t, _) = card["split"], twin["split"]
    worst = abs(sc_c.d_worst_delta_unconstrained
                - sc_t.d_worst_delta_unconstrained)
    print(f"  ML split test [N={SPR_N}, the SH pass]: SplitCount {sc_c} "
          f"(twins {sc_t}); supports within "
          f"{float(np.max(np.abs(sup_c - sup_t))):.3f}; launches {counts}")
    if (sc_c.n_splits, sc_c.n_bad_splits) != (sc_t.n_splits,
                                              sc_t.n_bad_splits) \
            or worst > THREADS_CRIT_TOL:
        raise AssertionError(f"the ML split test: {sc_c}, twins {sc_t}")


def lengths_report(a, b):
    """Two runs' lengths against 1e-4 + 2e-3 x length: each float32 line
    search stops at its own point of a flat bottom and a pass carries
    each length into the next search (phase 2e), so they are reported,
    and the tree LogLk is held."""
    import numpy as np

    gap = np.abs(a - b) / (1e-4 + 2e-3 * np.abs(b))
    k = int(np.argmax(gap))
    return (f"lengths within {gap[k]:.3f} of 1e-4 + 2e-3 x length, "
            f"{int((gap > 1).sum())} of {len(gap)} past it (the furthest "
            f"{a[k]:.6f} against {b[k]:.6f})")


def device_lists_same(ml_nj, dev, rows, bl):
    """Whether side_lists' rows and lengths on the card are bit for bit
    those of ml_posterior and ml_opt_branch fed the same lengths from the
    host."""
    import numpy as np

    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    nj = ml_copy(ml_nj, dev)
    ml, kids, targets, lims = list_case(nj)
    lens = nj.tree.branchlength[: nj.tree.maxnodes].astype(np.float32)
    lo = np.float32(ml.min_len)
    mk.ml_posterior(*ml._store(), targets, kids[:, 0], kids[:, 1],
                    np.maximum(lens[kids[:, 0]], lo),
                    np.maximum(lens[kids[:, 1]], lo))
    x, _, _ = mk.ml_opt_branch(*ml._store(), kids[:, 0], targets,
                               np.maximum(lens[kids[:, 0]],
                                          np.float32(lims[0])), *lims)
    want = lens.copy()
    want[kids[:, 0]] = x.cpu().numpy()
    return want.tobytes() == bl.tobytes() and all(
        getattr(ml, k)[targets].cpu().numpy().tobytes() == rows[k].tobytes()
        for k in ("W", "V"))


def threads_run(n, dev, ml_run, **overrides):
    """One -threads run on synth_codes(n, MAIN_P) through run_pipeline, the
    launch counts reset just before it: (newick, nj, wall, counts, final
    LogLk or None, the SPR round's lockstep steps)."""
    from veryfasttree_tpu_torch.engine import spr_batched

    fasta = fasta_text(synth_codes(n, MAIN_P))
    steps = spr_batched.run_spr_batched.steps
    if ml_run:
        nw, nj, wall, counts, _, final = run_ml(fasta, dev, threads=THREADS,
                                                **overrides)
    else:
        nw, nj, wall, counts = counted_run(fasta, dev, threads=THREADS,
                                           **overrides)
        final = None
    return nw, nj, wall, counts, final, \
        spr_batched.run_spr_batched.steps - steps


def launch_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def threads_golden(dev):
    """(b): -nt -noml -threads 8 at N=500 byte-identical to the JAX
    package's tree, and the default -nt -threads 8 run at N=200: RF 0, or
    where the trees part, at a decision of the batched ML NNI rounds that
    is a near tie in both packages (its two LogLks within
    ML_TWIN_NEAR_TIE; the JAX package's decisions, _decisions.json), the
    decisions before it alike, printed with its margins and the criteria's
    largest differences before it (each quartet's LogLks of about 1,000 at
    P=500 carry the JAX package's float32 search noise, 0.034 read for a
    topology 27 units worse than the chosen one); the final LogLk within
    1e-4 relative."""
    import numpy as np
    from torch_thread_runs import Decisions
    from util import rf_distance

    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles

    with open(THREADS_GOLDEN + ".nwk") as f:
        golden = f.read()
    nw, nj, wall, counts, _, steps = threads_run(500, dev, False,
                                                 n_bootstrap=1000)
    print(f"  -nt -noml -threads {THREADS} N=500: byte-identical to the JAX "
          f"golden {nw == golden}, {wall:.2f} s, {steps} lockstep SPR steps")
    if nw != golden:
        raise AssertionError(f"-nt -noml -threads {THREADS} N=500: RF "
                             f"{rf_distance(nw, golden)[0]} to the JAX golden"
                             ", not byte-identical")
    with open(THREADS_ML_GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(THREADS_ML_GOLDEN + ".json") as f:
        meta = json.load(f)
    with open(THREADS_ML_GOLDEN + "_decisions.json") as f:
        theirs = [(tuple(rows), choice, np.array(crit, dtype=np.float64))
                  for rows, choice, crit in json.load(f)]
    with Decisions(MLProfiles) as rec:
        nw, nj, wall, counts, final, steps = threads_run(ML_GOLDEN_N, dev,
                                                         True)
    ours = rec.quartets()
    rf, n_splits = rf_distance(nw, golden)
    rel = abs(final - meta["final_loglk"]) / abs(meta["final_loglk"])
    label = f"-nt -threads {THREADS} N={ML_GOLDEN_N}"
    flip, err, dec = first_flip(f"{label} against the JAX package", theirs,
                                ours, ML_TWIN_NEAR_TIE)
    parting = "no decision parts" if flip is None else (
        f"they part at decision {flip} of {len(theirs)}, a near tie: "
        f"margins {[round(abs(c[theirs[flip][1]] - c[ours[flip][1]]), 6) for c in (theirs[flip][2], ours[flip][2])]}"
        f" (the golden's, the card's)")
    print(f"  {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX golden, "
          f"final LogLk {final:.3f} (golden {meta['final_loglk']:.3f}, rel "
          f"diff {rel:.2e}); {len(ours)} batched quartet decisions (golden "
          f"{len(theirs)}), criteria within {err:.3e}, deciding differences "
          f"within {dec:.3e} up to where {parting}")
    if not rel <= 1e-4 or (rf != 0 and flip is None):
        raise AssertionError(f"{label}: RF {rf}, final LogLk rel diff "
                             f"{rel:.2e}, decisions part at {flip}")


def threads_main(report, dev, sizes):
    """(c): the -threads runs of sizes ((ML run, N), ...), warm, the launch
    counts reset just before each and read just after it."""
    from util import newick_splits

    for ml_run, n in sizes:
        key = "ml" if ml_run else "noml"
        label = f"-nt{' -noml' * (not ml_run)} -threads {THREADS} N={n}"
        nw, nj, wall, counts, final, steps = threads_run(n, dev, ml_run)
        _, leaves = newick_splits(nw)
        want = THREADS_PATH + (THREADS_ML_PATH if ml_run else ())
        missing = [k for k in want if not counts[k]]
        serial = {k: counts[k] for k in SERIAL_ROUNDS if counts[k]}
        scans = require_scans(label)
        sha = hashlib.sha256(nw.encode()).hexdigest()
        serial_wall, serial_t = MAIN_RUNS.get(key, (None, {})) \
            if n == MAIN_N else (None, {})
        timings = {k: round(v, 4) for k, v in nj.timings.items()}
        print(f"  {label} P={MAIN_P}, warm: wall {wall:.2f} s (serial tier "
              f"{serial_wall if serial_wall is None else round(serial_wall, 2)}"
              f" s); timings {timings}; serial tier "
              f"{ {k: round(v, 4) for k, v in serial_t.items()} }; "
              f"Newick SHA-256 {sha[:16]}..."
              f"{'' if final is None else f'; final LogLk {final:.3f}'}"
              f" (serial tier {ML_MAIN_LOGLK if ml_run else '-'}); "
              f"{steps} lockstep SPR steps, {scans} refresh scans; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if len(leaves) != n or missing or serial \
                or (final is not None and not math.isfinite(final)):
            raise AssertionError(f"{label}: {len(leaves)} leaves, final LogLk "
                                 f"{final}, not launched {missing}, serial "
                                 f"round kernels launched {serial}")
        for k, v in counts.items():
            if v:
                report.setdefault(k, {})[f"threads_launches_{key}"] = v
        report.setdefault("me_dists_list", {})[f"threads_{key}"] = {
            "n": n, "wall_s": wall, "spr_steps": steps, "timings": timings}


def phase_threads(report, dev, tmp):
    """-threads > 1 (the batched tier): (a) each batched function on the
    card from one N=SPR_N start, then against its twins, which run on the
    CPU in processes of their own (start_threads_twins, working in tmp)
    beside (b), the JAX package's -threads 8 goldens, whose walls are
    then taken beside them; (c) the N=MAIN_N runs, warm, once the twins
    have ended."""
    starts = threads_start(dev)
    card = {name: threads_side(name, *starts, dev) for name in THREADS_SIDES}
    procs = start_threads_twins(starts, tmp)
    try:
        threads_golden(dev)
        twin, seconds = wait_twins(procs, tmp)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"  (b)'s walls were taken beside the twins, which ran in "
          f"{len(procs)} CPU processes of one thread: "
          f"{ {k: round(v, 1) for k, v in seconds.items()} } s")
    threads_twins(report, starts[1], card, twin, dev)
    threads_main(report, dev, THREADS_MAIN)


# ------------------------------------------------------------- phase 10
FASTEST_MODES = {"fastest": {"fastest": True},
                 "2nd": {"use_tophits_2nd": True}}
# the JAX package's -nt -noml -nosupport trees of each mode at N=500
# (scripts/make_torch_port_fastest_golden.py)
FASTEST_GOLDEN = os.path.join(REPO, "tests", "data",
                              "torch_port_{}_golden_n500_p500")
# phase 10(c)'s traced run: the default -nt run at N=TRACE_N (its trace
# records every host operation, tens of thousands at this size)
TRACE_N = 60
# the whole-tree kernels, as torch.profiler names them, whose launches
# phase 10(c) looks for in a VFT_TRACE trace
TRACE_KERNELS = ("nj_epoch_kernel", "me_spr_round_kernel",
                 "me_average_sweep_kernel", "me_pair_list_kernel",
                 "ml_nni_round_kernel", "ml_lengths_pass_kernel",
                 "ml_posterior_sweep_kernel", "ml_tree_loglk_kernel")


class Interrupted(Exception):
    """Raised after a chosen checkpoint save (phase 10(a))."""


def phase_checkpoint(tmp, dev):
    """10(a): the default -nt run at N=MAIN_N with -checkpoint, stopped
    just after round 3's save, then resumed in a fresh run_pipeline and
    through the command line from a copy of that file: both the
    uninterrupted run's Newick SHA-256, final LogLk and ML-NNIs from round
    4 on (phase 6's).  Prints each save's fetch and write time and bytes,
    and one compressed save's (np.savez_compressed, as the JAX package
    writes) of the last state beside them."""
    import numpy as np

    from veryfasttree_tpu_torch.engine import checkpoint

    fasta = fasta_text(synth_codes(MAIN_N, MAIN_P))
    path = os.path.join(tmp, "main.npz")
    save = checkpoint.save_checkpoint
    saves = []

    def save_then_stop(nj, p, meta, extra=None):
        saves.append(save(nj, p, meta, extra))
        if meta["round"] == 3:
            raise Interrupted()
        return saves[-1]

    checkpoint.save_checkpoint = save_then_stop
    t0 = time.perf_counter()
    try:
        run_ml(fasta, dev, checkpoint_file=path)
        raise AssertionError("the run was not stopped after round 3")
    except Interrupted:
        wall_a = time.perf_counter() - t0
    finally:
        checkpoint.save_checkpoint = save
    shutil.copy(path, path + ".cli")
    logs = []
    nw, nj, wall_b, _, rounds, final = run_ml(
        fasta, dev, logs, checkpoint_file=path)
    saves += nj.checkpoint_saves
    for k, s in enumerate(saves):
        print(f"  save after ML-NNI round {k + 1}: fetch {s['fetch_s']:.4f} "
              f"s, write {s['write_s']:.4f} s, {s['bytes']} bytes")
    zpath = os.path.join(tmp, "compressed.npz")
    t0 = time.perf_counter()
    with open(zpath, "wb") as f:
        np.savez_compressed(f, **checkpoint.state_arrays(nj, {}))
    print(f"  the last state compressed (np.savez_compressed): "
          f"{time.perf_counter() - t0:.4f} s, fetch and write, "
          f"{os.path.getsize(zpath)} bytes")
    sha = hashlib.sha256(nw.encode()).hexdigest()
    nnis = [r[1] for r in rounds]
    print(f"  stopped after round 3 in {wall_a:.2f} s, resumed in "
          f"{wall_b:.2f} s ({nj.timings['ckpt_s']:.3f} s of it saving): "
          f"final LogLk {final:.3f}, ML-NNIs of rounds 4 on {nnis}, Newick "
          f"SHA-256 {sha[:16]}... (phase 6: {ML_MAIN_LOGLK}, "
          f"{ML_MAIN_NNIS[3:]}, {ML_MAIN_SHA}...)")
    if "Resuming ML-NNI at round 4" not in logs[0]:
        raise AssertionError("the second run did not resume at round 4")
    if f"{final:.3f}" != ML_MAIN_LOGLK or not sha.startswith(ML_MAIN_SHA) \
            or nnis != ML_MAIN_NNIS[3:]:
        raise AssertionError("the resumed run is not the uninterrupted one")
    # the command line, from the round-3 file, in a process of its own
    fpath = os.path.join(tmp, "main.fasta")
    with open(fpath, "w") as f:
        f.write(fasta)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-threads",
         "1", "-quiet", "-checkpoint", path + ".cli", fpath], cwd=REPO,
        capture_output=True, text=True, timeout=600, check=False)
    sha_cli = hashlib.sha256(res.stdout.encode()).hexdigest()
    print(f"  command line -checkpoint (round 3's file): exit "
          f"{res.returncode} in {time.perf_counter() - t0:.2f} s, Newick "
          f"SHA-256 {sha_cli[:16]}...")
    if res.returncode != 0 or sha_cli != sha:
        raise AssertionError(f"command line: exit {res.returncode}\n"
                             f"{res.stderr[-2000:]}")


def join_step_bound(cap):
    """(bytes, operations) of one join step at its captured inputs: rows i
    and j, the candidates and prefetch rows read once (float rows or, below
    leaf_rows, codes), the out-profile read and written, the new row, the
    staged inputs and the packed result written; the distances' 2(C+1)
    operations a position each, the average's and update's 4C+6 and 3C+6."""
    codes, W, U = cap["args"][:3]
    P, C = W.shape[1], U.shape[2]
    lo = cap["args"][6]
    i, j, t = cap["args"][13]
    cand, pref = cap["args"][14], cap["args"][15]
    rows = set(int(x) for x in (i, j, *cand, *pref))
    row_bytes = sum(P if r < lo else P * (4 * C + 5) for r in rows)
    n_out = len(cand) * 4 + len(pref) * 2 + 14
    n_bytes = (row_bytes + P * (4 * C + 5) + 2 * 4 * P * (C + 1)
               + 8 * (15 + n_out) + 4 * len(rows))
    pairs = 5 + 2 * len(cand) + len(pref)
    return n_bytes, P * (2 * (C + 1) * pairs + (4 * C + 6) + (3 * C + 6))


def check_join_step(report, cap):
    """nj_join_step against its twin on one captured join of the -fastest
    N=MAIN_N run: the packed result within TOL (float64 sums in other
    orders), the new row and the out-profile bit for bit; then timed."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.ops import join_kernels

    def fresh():
        return [a.clone() if torch.is_tensor(a) else a for a in cap["args"]]

    k_args, t_args = fresh(), fresh()
    got = join_kernels.nj_join_step(*k_args)
    torch.cuda.synchronize()
    exp = join_kernels.nj_join_step_ref(*t_args)
    g, e = got.cpu().numpy(), exp.cpu().numpy()
    np.testing.assert_allclose(g, e, err_msg="nj_join_step", **TOL)
    err = float(np.max(np.abs(g - e)))
    t, lo = cap["args"][13][2], cap["args"][6]
    same = {"codes": torch.equal(k_args[0][t], t_args[0][t]),
            "W": torch.equal(k_args[1][t - lo], t_args[1][t - lo]),
            "U": torch.equal(k_args[2][t - lo], t_args[2][t - lo]),
            "w_out": torch.equal(k_args[7], t_args[7]),
            "f_out": torch.equal(k_args[8], t_args[8])}
    if not all(same.values()):
        raise AssertionError(f"nj_join_step: the new row or out-profile "
                             f"differs from the twin's: {same}")
    n_bytes, n_ops = join_step_bound(cap)
    time_args, twin_args = fresh(), fresh()
    times = timing("nj_join_step",
                   lambda: join_kernels.nj_join_step(*time_args),
                   lambda: join_kernels.nj_join_step_ref(*twin_args),
                   n_bytes, n_ops, twin_runs=20)
    print(f"  nj_join_step at join {cap['call']} of the N={MAIN_N} -fastest "
          f"run ({len(cap['args'][14])} candidates, {len(cap['args'][15])} "
          f"prefetch rows, grid {join_kernels.nj_join_step.grid}): max abs "
          f"err {err:.3e} against the twin, the row and out-profile equal; "
          f"{times['device_us']:.2f} us on the device, {times['ms']:.4f} ms "
          f"launch to launch, twin {times['plain_ms']:.3f} ms, bound "
          f"{times['bound_ms']:.3e} ms ({times['bound_by']})")
    report.setdefault("nj_join_step", {}).update(max_abs_err=err, **times)


def fastest_run(fasta, dev, fused, capture=None, **overrides):
    """One -nt -noml -nosupport run with the fused join step on or off
    (USE_FUSED_JOIN), the launch counts set to 0 just before it and read
    just after it; capture: a dict that receives clones of the inputs of
    the first join step from call capture["at"] on with both candidates
    and prefetch rows."""
    import torch

    from veryfasttree_tpu_torch.engine import nj as nj_mod
    from veryfasttree_tpu_torch.ops import join_kernels

    step = join_kernels.nj_join_step
    calls = [0]

    def capturing(*args):
        calls[0] += 1
        if calls[0] >= capture["at"] and "args" not in capture \
                and len(args[14]) and len(args[15]):
            capture["args"] = [a.clone() if torch.is_tensor(a) else
                               (a.copy() if hasattr(a, "copy") else a)
                               for a in args]
            capture["call"] = calls[0]
        return step(*args)

    was = nj_mod.USE_FUSED_JOIN
    reset_launches()
    nj_mod.USE_FUSED_JOIN = fused
    if capture is not None:
        # the wrapper counts under its module name, which names this
        # function while it stands in
        capturing.launches, capturing.grid = step.launches, step.grid
        join_kernels.nj_join_step = capturing
    try:
        nw, nj, wall = run_port(fasta, dev, **overrides)
    finally:
        nj_mod.USE_FUSED_JOIN = was
        if capture is not None:
            step.launches, step.grid = capturing.launches, capturing.grid
            join_kernels.nj_join_step = step
    return nw, nj, wall, {name: fn.launches
                          for name, fn in wrappers().items()}


def phase_fastest(report, dev):
    """10(b): -nt -noml -fastest at N=MAIN_N with the unfused host loop
    (VFT_FUSED_JOIN=0's) and with the fused join step: the fused run
    launches nj_join_step and no join epoch, the two end states bit for bit
    alike; nj_join_step against its twin on a join of that run; then
    -fastest and -2nd at N=500 byte-identical to the JAX package's trees."""
    from veryfasttree_tpu_torch.engine import epoch

    fasta = fasta_text(synth_codes(MAIN_N, MAIN_P))
    states, cap = {}, {"at": MAIN_N // 2}
    for fused in (False, True):
        nw, nj, wall, counts = fastest_run(
            fasta, dev, fused, capture=cap if fused else None, fastest=True)
        t = nj.timings
        label = "fused" if fused else "unfused"
        joins = counts["nj_join_step"]
        print(f"  N={MAIN_N} -nt -noml -fastest, {label}: wall {wall:.2f} s; "
              f"NJ store {t['store_s']:.3f} s, top-hits {t['tophits_s']:.3f} "
              f"s, joins {t['joins_s']:.3f} s "
              f"({(MAIN_N - 3) / t['joins_s']:.1f} joins/s); ME NNI "
              f"{t['nni_s']:.3f} s, SPR {t['spr_s']:.3f} s; nj_join_step "
              f"{joins} launches, me_dists {counts['me_dists']}, me_average "
              f"{counts['me_average']}, nj_join_epoch "
              f"{counts['nj_join_epoch']}")
        # epoch_state's arrays after every phase: the join log, tree,
        # per-node arrays, store rows, out-profile, top-hits state, counters
        states[label] = (nw, epoch_state(nj))
        if counts["nj_join_epoch"] or (joins == 0) == fused \
                or epoch.epoch_supported(nj, nj._tophits):
            raise AssertionError(f"{label}: nj_join_step {joins} launches, "
                                 f"nj_join_epoch {counts['nj_join_epoch']}")
        if fused:
            report.setdefault("nj_join_step", {}).update(
                launches=joins, fastest_wall_s=wall,
                fastest_joins_s=t["joins_s"])
        else:
            report.setdefault("nj_join_step", {}).update(
                unfused_wall_s=wall, unfused_joins_s=t["joins_s"])
    diff = epoch_diff(states["unfused"][1], states["fused"][1])
    if diff or states["unfused"][0] != states["fused"][0]:
        raise AssertionError(f"fused against unfused: {diff} differ, Newick "
                             f"equal {states['unfused'][0] == states['fused'][0]}")
    print("  fused and unfused: the same Newick, and every array of the end "
          "state bit for bit")
    check_join_step(report, cap)

    with open(FASTEST_GOLDEN.format("fastest") + ".json") as f:
        meta = json.load(f)
    fasta = fasta_text(synth_codes(meta["n"], meta["p"], seed=meta["seed"]))
    for mode, fields in FASTEST_MODES.items():
        with open(FASTEST_GOLDEN.format(mode) + ".nwk") as f:
            golden = f.read()
        nw, nj, wall, counts = fastest_run(fasta, dev, True, **fields)
        print(f"  N={meta['n']} -nt -noml -{mode}: {wall:.2f} s, "
              f"byte-identical to the JAX golden {nw == golden}, "
              f"nj_join_step {counts['nj_join_step']} launches")
        if nw != golden or not counts["nj_join_step"]:
            raise AssertionError(f"-{mode}: differs from the JAX golden")


def phase_trace(report, dev, tmp):
    """10(c): VFT_TRACE on the default -nt run at N=TRACE_N: the trace
    file holds CUDA kernel events and the phases' annotations; which of the
    whole-tree kernels it shows, against their launches."""
    trace_dir = os.path.join(tmp, "trace")
    os.environ["VFT_TRACE"] = trace_dir
    try:
        _, _, wall, counts, _, _ = run_ml(
            fasta_text(synth_codes(TRACE_N, MAIN_P)), dev)
    finally:
        del os.environ["VFT_TRACE"]
    files = os.listdir(trace_dir)
    if len(files) != 1:
        raise AssertionError(f"VFT_TRACE wrote {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(e["name"] for e in events
                                  if e.get("cat") == "kernel")
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    shown = {k: sum(v for n, v in kernels.items() if k in n)
             for k in TRACE_KERNELS}
    size = os.path.getsize(path)
    os.remove(path)
    print(f"  VFT_TRACE: N={TRACE_N} default -nt run in {wall:.2f} s "
          f"traced, {size} bytes, {sum(kernels.values())} "
          f"CUDA kernel events of {len(kernels)} kernels; annotations "
          f"{sorted(notes)}; whole-tree kernels in the trace {shown}, "
          f"launched { {k: v for k, v in counts.items() if v} }")
    want = {"store", "tophits", "joins", "nni", "spr", "lengths",
            "ml_nni", "cat", "sh"}
    if not kernels or not want <= notes:
        raise AssertionError(f"the trace holds {len(kernels)} kernels, "
                             f"annotations {sorted(notes)}")


def phase_last_modules(report, dev, tmp):
    """Phase 10: -checkpoint, the fused join step and VFT_TRACE."""
    phase_checkpoint(tmp, dev)
    phase_fastest(report, dev)
    phase_trace(report, dev, tmp)


# ------------------------------------------------------------- phase 11
# the kernels of the mesh path (parallel/): the partial modes of the scans
# and of the pair kernels, and their finishes
MESH_KERNELS = ("nj_scan_dense_partial", "nj_scan_codes_partial",
                "nj_scan_finish", "me_dists_partial", "me_dists_list_partial",
                "me_pair_finish")
# the kernels a -noml mesh run launches (rank 0's counts), and those it
# must not: the whole-row kernels, which have no exchange
MESH_PATH = ("nj_scan_dense_partial", "nj_scan_finish", "me_dists_partial",
             "me_dists_list_partial", "me_pair_finish", "me_average_sweep")
MESH_NEVER = ("nj_scan_dense", "nj_scan_codes", "me_dists", "me_dists_list",
              "nj_join_epoch", "nj_join_step", "me_spr_round", "me_nni_round")
MESH_N = 500                    # the golden's input, synth_codes(500, 500)
MESH_BOOT = 1000                # -nt -noml's resamples
MESH_TIMEOUT_S = 240
# 11(b) runs its one-card comparison only when the smoke has run less than
# this (it takes 13-20 s; the smoke's limit is 1200 s)
MESH_SINGLE_BY_S = 1000
SMOKE_T0 = time.perf_counter()    # the smoke's start (module import)


def check_bits(label, got, exp):
    """Equal bits, tensor for tensor."""
    import torch

    for i, (g, e) in enumerate(zip(got, exp)):
        if not torch.equal(torch.as_tensor(g), torch.as_tensor(e)):
            raise AssertionError(f"{label}: output {i} not bit for bit")


def halves(t, axis, parts=2):
    import torch

    return [x.contiguous() for x in torch.tensor_split(t, parts, dim=axis)]


def phase_mesh_kernels(report):
    """11(a): the partial modes and the finishes against their twins at
    phase 2's shapes; at k = 1, partial then finish gives the fused
    kernels' (dist, denom, crit, best) bit for bit; over two blocks of
    positions the finish of the blocks' partials is the fused result within
    TOL.  Times at the main path's shapes (k = 2 for the finishes)."""
    import numpy as np
    import torch

    from veryfasttree_tpu_torch.ops import scan_kernels as sk
    from veryfasttree_tpu_torch.ops import store_kernels as st

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def record(name, label, err, times=None):
        entry = report.setdefault(name, {})
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), err)
        if times is not None and "ms" not in entry:
            entry.update(times)
        t = "" if times is None else (
            f", kernel {times['ms']:.4f} ms launch to launch, "
            f"{times['device_us']:.3f} us on the device, twin "
            f"{times['plain_ms']:.4f} ms, bound {times['bound_ms']:.3e} ms "
            f"({times['bound_by']})")
        print(f"  {name} [{label}]: max abs err {err:.3e}{t}")

    def close(label, got, exp):
        g, e = got.cpu().numpy(), exp.cpu().numpy()
        np.testing.assert_allclose(g, e, err_msg=label, **TOL)
        return float(np.max(np.abs(g - e))) if g.size else 0.0

    for C, use_matrix, label in ((4, False, "M=8192 P*C=2048 %different"),
                                 (20, True, "M=8192 P*C=10240 BLOSUM45")):
        U2, W, a, wq, outd, n_act, m_real, um = dense_case(C, use_matrix,
                                                           gen, dev)
        M = U2.shape[0]
        part = sk.nj_scan_dense_partial(U2, W, a, wq)
        err = close(f"dense partial {label}", part,
                    torch.stack(sk.nj_scan_dense_partial_ref(U2, W, a, wq)))
        fused = sk.nj_scan_dense(U2, W, a, wq, outd, n_act, m_real, um)
        one = sk.nj_scan_finish(part[None].contiguous(), outd, n_act,
                                m_real, um)
        torch.cuda.synchronize()
        check_bits(f"dense {label} k=1", one, fused)
        if int(one[0]) != BEST:
            raise AssertionError(f"dense {label}: best {int(one[0])}")
        # two blocks of positions (each a multiple of 4 of P and P*C)
        P = W.shape[1]
        blocks = [(U2.view(M, P, C)[:, p0:p0 + P // 2].reshape(M, -1)
                   .contiguous(), W[:, p0:p0 + P // 2].contiguous(),
                   a.view(P, C)[p0:p0 + P // 2].reshape(-1).contiguous(),
                   wq[p0:p0 + P // 2].contiguous()) for p0 in (0, P // 2)]
        parts = torch.stack([sk.nj_scan_dense_partial(*b) for b in blocks])
        two = sk.nj_scan_finish(parts, outd, n_act, m_real, um)
        two_ref = sk.nj_scan_finish_ref(parts, outd, n_act, m_real, um)
        if not int(two[0]) == int(two_ref[0]) == int(fused[0]) == BEST:
            raise AssertionError(
                f"dense {label} k=2: best {int(two[0])}, twin "
                f"{int(two_ref[0])}, fused {int(fused[0])}")
        # dist and denom bit for bit; the twin's crit divides by a Python
        # scalar, which PyTorch's CUDA division takes as a product with
        # its reciprocal (an ulp off)
        check_bits(f"finish {label} k=2 against its twin", two[2:4],
                   two_ref[2:4])
        for i in (1, 4):
            err = max(err, close(f"finish {label} k=2 twin", two[i],
                                 two_ref[i]))
        for g, e in zip(two[1:], fused[1:]):      # best_idx held above
            err = max(err, close(f"dense {label} k=2", g, e))
        n_bytes = U2.numel() * 4 + W.numel() * 4 + 8 * (a.numel() + wq.numel()
                                                        + 2 * M)
        record("nj_scan_dense_partial", label, err, timing(
            "nj_scan_dense_partial",
            lambda: sk.nj_scan_dense_partial(U2, W, a, wq),
            lambda: sk.nj_scan_dense_partial_ref(U2, W, a, wq), n_bytes,
            2 * (U2.numel() + W.numel())))
        record("nj_scan_finish", f"{label}, k=2", 0.0, timing(
            "nj_scan_finish",
            lambda: sk.nj_scan_finish(parts, outd, n_act, m_real, um),
            lambda: sk.nj_scan_finish_ref(parts, outd, n_act, m_real, um),
            8 * (parts.numel() + outd.numel() + 3 * M), 12 * M))

    for C, use_matrix, label in ((4, False, "L=20000 P=512 C=4 %different"),
                                 (20, True, "L=20000 P=512 C=20 BLOSUM45")):
        codes, G, wq, outd, n_act, l_real, um = codes_case(C, use_matrix,
                                                           gen, dev)
        part = sk.nj_scan_codes_partial(codes, G, wq)
        err = close(f"codes partial {label}", part,
                    torch.stack(sk.nj_scan_codes_partial_ref(codes, G, wq)))
        fused = sk.nj_scan_codes(codes, G, wq, outd, n_act, l_real, um)
        one = sk.nj_scan_finish(part[None].contiguous(), outd, n_act, l_real,
                                um)
        torch.cuda.synchronize()
        check_bits(f"codes {label} k=1", one, fused)
        L, P = codes.shape
        record("nj_scan_codes_partial", label, err, timing(
            "nj_scan_codes_partial",
            lambda: sk.nj_scan_codes_partial(codes, G, wq),
            lambda: sk.nj_scan_codes_partial_ref(codes, G, wq),
            codes.numel() + 8 * (G.numel() + wq.numel() + 2 * L),
            2 * codes.numel()))

    rng = np.random.default_rng(5)
    for C, use_matrix, leaf_rows, label in (
            (4, False, 0, "dense 8192x512 C=4"),
            (4, False, 2000, "two-tier 2000 leaves C=4"),
            (20, True, 0, "dense 8192x512 C=20 BLOSUM45")):
        codes, W, U, cf, ev, _ = store_case(C, use_matrix, leaf_rows, gen,
                                            dev)
        store = (codes, W, U, cf, ev, leaf_rows)
        n_rows, P = codes.shape
        q_rows = rng.choice(n_rows, 300, replace=False)
        quartet = rng.choice(n_rows, 4, replace=False)
        ii, jj = quartet[[0, 0, 0, 1, 1, 2]], quartet[[1, 2, 3, 2, 3, 3]]
        q = (U[300], W[300])
        part = st.me_dists_partial(*store, q_rows, *q, ii, jj)
        err = close(f"me_dists_partial {label}", part,
                    st.me_dists_partial_ref(*store, q_rows, *q, ii, jj))
        check_bits(f"me_dists {label} k=1",
                   [st.me_pair_finish(part[None].contiguous(), use_matrix)],
                   [st.me_dists(*store, q_rows, *q, ii, jj)])
        iis = rng.integers(0, n_rows, 11982)
        jjs = rng.integers(0, n_rows, 11982)
        lpart = st.me_dists_list_partial(*store, iis, jjs)
        lerr = close(f"me_dists_list_partial {label}", lpart,
                     st.me_dists_partial_ref(*store, (), None, None, iis,
                                             jjs))
        check_bits(f"me_dists_list {label} k=1",
                   [st.me_pair_finish(lpart[None].contiguous(), use_matrix)],
                   [st.me_dists_list(*store, iis, jjs)])
        # two blocks of positions
        blocks = [(halves(codes, 1)[h], halves(W, 1)[h], halves(U, 1)[h])
                  for h in (0, 1)]
        parts = torch.stack([st.me_dists_list_partial(
            c, w, u, cf, ev, leaf_rows, iis, jjs) for c, w, u in blocks])
        two = st.me_pair_finish(parts, use_matrix)
        check_bits(f"me_pair_finish {label} k=2 against its twin", [two],
                   [st.me_pair_finish_ref(parts, use_matrix)])
        ferr = close(f"me_pair_finish {label} k=2", two,
                     st.me_dists_list(*store, iis, jjs))
        nni = (*store, (), None, None, ii, jj)
        C_ = cf.shape[1]
        rows = np.unique(np.concatenate([iis, jjs]))
        record("me_dists_partial", label, err, timing(
            "me_dists_partial", lambda: st.me_dists_partial(*nni),
            lambda: st.me_dists_partial_ref(*nni),
            4 * P * (4 * C_ + 5) + 2 * 6 * 8, 6 * P * (2 * C_ + 2)))
        record("me_dists_list_partial", f"{label}, 11,982 pairs", lerr,
               timing("me_dists_list_partial",
                      lambda: st.me_dists_list_partial(*store, iis, jjs),
                      lambda: st.me_dists_partial_ref(*store, (), None,
                                                      None, iis, jjs),
                      len(rows) * P * 4 * (C_ + 1) + 2 * 8 * len(iis),
                      len(iis) * P * (2 * C_ + 2)))
        record("me_pair_finish", f"{label}, 11,982 pairs, k=2", ferr, timing(
            "me_pair_finish", lambda: st.me_pair_finish(parts, use_matrix),
            lambda: st.me_pair_finish_ref(parts, use_matrix),
            8 * (parts.numel() + 2 * len(iis)), 6 * len(iis)))


def mesh_run(mesh, dev):
    """The -nt -noml run (its local bootstrap included) at MESH_N on
    `mesh` through run_pipeline, the launch counts and the exchange
    counters set to 0 just before it: what rank 0 reports.  Its Newick,
    and its tree printed without supports: -nosupport's tree, since
    -nosupport only skips the bootstrap at the end (pipeline._run_single)."""
    import torch

    from veryfasttree_tpu_torch.io.alignment import Uniquify, read_alignment
    from veryfasttree_tpu_torch.io.newick import print_newick
    from veryfasttree_tpu_torch.options import noml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    fasta = fasta_text(synth_codes(MESH_N, 500, seed=0))
    opts = noml_options()
    opts.n_bootstrap = MESH_BOOT
    opts.mesh = mesh
    reset_launches()
    mesh.stats = dict.fromkeys(mesh.stats, 0)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nj, _ = run_pipeline(opts, io.StringIO(fasta), out, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    aln = read_alignment(io.StringIO(fasta), opts, None)
    return {"newick": out.getvalue(),
            "nosupport": print_newick(nj.tree, aln.names, Uniquify.build(aln),
                                      False, False) + "\n",
            "wall_s": wall, "timings": nj.timings,
            "boot_stats": nj.boot_stats, "launches": launches,
            "exchanges": dict(mesh.stats), "U": list(nj.prof.U.shape),
            "n_local": nj.prof.n_local, "device": str(dev)}


def mesh_rank_main(rank, world, address, backend, out_dir) -> int:
    """chip_smoke.py --mesh-rank RANK WORLD ADDRESS BACKEND OUT: one rank of
    phase 11(b) on cuda:(rank % cards): mesh_run on an sp =
    WORLD mesh; its record into OUT/mesh_{rank}.json."""
    import torch

    for sub in ("", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    from veryfasttree_tpu_torch.parallel import make_mesh, multihost

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.init_ranks(address, world, rank, dev, backend)
    rec = mesh_run(make_mesh(n_sp=world), dev)
    with open(os.path.join(out_dir, f"mesh_{rank}.json"), "w") as f:
        json.dump({**rec, "backend": backend}, f)
    torch.distributed.destroy_process_group()
    return 0


def start_mesh_world(world, backend, out_dir):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(world), address, backend, out_dir], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def wait_mesh_worlds(procs):
    """Wait for every rank (killing them all past MESH_TIMEOUT_S); raise
    with a failed rank's errors."""
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=max(1.0, MESH_TIMEOUT_S - (
            time.perf_counter() - t0))) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a mesh rank exited {p.returncode}:\n"
                                 f"{err[-3000:]}")


def phase_mesh(report, dev):
    """11(b): -nt -noml at N=500 over ranks through run_pipeline (NCCL over
    min(cards, 4) ranks; one card: two ranks on cuda:0 over gloo), each
    rank's Newick byte-identical to the -noml JAX golden and its tree
    without supports to the -nosupport one, its store p_pad / ranks
    positions wide, the partial kernels launched and no whole-row kernel;
    then, where the smoke has time left (MESH_SINGLE_BY_S), the same run on
    one card through the same host loops (a 1 x 1 mesh in this process,
    whose exchanges send nothing)."""
    import torch

    from veryfasttree_tpu_torch.parallel import Mesh

    n_cards = torch.cuda.device_count()
    ranks, backend = (min(n_cards, 4), "nccl") if n_cards >= 2 \
        else (2, "gloo")
    if n_cards < 2:
        print("  one card: two ranks placed on cuda:0, over gloo")
    with open(GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(NOML_GOLDEN + ".nwk") as f:
        boot_golden = f.read()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        wait_mesh_worlds(start_mesh_world(ranks, backend, tmp))
        world_s = time.perf_counter() - t0
        recs = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"mesh_{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    elapsed = time.perf_counter() - SMOKE_T0
    single = None
    if elapsed < MESH_SINGLE_BY_S:
        single = mesh_run(Mesh(1, 1, 0, None, None, None), dev)
    else:
        print(f"  the one-card run left out: the smoke has run {elapsed:.1f}"
              f" s, past {MESH_SINGLE_BY_S} s")
    p_pad = -(-500 // 128) * 128

    def show(label, rec):
        ex = rec["exchanges"]
        t = {k: round(v, 4) for k, v in rec["timings"].items()}
        print(f"  {label} -nt -noml: wall {rec['wall_s']:.2f} s, {t}, "
              f"{rec['boot_stats']}, {ex['calls']} exchanges "
              f"({ex['bytes']} bytes received, "
              f"{1e3 * ex['s'] / max(ex['calls'], 1):.4f} ms a call, host "
              f"clock), byte-identical to the -noml golden "
              f"{rec['newick'] == boot_golden}, its tree without supports "
              f"to the -nosupport golden {rec['nosupport'] == golden}, "
              f"U {tuple(rec['U'])}")

    show(f"{ranks} ranks", recs[0])
    if single is not None:
        show("one card", single)
    for r, rec in enumerate(recs + ([single] if single else [])):
        label = f"rank {r}" if r < ranks else "one card"
        if rec["newick"] != boot_golden or rec["nosupport"] != golden:
            raise AssertionError(f"{label}: a Newick differs from the JAX "
                                 "golden")
        width = p_pad // ranks if r < ranks else p_pad
        if rec["U"][1] != width:
            raise AssertionError(f"{label}: the store holds {rec['U'][1]} "
                                 f"positions, not {width}")
        counts = rec["launches"]
        require_launched(label, counts, MESH_PATH + (
            "me_dist_pieces_list", "sh_resample_counts"))
        ran = {k: counts[k] for k in MESH_NEVER if counts[k]}
        if ran:
            raise AssertionError(f"{label}: {ran} launched")
    main = recs[0]
    for name in MESH_KERNELS:
        report.setdefault(name, {})["launches"] = main["launches"][name]
        if single is not None:
            report[name]["single_card_launches"] = single["launches"][name]
    ex = main["exchanges"]
    report["me_pair_finish"].update({
        "mesh_ranks": ranks, "mesh_backend": backend,
        "mesh_wall_s": main["wall_s"], "mesh_timings": main["timings"],
        "mesh_exchanges": ex["calls"],
        "mesh_exchange_ms": 1e3 * ex["s"] / max(ex["calls"], 1),
        "mesh_world_s": world_s})
    if single is not None:
        report["me_pair_finish"].update({
            "single_card_wall_s": single["wall_s"],
            "single_card_timings": single["timings"]})
        print(f"  walls: {ranks} ranks {main['wall_s']:.2f} s against one "
              f"card through the same host loops {single['wall_s']:.2f} s; "
              f"the rank processes from start to end {world_s:.1f} s")
    else:
        print(f"  wall: {ranks} ranks {main['wall_s']:.2f} s; the rank "
              f"processes from start to end {world_s:.1f} s")


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

    probe = {}

    def build():
        t0 = time.perf_counter()
        probe["epoch"] = start_probe_build()   # beside the library's nvccs
        path, log = _build.build(force=True)
        print(f"  built {os.path.relpath(path, REPO)} in "
              f"{time.perf_counter() - t0:.1f} s")
        print("\n".join("  " + line for line in log.splitlines()
                        if "registers" in line or "Function properties" in line
                        or "Compiling entry" in line or "stack frame" in line))
        _build.library()
        report = _build.ptxas_report(log)
        PTXAS.update(report)
        for limits, n_codes in ((_build.STACK_LIMITS, 4),
                                (_build.STACK_LIMITS_20, 20)):
            for kernel in limits:
                print(f"  {kernel}<{n_codes}>: "
                      f"{_build.kernel_resources(report, kernel, n_codes)}")
        faults = _build.resource_faults(report) + _build.resource_faults(
            report, _build.STACK_LIMITS_20, 20)
        if faults:
            raise AssertionError("; ".join(faults))

    phase("0 card", card)
    phase("1 build", build)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_twins_")
    if "1 build" not in failed:
        phase("2 kernels vs twins", phase_kernels, report)
        cuda = torch.device("cuda")
        phase("2b SPR round vs host loop", phase_spr, report, cuda)
        phase("2c NNI round vs host loop", phase_nni, report, cuda)
        phase("2d join epoch vs host loop", phase_epoch, report, cuda,
              probe["epoch"])
        phase("2e ML round and lengths pass vs host loop", phase_ml_round,
              report, cuda)
        phase("2f SH pass vs host loop", phase_sh, report, cuda)
        phase("2g CAT sweep and tree LogLk vs per-level launches",
              phase_cat_sweep, report, cuda)
        phase("2h ME split test and lengths vs serial walks",
              phase_me_passes, report, cuda)
        phase("2i ME local bootstrap vs serial walk", phase_boot, report,
              cuda)
        phase("3 N=500 vs JAX golden", phase_golden, report, cuda)
        phase(f"4 main path N={MAIN_N}", phase_main, report, cuda)
        phase(f"5 ML N={ML_GOLDEN_N} vs JAX golden", phase_ml_golden, cuda)
        phase(f"6 ML main path N={MAIN_N}", phase_ml_main, report, cuda)
        phase("2j ML kernels at 20 codes vs host loop, twins",
              phase_protein_kernels, report, cuda)
        phase(f"7a protein ML N={PROTEIN_GOLDEN_N} vs JAX goldens",
              phase_protein_golden, cuda)
        phase(f"7b protein ML main path N={PROTEIN_N}", phase_protein_main,
              report, cuda)
        phase("8 constraints", phase_constraints, report, cuda)
        phase("9 -threads", phase_threads, report, cuda, tmp)
        phase("10 checkpoint, fused join, trace", phase_last_modules,
              report, cuda, tmp)
        phase("11a mesh kernels vs twins", phase_mesh_kernels, report)
        phase("11b mesh runs", phase_mesh, report, cuda)
    shutil.rmtree(tmp, ignore_errors=True)
    if "epoch" in probe and probe["epoch"][1].poll() is None:
        probe["epoch"][1].kill()             # phase 2d did not wait for it
        probe["epoch"][1].wait()
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
    if sys.argv[1:2] == ["--twins"] and len(sys.argv) == 4:
        sys.exit(twins_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 7:
        a = sys.argv[2:]
        sys.exit(mesh_rank_main(int(a[0]), int(a[1]), *a[2:]))
    sys.exit(main())
