"""End-to-end pipeline on one torch device (counterpart of the serial path
of ``veryfasttree_tpu/pipeline.py``).

read + uniquify -> ME profile store -> top-hits seeding -> NJ join loop
(or a starting tree, -intree) -> ME NNI rounds interleaved with SPR -> ME
branch lengths -> [ML phase: ML lengths, ML NNIs, CAT rates, GTR, SH-like
supports, Gamma20] or the ME split test and the ME local bootstrap ->
Newick (ref VeryFastTreeImpl.tcc:46-472); or, with -makematrix, the
distance matrix of every sequence.

Under a mesh (-mesh-sp / -mesh-dp, parallel/) every rank runs this same
orchestration over its block of the alignment's positions
(engine/profiles.ShardedMEProfiles): the -noml path (with its local
bootstrap, nucleotide or protein, -bionj, -slow, -fastest, -2nd, -notop,
-pseudo, -intree, the two-tier store) through the host loops (the join
loop without the epoch or the fused step, ME NNI and SPR as -slow takes
them), each distance's sums exchanged between the ranks; the rest raises
NotImplementedError (unported_under_mesh).

-constraints (a 0/1/- alignment of split columns, ref alnToConstraints)
reaches every phase: the join penalties, the ME and ML NNI and SPR
criteria and the split tests' constraint counts.  -threads > 1 takes the
JAX package's batched tier (the reference's relaxed thread-parallel
modes): level-batched ME and ML NNI rounds (engine/batched.py),
partitioned lockstep SPR rounds (engine/spr_batched.py), the batched ME
lengths, split test and local bootstrap, and level-batched ML lengths;
-threads 1, the default, is the serial tier.  -checkpoint file saves the
engine's arrays after every ML-NNI round (engine/checkpoint.py); a run
that finds the file resumes from it, in place of the NJ and ME phases.
VFT_TRACE=dir writes a torch.profiler trace of the run into dir
(utils/trace.py).
"""
from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from .engine import (batched, checkpoint, ml, rearrange, spr, spr_batched,
                     supports)
from .engine.nj import NeighbourJoining
from .io.alignment import (Alignment, Uniquify, open_maybe_compressed,
                           read_alignment, seqs_to_codes)
from .io.newick import parse_newick, print_newick
from .models import DistanceMatrix, TransitionMatrix
from .ops import nni_kernels, spr_kernels
from .parallel import mesh_from_options, multihost
from .utils.debug import Debug
from .utils.device import configure_precision, resolve_device
from .utils.progress import ProgressReport
from .utils.trace import annotate, maybe_trace


def build_models(options):
    dmat = None
    if options.matrix_prefix:
        dmat = DistanceMatrix.from_files(options.matrix_prefix, options)
    elif options.use_matrix:
        assert options.n_codes == 20
        dmat = DistanceMatrix.blosum45()
    tmat = None
    if options.n_codes == 20:
        if options.transition_file:
            tmat = TransitionMatrix.from_file(options.transition_file)
        elif options.use_lg:
            tmat = TransitionMatrix.lg08()
        elif options.use_wag:
            tmat = TransitionMatrix.wag01()
        else:
            tmat = TransitionMatrix.jtt92()
    elif options.n_codes == 4 and options.use_gtr and (options.use_gtr_rates
                                                       or options.use_gtr_freq):
        tmat = TransitionMatrix.gtr(options.gtr_rates, options.gtr_freq)
    return dmat, tmat


def read_constraints(options, unique, name_to_idx, log):
    """The constraints alignment as unique-sequence (nOn, nOff) counts
    [n_unique, n_cons] int64 (ref alnToConstraints VeryFastTreeImpl.tcc:
    474-515; the JAX package's read_constraints), or None without one.  A
    file of fewer than 4 sequences is ignored with a warning, a second
    sequence of a unique group that disagrees with the first is ignored
    with a warning, and a name not in the alignment raises ValueError."""
    if not options.constraints_file:
        return None
    with open_maybe_compressed(options.constraints_file) as fp:
        caln = read_alignment(fp, options, log)
    if len(caln.seqs) < 4:
        print("Warning: constraints file with less than 4 sequences ignored",
              file=log or sys.stderr)
        return None
    n_cons = caln.n_pos
    n_uniq = len(unique.unique_seq)
    on = np.zeros((n_uniq, n_cons), dtype=np.int64)
    off = np.zeros((n_uniq, n_cons), dtype=np.int64)
    seen = {}
    for name, seq in zip(caln.names, caln.seqs):
        if name not in name_to_idx:
            raise ValueError(f"Sequence {name} from constraints file is not in "
                             "the alignment")
        iu = unique.aln_to_uniq[name_to_idx[name]]
        if iu in seen:
            if seen[iu] != seq and log is not None:
                print(f"Warning: ignoring constraints for {name}", file=log)
            continue
        seen[iu] = seq
        for c, ch in enumerate(seq):
            if ch == "1":
                on[iu, c] = 1
            elif ch == "0":
                off[iu, c] = 1
    return on, off


def _try_native_read(options):
    """Fast path: native FASTA parse + dedup straight to the unique code
    matrix (native/vft_native.cpp).  Returns (names, unique_codes,
    Uniquify) or None to use the Python reader."""
    from .io import native

    path = options.in_file_name
    if not path or not native.available():
        return None
    try:
        with open(path, "rb") as f:
            head = f.read(2)
        if not head.startswith(b">"):
            return None
        parsed = native.parse_fasta_codes(path, options)
        if parsed is None:
            return None
        names, codes = parsed
        first_of = native.uniquify_codes(codes)
    except (ValueError, OSError):
        return None
    n = len(names)
    aln_next = [-1] * n
    aln_to_uniq = [-1] * n
    unique_first = []
    last_of = {}
    uniq_rows = []
    for i in range(n):
        fi = int(first_of[i])
        if fi == i:
            aln_to_uniq[i] = len(unique_first)
            unique_first.append(i)
            uniq_rows.append(i)
        else:
            aln_next[last_of[fi]] = i
            aln_to_uniq[i] = aln_to_uniq[fi]
        last_of[fi] = i
    unique = Uniquify(unique_seq=[None] * len(unique_first),
                      unique_first=unique_first, aln_next=aln_next,
                      aln_to_uniq=aln_to_uniq)
    return names, codes[np.array(uniq_rows)], unique


def _ml_on(options) -> bool:
    return options.ml_nni != 0 or options.ml_len


def unported_under_mesh(options) -> str | None:
    """The first option this slice of the multi-GPU port does not run
    under a mesh, or None."""
    for on, name in ((_ml_on(options), "the ML phase (a run without -noml)"),
                     (options.threads > 1, "-threads > 1"),
                     (bool(options.constraints_file), "-constraints"),
                     (options.make_matrix, "-makematrix"),
                     (bool(options.checkpoint_file), "-checkpoint")):
        if on:
            return name
    return None


def run_pipeline(options, input_fp, output_fp, log_fp=None, device=None):
    """The minimum-evolution pipeline on `device` (CUDA by default; a
    missing GPU raises).  With -n > 1, analyzes several alignments from the
    same stream.  Returns (nj, split_count) of the last alignment.

    With -coordinator (or VFT_COORDINATOR) this process joins the run's
    ranks first; with -mesh-sp / -mesh-dp (or a Mesh in options.mesh) it
    runs as one rank of the mesh, which needs the ranks' process group
    (parallel.multihost): nothing falls back to one card."""
    device = resolve_device(device)
    configure_precision()
    multihost.maybe_init_distributed(options, device)
    if options.mesh is None:
        options.mesh = mesh_from_options(options)
    if options.mesh is not None:
        name = unported_under_mesh(options)
        if name is not None:
            raise NotImplementedError(
                f"{name} under a mesh (-mesh-sp/-mesh-dp) is not ported yet: "
                "ROADMAP.md Queue 1, the next multi-GPU slices")
        if options.mesh.dp > 1 and options.mesh.rank == 0 \
                and log_fp is not None:
            print(f"Note: -mesh-dp {options.mesh.dp} replicates the store and "
                  f"its work on every dp rank (the row split is not ported "
                  f"yet): {options.mesh.dp * options.mesh.sp} cards do the "
                  f"work of {options.mesh.sp}", file=log_fp)
    result = None
    with maybe_trace():   # VFT_TRACE=dir: a torch.profiler trace of the run
        for i_aln in range(options.n_align):
            if i_aln > 0:
                # only the first read can use the native path
                options.in_file_name = ""
            result = _run_single(options, input_fp, output_fp, log_fp, device)
    return result


def _run_single(options, input_fp, output_fp, log_fp, device):
    log = log_fp
    progress = ProgressReport(options.show_progress, options.verbose,
                              options.relative_progress)
    options.debug = Debug()

    # -makematrix needs per-sequence (not uniquified) codes, and the
    # constraints the Python reader's names and unique groups, so both take
    # the Python read path; the native path returns the unique code matrix
    # only
    native_read = None if options.make_matrix or options.constraints_file \
        else _try_native_read(options)
    if native_read is not None:
        names, codes, unique = native_read
        progress.print("Read alignment (native parser)")
        aln = Alignment(names=names, seqs=[], n_pos=codes.shape[1])
    else:
        aln = read_alignment(input_fp, options, log)
        if not aln.seqs:
            raise ValueError("No alignment sequences")
        progress.print("Read alignment")
        names = aln.names

    if len(set(names)) != len(names):
        seen = set()
        dup = next(n for n in names if n in seen or seen.add(n))
        raise ValueError(f"Non-unique name '{dup}' in the alignment")
    name_to_idx = {n: i for i, n in enumerate(names)}

    if options.make_matrix:
        # print the pairwise (log-corrected) distance matrix and stop
        # (ref printDistances NeighbourJoining.tcc:274-288)
        dmat, _ = build_models(options)
        mm = NeighbourJoining(options, seqs_to_codes(aln.seqs, options, log),
                              dmat, None, log=log, progress=progress,
                              names=names, device=device)
        _print_distances(mm, names, output_fp)
        return mm, None

    if native_read is None:
        unique = Uniquify.build(aln)
        progress.print("Identified unique sequences")
        codes = seqs_to_codes(unique.unique_seq, options, log)
    cons = read_constraints(options, unique, name_to_idx, log)

    dmat, tmat = build_models(options)
    with annotate("store"):
        nj = NeighbourJoining(options, codes, dmat, tmat, cons, log=log,
                              progress=progress, names=names, device=device)
    n_uniq = len(unique.unique_seq)
    # an array-state checkpoint takes precedence over a starting tree: the
    # tree, both stores and the rates mid-ML-phase, no NJ or ME replay
    resume = None
    if options.checkpoint_file and os.path.exists(options.checkpoint_file):
        resume = checkpoint.load_checkpoint(nj, options.checkpoint_file)
        progress.print("Resumed from checkpoint")
        if log is not None:
            print(f"Resumed from checkpoint {options.checkpoint_file} "
                  f"(phase {resume[0].get('phase')}, "
                  f"round {resume[0].get('round')})", file=log)
    elif options.intree_file and not options.intree_file.startswith("*"):
        with open(options.intree_file) as fp:
            _load_intree(nj, fp.read(), name_to_idx, unique)
    elif aln.tree:
        _load_intree(nj, aln.tree, name_to_idx, unique)
    else:
        nj.fast_nj()
    progress.print("Initial topology complete")

    def log_tree(fmt, i):
        """Persist intermediate trees (ref logTree tcc:5516-5522)."""
        if options.log_file_name and log is not None:
            log.write((fmt % i if "%" in fmt else fmt) + "\t")
            log.write(print_newick(nj.tree, names, unique, False,
                                   options.double_precision, options.quote))
            log.write("\n")

    log_tree("NJ", 0)

    nni_to_do = options.nni if options.nni != -1 else \
        int(0.5 + 4.0 * math.log2(max(n_uniq, 2)))
    spr_remaining = options.spr
    ml_nni_to_do = options.ml_nni if options.ml_nni != -1 else \
        int(0.5 + 2.0 * math.log2(max(n_uniq, 2)))
    # host-clock seconds of the ME NNI and the SPR rounds, summed over rounds
    nj.timings.update(nni_s=0.0, spr_s=0.0)
    threads = options.threads > 1
    # -slow keeps the host loops: its length checks and its repairs of
    # every ancestor need the whole tree; -threads > 1 takes the batched
    # tier, -slow or not (the JAX package's choice).  A mesh takes the host
    # loops too (the round kernels read whole rows, where a mesh's
    # distances need the ranks' exchange), with the default semantics.
    host_loops = options.slow or options.mesh is not None
    spr_round = spr_batched.run_spr_batched if threads \
        else spr.run_spr if host_loops else spr_kernels.spr_round

    def nni_round(i, stats):
        if threads:
            return batched.do_nni_batched(nj, i, nni_to_do, False, stats)
        if host_loops:
            return rearrange.do_nni(nj, i, nni_to_do, False, stats)
        return nni_kernels.nni_round(nj, i, nni_to_do, stats)

    def run_spr_round():
        nonlocal spr_remaining
        t = time.perf_counter()
        with annotate("spr"):
            spr_round(nj, options.spr - spr_remaining, options.spr)
        nj.timings["spr_s"] += time.perf_counter() - t
        log_tree("ME_SPR%d", options.spr - spr_remaining + 1)
        spr_remaining -= 1

    if resume is not None:
        nni_to_do = spr_remaining = 0
    # ME NNI rounds interleaved with SPR (ref VeryFastTreeImpl.tcc:161-204)
    if nni_to_do > 0 and n_uniq > 3:
        stats = rearrange.NNIStats.init(nj)
        converged = False
        for i in range(nni_to_do):
            if not converged:
                t = time.perf_counter()
                with annotate("nni"):
                    n_change, _ = nni_round(i, stats)
                nj.timings["nni_s"] += time.perf_counter() - t
                progress.print("ME NNI round %d of %d, %d changes", i + 1,
                               nni_to_do, n_change)
                log_tree("ME_NNI%d", i + 1)
                if n_change == 0:
                    converged = True
            if (spr_remaining > 0 and nni_to_do // (options.spr + 1) > 0
                    and (i + 1) % (nni_to_do // (options.spr + 1)) == 0):
                run_spr_round()
                converged = False
                stats = rearrange.NNIStats.init(nj)
    while spr_remaining > 0 and n_uniq > 3:
        run_spr_round()

    t1 = time.perf_counter()
    up_tables = None
    batched_me = threads or not options.bionj
    if resume is None:      # else the checkpoint's branch lengths stand
        with annotate("lengths"):
            if batched_me:
                # one gathered distance call for the whole tree;
                # value-identical to the serial walk with the plain 0.5
                # up-profile average (-threads takes it under -bionj too,
                # as the JAX package does)
                up_tables = batched.update_branch_lengths_batched(nj)
            else:
                rearrange.update_branch_lengths(nj)
        log_tree("ME_Lengths", 0)
        total_len = nj.total_len()
        if options.verbose > 0 and log is not None:
            print(f"Total branch-length {total_len:.3f} after "
                  f"{progress.clock_diff():.2f} sec", file=log)

    t2 = time.perf_counter()
    # host-clock seconds; each phase ends in a fetch of distances
    nj.timings["lengths_s"] = t2 - t1
    if ml_nni_to_do > 0 or options.ml_len:
        split_count = ml.run_ml_phase(nj, ml_nni_to_do, n_uniq, progress,
                                      log, log_tree, resume=resume)
    else:
        # one sweep and one distance list for the whole tree; with -bionj
        # (and one thread) the up-profiles are BIONJ-weighted, and the
        # serial walk stays
        with annotate("splits"):
            split_count = supports.test_splits_min_evo_batched(
                nj, up_tables) if batched_me \
                else supports.test_splits_min_evo(nj)
        t3 = time.perf_counter()
        nj.timings["splits_s"] = t3 - t2
        if options.n_bootstrap > 0 and n_uniq > 3:
            # the ME local bootstrap; batched over the up-profiles the
            # split test's sweep just wrote (the JAX package's
            # reliability_nj_batched with -threads > 1)
            with annotate("boot"):
                nj.boot_stats = supports.reliability_nj_list(
                    nj, swept=True) if batched_me \
                    else supports.reliability_nj(nj)
            nj.timings["boot_s"] = time.perf_counter() - t3

    newick = print_newick(nj.tree, names, unique, options.n_bootstrap > 0,
                          options.double_precision, options.quote)
    output_fp.write(newick + "\n")
    progress.done()
    _report_stats(options, nj, split_count, len(names), n_uniq, ml_nni_to_do,
                  progress, log)
    return nj, split_count


def _report_stats(options, nj, sc, n_seq, n_uniq, ml_nni_to_do, progress,
                  log):
    """Final stats block (ref VeryFastTreeImpl.tcc:403-465)."""
    if log is None:
        return
    ml_store = getattr(nj, "ml", None)
    if ml_store is not None:
        ml_store.flush_posterior_counters()
    d = nj.debug
    line = (f"Total time: {progress.clock_diff():.2f} seconds "
            f"Unique: {n_uniq}/{n_seq} "
            f"Bad splits: {sc.n_bad_splits}/{sc.n_splits}")
    if sc.d_worst_delta_unconstrained > 0:
        kind = "LogLk" if _ml_on(options) else "Len"
        line += f" Worst delta-{kind} {sc.d_worst_delta_unconstrained:.3f}"
    print(line, file=log)
    if options.verbose > 1 or options.log_file_name:
        dn2 = max(n_uniq * float(n_uniq), 1.0)
        print(f"Dist/N**2: by-profile {d.profile_ops / dn2:.3f} "
              f"(out {d.outprofile_ops / dn2:.3f}) by-leaf {d.seq_ops / dn2:.3f} "
              f"avg-prof {d.profile_avg_ops / dn2:.3f}", file=log)
        if d.n_close_used or d.n_close2_used or d.n_refresh_tophits:
            print(f"Top hits: close neighbors {d.n_close_used}/{n_uniq} "
                  f"2nd-level {d.n_close2_used} refreshes {d.n_refresh_tophits}",
                  file=log)
        if not options.slow:
            print(f" Hill-climb: {d.n_hill_better} Update-best: {d.n_visible_update}",
                  file=log)
        print(f"NNI: {d.n_nni} SPR: {d.n_spr} ML-NNI: {d.n_ml_nni}", file=log)
        if ml_nni_to_do > 0:
            extra = ""
            if d.n_aa_posterior_exact or d.n_aa_posterior_rough:
                frac = 100.0 * d.n_aa_posterior_rough / max(
                    d.n_aa_posterior_exact + d.n_aa_posterior_rough, 1)
                extra += f" approximate-posteriors {frac:.2f}%"
            if options.ml_accuracy < 2:
                extra += f" star-only {d.n_star_tests}"
            print(f"Max-lk operations: lk {d.n_lk_compute} posterior "
                  f"{d.n_posterior_compute}{extra}", file=log)


def _print_distances(nj, names, out):
    """All-pairs leaf distances (ref printDistances tcc:274-288): one scan
    of each sequence against every row (scan_kernels.nj_scan_dense, or
    nj_scan_codes over a two-tier store's leaves)."""
    n = nj.n_seqs
    for i in range(n):
        dist, _ = nj.prof.dist_one_vs_all(i)
        d = dist[:n]
        if nj.options.logdist:
            d = nj.log_corrected(d)
        out.write(names[i])
        for j in range(n):
            out.write(" %f" % max(d[j], 0.0))
        out.write("\n")


def _load_intree(nj, text, name_to_idx, unique):
    """Read a starting tree and compute its profiles bottom-up (ref
    readTree; the JAX package's _load_intree)."""
    parent, children, root, n_used = parse_newick(text, name_to_idx, unique)
    tree = nj.tree
    tree.root = root
    tree.maxnode = n_used
    for node in range(n_used):
        tree.parent[node] = parent[node]
        kids = children[node]
        tree.n_child[node] = len(kids)
        tree.children[node, :] = -1
        for k, c in enumerate(kids):
            tree.children[node, k] = c
    rearrange.recompute_profiles_levelwise(nj)
