"""End-to-end pipeline on one torch device (counterpart of the serial path
of ``veryfasttree_tpu/pipeline.py``).

read + uniquify -> ME profile store -> top-hits seeding -> NJ join loop ->
ME NNI rounds interleaved with SPR -> ME branch lengths -> [ML phase: ML
lengths, ML NNIs, CAT rates, GTR, SH-like supports, Gamma20] or the ME
split test -> Newick (ref VeryFastTreeImpl.tcc:46-472).

Protein ML, the -noml local bootstrap, -threads > 1, -makematrix, -intree,
-checkpoint and -constraints are not ported yet and raise.
"""
from __future__ import annotations

import math
import time

import numpy as np

from .engine import batched, ml, rearrange, spr, supports
from .engine.nj import NeighbourJoining
from .io.alignment import Alignment, Uniquify, read_alignment, seqs_to_codes
from .io.newick import print_newick
from .models import DistanceMatrix, TransitionMatrix
from .ops import nni_kernels, spr_kernels
from .utils.debug import Debug
from .utils.device import configure_precision, resolve_device
from .utils.progress import ProgressReport


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


def _check_ported(options) -> None:
    missing = [
        ("protein ML (use -noml)", _ml_on(options) and options.n_codes == 20),
        ("-noml local-bootstrap supports (use -nosupport)",
         not _ml_on(options) and options.n_bootstrap > 0),
        ("-threads > 1", options.threads > 1),
        ("-makematrix", options.make_matrix),
        ("-intree", bool(options.intree_file)),
        ("-checkpoint", bool(options.checkpoint_file)),
        ("-constraints", bool(options.constraints_file)),
    ]
    for what, requested in missing:
        if requested:
            raise NotImplementedError(f"{what} is not ported yet")


def run_pipeline(options, input_fp, output_fp, log_fp=None, device=None):
    """The minimum-evolution pipeline on `device` (CUDA by default; a
    missing GPU raises).  With -n > 1, analyzes several alignments from the
    same stream.  Returns (nj, split_count) of the last alignment."""
    _check_ported(options)
    device = resolve_device(device)
    configure_precision()
    result = None
    for i_aln in range(options.n_align):
        if i_aln > 0:
            options.in_file_name = ""  # only the first read can use the native path
        result = _run_single(options, input_fp, output_fp, log_fp, device)
    return result


def _run_single(options, input_fp, output_fp, log_fp, device):
    log = log_fp
    progress = ProgressReport(options.show_progress, options.verbose,
                              options.relative_progress)
    options.debug = Debug()

    native_read = _try_native_read(options)
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
    if aln.tree:
        raise NotImplementedError("a starting tree (-intree) is not ported yet")

    if len(set(names)) != len(names):
        seen = set()
        dup = next(n for n in names if n in seen or seen.add(n))
        raise ValueError(f"Non-unique name '{dup}' in the alignment")

    if native_read is None:
        unique = Uniquify.build(aln)
        progress.print("Identified unique sequences")
        codes = seqs_to_codes(unique.unique_seq, options, log)

    dmat, tmat = build_models(options)
    nj = NeighbourJoining(options, codes, dmat, tmat, log=log,
                          progress=progress, names=names, device=device)
    n_uniq = len(unique.unique_seq)
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
    # -slow keeps the host loops: its length checks and its repairs of
    # every ancestor need the whole tree
    spr_round = spr.run_spr if options.slow else spr_kernels.spr_round

    def nni_round(i, stats):
        if options.slow:
            return rearrange.do_nni(nj, i, nni_to_do, False, stats)
        return nni_kernels.nni_round(nj, i, nni_to_do, stats)

    def run_spr_round():
        nonlocal spr_remaining
        t = time.perf_counter()
        spr_round(nj, options.spr - spr_remaining, options.spr)
        nj.timings["spr_s"] += time.perf_counter() - t
        log_tree("ME_SPR%d", options.spr - spr_remaining + 1)
        spr_remaining -= 1

    # ME NNI rounds interleaved with SPR (ref VeryFastTreeImpl.tcc:161-204)
    if nni_to_do > 0 and n_uniq > 3:
        stats = rearrange.NNIStats.init(nj)
        converged = False
        for i in range(nni_to_do):
            if not converged:
                t = time.perf_counter()
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
    if not options.bionj:
        # one gathered distance call for the whole tree; value-identical to
        # the serial walk with the plain 0.5 up-profile average
        batched.update_branch_lengths_batched(nj)
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
                                      log, log_tree)
    else:
        split_count = supports.test_splits_min_evo(nj)
        nj.timings["splits_s"] = time.perf_counter() - t2

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
            extra = f" star-only {d.n_star_tests}" \
                if options.ml_accuracy < 2 else ""
            print(f"Max-lk operations: lk {d.n_lk_compute} posterior "
                  f"{d.n_posterior_compute}{extra}", file=log)
