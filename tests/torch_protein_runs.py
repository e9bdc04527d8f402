"""Protein runs of the JAX package and the port on one alignment, and the
checks that hold them together (tests/test_torch_protein_ml_*.py).

``run_at(seed, name, directory)`` runs the port's ``run_pipeline`` (on the
CPU, its plain twins) on simulate_alignment(40, 120) with the package's
amino-acid alphabet at that seed, in one of CONFIGS: the default run (JTT,
CAT 20, SH-like supports from 1000 resamples), ``-lg -gamma`` or
``-approxml``, at verbose 2 with every ML NNI decision logged, and pairs it
with the JAX package's run of the same seed and config, read from the
goldens that scripts/make_torch_port_protein_cpu_golden.py wrote with
``_run`` on the JAX package (``jax_golden``; tests/test_torch_protein_ml.py
holds them to the JAX package's sources by their hash).  Each (seed,
config) has a test file of its own, so that the runs spread over the test
workers.

``check_pipeline`` holds a pair of runs together: the final LogLk within
1e-4 relative, and the stats block at verbose 2 equal line by line but
for the total time, the ML counts and the "Dist/N**2" line (ROADMAP Queue
3, item 1).  The decisions equal, each quartet's criteria less its first
within CRITERIA_TOL (tests/test_torch_ml_round.py's tolerance; the three
move together by up to 0.053 under LG, which the decision does not see),
up to the first decision the packages take otherwise, which must be a near
tie in both (its two criteria within NEAR_TIE) and is printed with its
margins; from there the trees part.  The SH pass's worst delta, a
difference of quartet criteria, agrees within CRITERIA_TOL (1.777 and
1.775 read at seed 3 under -approxml).  Where no decision flips: RF 0,
ML-NNIs per round equal, per-round LogLk within 1e-2, SH-like supports
within 0.02, the Gamma20 LogLk and alpha within 1e-2, and the whole stats
block equal but for the approximate-posteriors share, which must agree
within 0.02 points, the rough counts within 2e-4 of all counted
positions: -approxml's gate compares character-space probabilities near
0, which move with the packages' branch lengths.

FLOOR_NOISE.  On branches at the minimum length (5e-4) the three
topologies tie, and the SH-like support is float32 noise of whichever
package computes it: at seeds 3, 4 and 7 the packages' supports there lie
up to 0.473 apart, and the port's own move by up to 0.326 when it rotates
its posteriors with float32 products instead of double sums (the JAX
package's rounding), the tree the same, while every other support stays
within 0.014 of both (scripts/compare_protein_supports.py).  Those
supports are printed, and the branches at the minimum length must be the
same in both packages.
"""
import dataclasses
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from util import rf_distance, simulate_alignment, write_fasta

from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as torch_pipeline
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.options import Options as TOptions

AA = "ARNDCQEGHILKMFPSTWYV"
ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")
GAMMA = re.compile(r"Gamma\(20\) LogLk = (-?[\d.]+) alpha = ([\d.]+)")
SHARE = re.compile(r" approximate-posteriors ([\d.]+)%")
SUPPORT = re.compile(r"\)([\d.]+):(-?[\d.]+)")
WORST = re.compile(r"Worst delta-LogLk (-?[\d.]+)")
# the stats block's lines, but "Dist/N**2", whose by-profile count the JAX
# package's fused join takes otherwise than its own unfused loop, which the
# port follows (ROADMAP Queue 3, item 1)
STATS = ("Total time", "Top hits", " Hill-climb", "NNI: ",
         "Max-lk operations")
CONFIGS = {"default": {}, "lg-gamma": {"use_lg": True, "gamma_loglk": True},
           "approxml": {"exact_ml": False}}
# a quartet's criteria less their first (the differences that decide) within
# tests/test_torch_ml_round.py's 2e-2; the three move together by more
# under LG (0.053 measured: the JAX package's float32 posteriors and sums)
CRITERIA_TOL = 2e-2
NEAR_TIE = 5e-3          # a flipped decision's two criteria, in each package


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The host loops issue tiny ops, on which intra-op threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(run_pipeline, fasta, flags, mod, **kw):
    """One protein run at verbose 2 with mod.ml_quartet_nni's decisions
    logged: (newick, log text, (rough, exact) counts, [(rows, choice,
    criteria)])."""
    opts = Options(show_progress=False, n_codes=20, verbose=2, **flags)
    opts.derive_settings()
    if run_pipeline is torch_pipeline.run_pipeline:
        opts = TOptions(**dataclasses.asdict(opts))
    out, log, decisions = io.StringIO(), io.StringIO(), []
    orig = mod.ml_quartet_nni

    def logged(nj, rows4, *a):
        res = orig(nj, rows4, *a)
        decisions.append((tuple(int(r) for r in rows4), int(res[0]),
                          np.array(res[1], dtype=np.float64)))
        return res

    mod.ml_quartet_nni = logged
    try:
        with open(fasta) as f:
            nj, _ = run_pipeline(opts, f, out, log_fp=log, **kw)
    finally:
        mod.ml_quartet_nni = orig
    return out.getvalue(), log.getvalue(), (
        nj.debug.n_aa_posterior_rough,
        nj.debug.n_aa_posterior_exact), decisions


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN = "torch_port_protein_cpu"         # the goldens' stem in tests/data


def golden_meta():
    """The goldens' record: the source hash they were written under, the
    command and each run's seconds."""
    with open(os.path.join(DATA, GOLDEN + ".json")) as f:
        return json.load(f)


def jax_golden(seed, name):
    """The JAX package's run of `seed` in config `name`, as _run returns it,
    from the goldens."""
    stem = os.path.join(DATA, f"{GOLDEN}_s{seed}_{name.replace('-', '_')}")
    with open(stem + ".nwk") as f:
        newick = f.read()
    with open(stem + ".log") as f:
        log = f.read()
    with np.load(stem + ".npz") as z:
        decisions = [(tuple(int(r) for r in rows), int(choice),
                      np.array(crit, dtype=np.float64))
                     for rows, choice, crit in zip(z["rows"], z["choice"],
                                                   z["criteria"])]
        aa = tuple(int(x) for x in z["aa"])
    return newick, log, aa, decisions


def run_at(seed, name, directory):
    """(JAX run, port run) of config `name` on the alignment of `seed`: the
    JAX package's from its golden, the port's run here."""
    fasta = str(directory / "aa.fasta")
    write_fasta(fasta, simulate_alignment(40, 120, alphabet=AA, seed=seed))
    return jax_golden(seed, name), _run(
        torch_pipeline.run_pipeline, fasta, CONFIGS[name], tml,
        device=torch.device("cpu"))


def _stats(log):
    return [line for line in log.splitlines() if line.startswith(STATS)]


def _first_flip(dec_j, dec_t):
    """The index of the first ML NNI decision the packages take otherwise,
    or None; before it the same quartets, choices and criteria within
    CRITERIA_TOL, and at it a near tie in both packages.  Returns (index,
    the two packages' margins between the two choices)."""
    assert len(dec_j) == len(dec_t) or any(
        j[:2] != t[:2] for j, t in zip(dec_j, dec_t))
    for k, (j, t) in enumerate(zip(dec_j, dec_t)):
        assert j[0] == t[0], k                          # the same quartet
        assert np.all(np.abs((t[2] - t[2][0]) - (j[2] - j[2][0]))
                      <= CRITERIA_TOL), k
        if j[1] != t[1]:
            margins = [abs(c[j[1]] - c[t[1]]) for c in (j[2], t[2])]
            assert max(margins) <= NEAR_TIE, (k, margins)
            return k, margins
    return None, None


def check_pipeline(name, jax_run, port_run, agree=False):
    """check_pipeline of the module docstring; with agree, no decision may
    flip."""
    (nw_j, log_j, aa_j, dec_j), (nw_t, log_t, aa_t, dec_t) = \
        jax_run, port_run
    final_t, final_j = (float(FINAL.findall(x)[-1]) for x in (log_t, log_j))
    assert abs(final_t - final_j) <= 1e-4 * abs(final_j)
    stats_t, stats_j = _stats(log_t), _stats(log_j)
    assert len(stats_t) == len(stats_j) >= 4
    # every line of the stats block but the total time, the ML counts (the
    # Max-lk line, the ML-NNIs) and the SH pass's worst delta equal; the
    # worst delta, a difference of quartet criteria, within CRITERIA_TOL
    # (as tests/test_torch_sh_pass.py holds it)
    strip = (lambda s: re.sub(r"Total time: [\d.]+ seconds |ML-NNI: \d+|"
                              r"Worst delta-LogLk -?[\d.]+", "", s))
    assert [strip(x) for x in stats_t if "Max-lk" not in x] == \
        [strip(x) for x in stats_j if "Max-lk" not in x]
    worst_t, worst_j = (WORST.findall(x) for x in (log_t, log_j))
    assert len(worst_t) == len(worst_j) and all(
        abs(float(a) - float(b)) <= CRITERIA_TOL
        for a, b in zip(worst_t, worst_j)), (worst_t, worst_j)
    rf = rf_distance(nw_t, nw_j)[0]
    flip, margins = _first_flip(dec_j, dec_t)
    assert flip is None or not agree, (flip, margins)
    if flip is not None:
        # from a near tie on the trees part: reported, with its margins
        print(f"{name}: decision {flip} of {len(dec_j)} flips on a near tie "
              f"(quartet {dec_j[flip][0]}, choices {dec_j[flip][1]} and "
              f"{dec_t[flip][1]}, {margins[0]:.2e} apart in the JAX package,"
              f" {margins[1]:.2e} in the port); RF {rf} after it; final "
              f"LogLk {final_t} (JAX {final_j})")
        return
    assert rf == 0
    rounds_j, rounds_t = ROUND.findall(log_j), ROUND.findall(log_t)
    assert rounds_j and [r[2] for r in rounds_t] == [r[2] for r in rounds_j]
    for (_, ll_t, _), (_, ll_j, _) in zip(rounds_t, rounds_j):
        assert abs(float(ll_t) - float(ll_j)) <= 1e-2
    if name == "lg-gamma":
        [(g_t, a_t)], [(g_j, a_j)] = GAMMA.findall(log_t), GAMMA.findall(log_j)
        assert abs(float(g_t) - float(g_j)) <= 1e-2
        assert abs(float(a_t) - float(a_j)) <= 1e-2
    # SH-like supports within 0.02, but on branches at the minimum length
    # (the same branches in both packages), where they are float32 noise:
    # printed only (FLOOR_NOISE)
    sup_t, sup_j = SUPPORT.findall(nw_t), SUPPORT.findall(nw_j)
    assert len(sup_t) == len(sup_j) == 37
    floor = []
    for (s_t, len_t), (s_j, len_j) in zip(sup_t, sup_j):
        at_floor = float(len_j) <= 6e-4
        assert (float(len_t) <= 6e-4) == at_floor
        if at_floor:
            floor.append(abs(float(s_t) - float(s_j)))
        else:
            assert abs(float(s_t) - float(s_j)) <= 0.02
    print(f"{name}: {len(floor)} of 37 supports at the minimum length, "
          f"{max(floor, default=0):.3f} apart at most")
    # the Max-lk line: equal but for the share, which agrees to within the
    # counts' flips
    assert [strip(SHARE.sub("", x)) for x in stats_t] == \
        [strip(SHARE.sub("", x)) for x in stats_j]
    share_t, share_j = (float(SHARE.findall(x)[-1]) for x in (log_t, log_j))
    total = sum(aa_j)
    assert sum(aa_t) == total > 0
    print(f"{name}: rough/exact {aa_t} (JAX {aa_j}), {abs(aa_t[0] - aa_j[0])} "
          f"positions decided otherwise; approximate-posteriors {share_t}% "
          f"(JAX {share_j}%)")
    assert abs(aa_t[0] - aa_j[0]) <= 2e-4 * total
    assert abs(share_t - share_j) <= 0.02
    if name != "approxml":
        assert aa_t == aa_j and aa_t[0] == 0 and share_t == 0.0
