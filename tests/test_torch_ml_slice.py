"""The port's ML pipeline against the JAX package's, both on the CPU.

Same FASTA, same options: the default -nt run (ML NNIs, CAT 20 rates,
SH-like supports, here from 100 resamples), -gtr -gamma, and -mllen.
Requirements (docs/PARITY.md, tier 1 for ML):

* identical topology: the Newick strings equal once lengths and supports
  are stripped;
* identical ML-NNI counts per round, and per-round and final LogLk within
  1e-3 (both printed to 3 decimals).  Under -gtr within 1e-2: the six GTR
  rates are Brent optima (tolerance 1e-3 relative) of the tree
  log-likelihood, which the JAX package sums in float32 per tree pair, so
  the fitted rates differ in the third decimal and the LogLk in the third
  (5e-3 measured at LogLk -1771).  Under -gamma the Gamma20 LogLk and
  alpha within 1e-2;
* branch lengths within 1e-4 + 2e-3 * length.  Both packages end each
  branch's Brent search within its own tolerance (ftol 1e-3 relative) on
  their own float32 objective, which differ by the JAX package's float32
  rounding of the sum over positions; lengths agree to that, not to 1e-4;
* SH-like supports within 0.02, except on branches at the minimum length
  (5e-4), whose three topologies tie in likelihood: their resampled
  deltas are float32 noise of either package (0.054 apart measured), so
  there within 0.1.
"""
import io
import re

import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu import pipeline as jax_pipeline
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as torch_pipeline

ROUND = re.compile(r"ML-NNI round (\d+): LogLk = (-?[\d.]+) NNIs (\d+)")
FINAL = re.compile(r"Optimize all lengths: LogLk = (-?[\d.]+)")
GAMMA = re.compile(r"Gamma\(20\) LogLk = (-?[\d.]+) alpha = ([\d.]+)")
LENGTH = re.compile(r":(-?[\d.]+(?:e-?\d+)?)")
SUPPORT = re.compile(r"\)([\d.]+):(-?[\d.]+)")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The host loops issue tiny ops, on which intra-op threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(run_pipeline, fasta, flags, **kw):
    opts = Options(show_progress=False, n_codes=4, **flags)
    opts.derive_settings()
    out, log = io.StringIO(), io.StringIO()
    with open(fasta) as f:
        run_pipeline(opts, f, out, log_fp=log, **kw)
    return out.getvalue(), log.getvalue()


def _topology(newick):
    return LENGTH.sub("", re.sub(r"\)[\d.]+", ")", newick))


@pytest.mark.parametrize("n,p,seed,flags,ll_tol", [
    (24, 200, 5, dict(n_bootstrap=100), 1e-3),
    (20, 180, 3, dict(use_gtr=True, gamma_loglk=True), 1e-2),
    (20, 200, 8, dict(ml_len=True), 1e-3),
], ids=["default", "gtr-gamma", "mllen"])
def test_ml_pipeline_matches_jax(tmp_path, n, p, seed, flags, ll_tol):
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(n, p, seed=seed))
    nw_j, log_j = _run(jax_pipeline.run_pipeline, fasta, flags)
    nw_t, log_t = _run(torch_pipeline.run_pipeline, fasta, flags,
                       device=torch.device("cpu"))
    assert _topology(nw_t) == _topology(nw_j)

    rounds_j, rounds_t = ROUND.findall(log_j), ROUND.findall(log_t)
    assert rounds_j and [r[2] for r in rounds_t] == [r[2] for r in rounds_j]
    for (_, ll_t, _), (_, ll_j, _) in zip(rounds_t, rounds_j):
        assert abs(float(ll_t) - float(ll_j)) <= ll_tol + 1e-9
    assert abs(float(FINAL.findall(log_t)[-1])
               - float(FINAL.findall(log_j)[-1])) <= ll_tol + 1e-9
    if flags.get("gamma_loglk"):
        [(g_t, a_t)], [(g_j, a_j)] = GAMMA.findall(log_t), GAMMA.findall(log_j)
        assert abs(float(g_t) - float(g_j)) <= 1e-2
        assert abs(float(a_t) - float(a_j)) <= 1e-2

    lens_t = [float(x) for x in LENGTH.findall(nw_t)]
    lens_j = [float(x) for x in LENGTH.findall(nw_j)]
    assert len(lens_t) == len(lens_j) == 2 * n - 3
    for a, b in zip(lens_t, lens_j):
        assert abs(a - b) <= 1e-4 + 2e-3 * b
    sup_t, sup_j = SUPPORT.findall(nw_t), SUPPORT.findall(nw_j)
    assert len(sup_t) == len(sup_j) == n - 3
    for (s_t, _), (s_j, len_j) in zip(sup_t, sup_j):
        at_floor = float(len_j) <= 6e-4
        assert abs(float(s_t) - float(s_j)) <= (0.1 if at_floor else 0.02)
