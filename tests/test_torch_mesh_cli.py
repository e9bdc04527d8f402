"""The PyTorch port's command line across ranks on the CPU (gloo): two
processes joined by -coordinator (two hosts of one rank each: a CPU
process is one rank), and the single command -mesh-sp 2 that starts its
two ranks itself; only rank 0 writes the tree, which is the
single-process run's.  The rank plan of -coordinator -n-hosts K -host-id
I (parallel.multihost.rank_plan) for hosts of 1, 2 and 4 cards.  Under a mesh the parts not ported yet raise
NotImplementedError, and the mesh flags without a process group raise:
nothing falls back to one card."""
import io
import os
import subprocess
import sys

import pytest
import torch

import torch_mesh_runs as runs

from veryfasttree_tpu_torch.options import Options
from veryfasttree_tpu_torch.parallel import multihost
from veryfasttree_tpu_torch.parallel.mesh import Mesh
from veryfasttree_tpu_torch.pipeline import run_pipeline

MAIN = ("import sys; from veryfasttree_tpu_torch.cli import main; "
        "sys.exit(main(sys.argv[1:], device='cpu'))")
ARGV = ["-nt", "-noml", "-nosupport", "-nopr", "-quiet"]


def _cli(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", MAIN, *args], cwd=runs.REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs_done(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    fasta = tmp / "aln.fasta"
    fasta.write_text(runs.fasta("nt24"))
    address = runs.free_address()
    out0 = tmp / "tree0.nwk"
    ranks = [_cli([*ARGV, "-mesh-sp", "2", "-coordinator", address,
                   "-n-hosts", "2", "-host-id", str(i), "-out", str(out0),
                   str(fasta)]) for i in range(2)]
    local = _cli([*ARGV, "-mesh-sp", "2", str(fasta)])
    single = _cli([*ARGV, str(fasta)])
    return {"ranks": [_done(p) for p in ranks], "local": _done(local),
            "single": _done(single), "out0": out0, "tmp": tmp}


def test_coordinator_ranks_write_once(runs_done):
    """-coordinator: rank 0 alone writes -out, which is the single
    process's tree; neither rank prints a tree."""
    assert runs_done["ranks"] == ["", ""]
    assert runs_done["single"].count(";") == 1
    assert runs_done["out0"].read_text() == runs_done["single"]
    assert sorted(p.name for p in runs_done["tmp"].iterdir()) == \
        ["aln.fasta", "tree0.nwk"]


def test_local_launch_prints_once(runs_done):
    """-mesh-sp 2 without -coordinator starts two ranks: one tree on
    standard output, the single process's."""
    assert runs_done["local"] == runs_done["single"]


@pytest.mark.parametrize("field,value", [
    ("ml_nni", -1), ("ml_len", True), ("threads", 2),
    ("constraints_file", "c.fasta"), ("make_matrix", True),
    ("checkpoint_file", "ck.npz")],
    ids=["ml", "mllen", "threads", "constraints", "makematrix",
         "checkpoint"])
def test_unported_under_mesh_raises(field, value):
    opts = Options(show_progress=False, n_codes=4, ml_nni=0)
    setattr(opts, field, value)
    opts.derive_settings()
    opts.mesh = Mesh(1, 2, 0, None, None)
    with pytest.raises(NotImplementedError, match="under a mesh"):
        run_pipeline(opts, io.StringIO(runs.fasta("nt24")), io.StringIO(),
                     device=torch.device("cpu"))


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_rank_plan(cards):
    """-coordinator -n-hosts K -host-id I counts hosts, as the JAX
    package's does: each host starts one rank a card, global rank I x
    cards + local rank on card `local`; a default -mesh-sp spans every rank
    over -mesh-dp; a mesh that does not fill the world raises; without
    mesh flags every rank runs alone."""
    for host in range(2):
        plan = multihost.rank_plan(2, host, cards, None, 1)
        assert plan.world == 2 * cards and plan.mesh is None
        assert plan.ranks == tuple(range(host * cards, (host + 1) * cards))
        assert plan.devices == tuple(range(cards))
    assert multihost.rank_plan(2, 1, cards, 2 * cards, 1).mesh == \
        (1, 2 * cards)
    if cards > 1:
        assert multihost.rank_plan(2, 0, cards, None, 2).mesh == (2, cards)
    assert multihost.rank_plan(3, 2, cards, None, 3).mesh == (3, cards)
    with pytest.raises(ValueError, match="make"):
        multihost.rank_plan(2, 0, cards, 2 * cards + 1, 1)
    with pytest.raises(ValueError, match="make"):
        multihost.rank_plan(2, 0, cards, cards, 1)
    with pytest.raises(ValueError, match="-host-id"):
        multihost.rank_plan(2, 2, cards)
    # the JAX package's two-host command on two 4-card hosts: 2 x 4 ranks
    plan = multihost.rank_plan(2, 1, 4, None, 2)
    assert plan.world == 8 and plan.ranks == (4, 5, 6, 7) and \
        plan.mesh == (2, 4)


def test_cpu_process_is_one_rank():
    """On the CPU a process is one rank (a JAX CPU process has one
    device), and a card the caller names is one rank too."""
    assert multihost.host_cards(torch.device("cpu")) == 1
    assert multihost.host_cards(torch.device("cuda", 1)) == 1


def test_mesh_flags_need_the_ranks():
    """-mesh-sp 2 with no process group raises instead of running on one
    device."""
    opts = Options(show_progress=False, n_codes=4, ml_nni=0, mesh_sp=2)
    opts.derive_settings()
    with pytest.raises(RuntimeError, match="process group"):
        run_pipeline(opts, io.StringIO(runs.fasta("nt24")), io.StringIO(),
                     device=torch.device("cpu"))


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_replication_is_logged_once(rank):
    """-mesh-dp 2 replicates the store on both dp ranks (no row split yet):
    rank 0 says so in the log, rank 1 says nothing, and the tree is the
    single run's.  A 2 x 1 mesh exchanges nothing along sp, so it runs in
    this process."""
    def run(mesh):
        opts = Options(show_progress=False, n_codes=4, ml_nni=0,
                       n_bootstrap=0)
        opts.derive_settings()
        opts.mesh = mesh
        out, log = io.StringIO(), io.StringIO()
        run_pipeline(opts, io.StringIO(runs.fasta("nt24")), out, log_fp=log,
                     device=torch.device("cpu"))
        return out.getvalue(), log.getvalue()

    tree, log = run(Mesh(2, 1, rank, None, None))
    assert tree == run(None)[0]
    assert log.count("-mesh-dp 2 replicates") == (1 if rank == 0 else 0)
