"""The multi-GPU port's CPU runs, shared by tests/test_torch_mesh_*.py and
scripts/make_torch_port_mesh_cpu_golden.py: the inputs (the JAX package's
multi-chip dry-run alignment, __graft_entry__.py:70-80, and a small
protein one), the -noml configurations, and the rank processes: a world
of gloo ranks on the CPU, one process each (``python
tests/torch_mesh_runs.py rank ...``), which build each asked-for mesh in
turn, run each configuration through the port's run_pipeline and write
what they saw as JSON.
"""
from __future__ import annotations

import io
import json
import os
import random
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_mesh_cpu_golden.json")

# each configuration: its input and the Options fields of its command line
# ("nt": the dry run's alignment; the option cases take the first 24 of
# its sequences, "nt24", and a small protein alignment, "aa": each of their
# exchanges costs about 2.5 ms on the CPU's gloo)
CONFIGS = {
    "noml_nosupport": ("nt", dict(n_codes=4, n_bootstrap=0)),       # -nt -noml -nosupport
    "noml": ("nt", dict(n_codes=4, n_bootstrap=1000)),              # -nt -noml
    "two_tier": ("nt24", dict(n_codes=4, n_bootstrap=0, two_tier_min=0)),
    "fastest": ("nt24", dict(n_codes=4, n_bootstrap=0, fastest=True,
                             tophits_refresh=0.5, use_tophits_2nd=True)),
    "bionj": ("nt24", dict(n_codes=4, n_bootstrap=0, bionj=True)),
    "protein": ("aa", dict(n_codes=20, n_bootstrap=100)),           # -noml, BLOSUM45
}


def _founder_fasta(n, p, seed, alpha, rate):
    rng = random.Random(seed)
    founder = [rng.choice(alpha) for _ in range(p)]
    seqs = [founder]
    while len(seqs) < n:
        parent = seqs[rng.randrange(len(seqs))]
        seqs.append([c if rng.random() > rate else rng.choice(alpha)
                     for c in parent])
    return "".join(f">s{i}\n{''.join(s)}\n" for i, s in enumerate(seqs))


def fasta(kind: str) -> str:
    """'nt': the dry run's N=40, P=200 founder alignment (seed 7); 'nt24':
    its first 24 sequences; 'aa': a protein one of N=30, P=120 (seed 11)."""
    if kind in ("nt", "nt24"):
        return _founder_fasta(40 if kind == "nt" else 24, 200, 7, "ACGT", 0.12)
    return _founder_fasta(30, 120, 11, "ACDEFGHIKLMNPQRSTVWY", 0.15)


def key(name: str) -> str:
    """The SHA-256 of a configuration's input and fields (the golden's
    record of what it ran)."""
    import hashlib

    kind, fields = CONFIGS[name]
    return hashlib.sha256((fasta(kind) + json.dumps(
        fields, sort_keys=True)).encode()).hexdigest()


def options(name: str, options_cls, **extra):
    """The Options (the port's or the JAX package's class) of a
    configuration, derived."""
    _, fields = CONFIGS[name]
    opts = options_cls(show_progress=False, ml_nni=0, seed=1,
                       **{**fields, **extra})
    opts.derive_settings()
    return opts


def run_port(name: str, device="cpu", mesh=None):
    """(newick, nj) of the port's run_pipeline on a configuration."""
    import torch

    from veryfasttree_tpu_torch.options import Options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    opts = options(name, Options)
    opts.mesh = mesh
    out = io.StringIO()
    nj, _ = run_pipeline(opts, io.StringIO(fasta(CONFIGS[name][0])), out,
                         device=torch.device(device))
    return out.getvalue(), nj


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def start_world(world: int, plan, out_dir: str):
    """Start `world` gloo rank processes; plan: [[dp, sp, [config, ...]],
    ...], each mesh in turn over the whole world.  Returns the
    processes."""
    address = free_address()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "rank", str(r),
         str(world), address, out_dir, json.dumps(plan)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def finish_world(procs, timeout=240):
    """Wait for a world's ranks (killing them all past the timeout);
    raise with the first failure's output."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{err[-3000:]}")


def result(out_dir, dp, sp, name, rank):
    with open(os.path.join(out_dir, f"{dp}x{sp}_{name}_{rank}.json")) as f:
        return json.load(f)


def rank_main(rank, world, address, out_dir, plan) -> int:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from veryfasttree_tpu_torch.parallel import make_mesh, multihost

    multihost.init_ranks(address, world, rank, torch.device("cpu"))
    for dp, sp, names in plan:
        mesh = make_mesh(n_sp=sp, n_dp=dp)
        for name in names:
            t0 = time.perf_counter()
            newick, nj = run_port(name, mesh=mesh)
            prof = nj.prof
            rec = {"newick": newick, "U": list(prof.U.shape),
                   "W": list(prof.W.shape), "codes": list(prof.codes.shape),
                   "lo": prof.lo, "n_local": prof.n_local,
                   "n_pos": prof.n_pos, "two_tier": prof.two_tier,
                   "mesh": [mesh.dp_index, mesh.sp_index],
                   "exchanges": dict(mesh.stats),
                   "seconds": time.perf_counter() - t0}
            with open(os.path.join(out_dir, f"{dp}x{sp}_{name}_{rank}.json"),
                      "w") as f:
                json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


# ------------------------------------------------ parallel/sharded.py runs
SHARDED_SHAPES = [(1, 4), (2, 2), (4, 1)]       # (dp, sp)


def sharded_inputs(seed=0, M=16, P=512, C=4):
    """The inputs of tests/test_sharded.py's checks (its _data and the
    scan's out-distances, the JC tables), float64 arrays of float32
    values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    V = rng.dirichlet(np.ones(C), size=(M, P)).astype(np.float32)
    W = rng.uniform(0.3, 1.0, size=(M, P)).astype(np.float32)
    U = (W[..., None] * V).astype(np.float64)
    f2 = rng.dirichlet(np.ones(C), size=P)
    return {"U": U, "W": W.astype(np.float64),
            "outd": rng.uniform(0, 2, M), "f2": f2,
            "w2": rng.uniform(0.0, 1.0, P).round(),
            "psame": np.array([0.7, 0.55]), "pdiff": np.array([0.1, 0.15]),
            "ratecat": rng.integers(0, 2, P).astype(np.int32),
            "mask_pos": rng.uniform(size=P) < 0.9,
            "mask_rows": rng.uniform(size=M) < 0.7}


def sharded_main(rank, world, address, out_dir) -> int:
    """Each function of parallel/sharded.py on each SHARDED_SHAPES mesh,
    on this rank's shards of sharded_inputs(): rows split on dp, positions
    on sp; the outputs into sharded_{dp}x{sp}_{rank}.npz."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from veryfasttree_tpu_torch.parallel import make_mesh, multihost, sharded

    multihost.init_ranks(address, world, rank, torch.device("cpu"))
    x = {k: torch.as_tensor(v) for k, v in sharded_inputs().items()}
    M, P, _ = x["U"].shape
    for dp, sp in SHARDED_SHAPES:
        mesh = make_mesh(n_sp=sp, n_dp=dp)
        m, w = M // dp, P // sp
        rows = slice(mesh.dp_index * m, (mesh.dp_index + 1) * m)
        pos = slice(mesh.sp_index * w, (mesh.sp_index + 1) * w)
        U, W = x["U"][rows, pos].float(), x["W"][rows, pos].float()
        uq, wq = x["U"][3, pos], x["W"][3, pos]
        outd = x["outd"][rows]
        best, crit, dist, denom = sharded.dist_scan_sharded(mesh, False)(
            U, W, uq, wq, outd, M)
        f1, f2 = x["U"][3, pos] / x["W"][3, pos, None], x["f2"][pos]
        ll = sharded.pair_loglk_sharded(mesh)(
            f1, f2, x["W"][3, pos], x["w2"][pos], x["psame"], x["pdiff"],
            x["ratecat"][pos], x["mask_pos"][pos])
        w_post, f_post = sharded.posterior_jc_sharded(mesh)(
            f1, f2, x["W"][3, pos], x["w2"][pos], x["psame"], x["pdiff"],
            x["psame"], x["pdiff"], x["ratecat"][pos])
        w_out, f_out = sharded.out_profile_sharded(mesh)(
            x["U"][rows, pos], x["W"][rows, pos], x["mask_rows"][rows])
        t_best, t_crit, u_new, w_new, t_ll = sharded.training_step(mesh)(
            U, W, uq, wq, outd, M, x["psame"], x["pdiff"], x["ratecat"][pos],
            x["mask_pos"][pos])
        np.savez(os.path.join(out_dir, f"sharded_{dp}x{sp}_{rank}.npz"),
                 best=best.numpy(), crit=crit.numpy(), dist=dist.numpy(),
                 denom=denom.numpy(), ll=ll.numpy(), w_post=w_post.numpy(),
                 f_post=f_post.numpy(), w_out=w_out.numpy(),
                 f_out=f_out.numpy(), t_best=t_best.numpy(),
                 t_crit=t_crit.numpy(), u_new=u_new.numpy(),
                 w_new=w_new.numpy(), t_ll=t_ll.numpy(),
                 stats=np.array([mesh.stats["calls"]]))
        # Mesh.exchange's all_gather branch (the one NCCL takes), run over
        # this gloo group, beside its isend/irecv branch
        part = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10 * rank
        got = {}
        for axis in ("sp", "dp"):
            got[f"send_{axis}"] = mesh.exchange(part, axis).numpy()
            mesh.backend = "nccl"
            got[f"gather_{axis}"] = mesh.exchange(part, axis).numpy()
            mesh.backend = "gloo"
        np.savez(os.path.join(out_dir, f"exchange_{dp}x{sp}_{rank}.npz"),
                 **got)
    torch.distributed.destroy_process_group()
    return 0


def start_sharded(world, out_dir):
    address = free_address()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "sharded", str(r),
         str(world), address, out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


if __name__ == "__main__":
    a = sys.argv[2:]
    if sys.argv[1] == "rank":
        sys.exit(rank_main(int(a[0]), int(a[1]), a[2], a[3], json.loads(a[4])))
    if sys.argv[1] == "sharded":
        sys.exit(sharded_main(int(a[0]), int(a[1]), a[2], a[3]))


def load_golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def same_tree(a: str, b: str, tol: float) -> bool:
    """Two Newicks with the same text but for their numbers, each number
    within tol of the other's."""
    import re

    num = re.compile(r"-?\d+\.\d+")
    if num.sub("#", a) != num.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= tol
               for x, y in zip(num.findall(a), num.findall(b)))


# The unsharded port's protein Newick differs from the JAX package's in
# the last printed digit of one branch length on this input (the port's
# 0.14428 against 0.14427), not a mesh matter; its tree and supports are
# the same.  Traced to the NJ phase's first join, whose matrix-mode
# normalizing total the JAX package rounds as its XLA program around the
# dot does (a departure of the reference: ROADMAP.md, pinned by
# tests/test_torch_jax_departures.py).  The mesh is held to the unsharded
# port byte for byte, the unsharded port to the JAX package within one
# unit of the fifth decimal.
JAX_TOL = {"protein": 1.01e-5}


def check_runs(out_dir, dp, sp, name, single, golden) -> None:
    """Every rank's Newick the unsharded port's (byte for byte), that the
    JAX package's golden (byte for byte, or within JAX_TOL), and every
    rank's store its block of positions: p_pad / sp wide, from position
    s * width."""
    assert golden[name]["key"] == key(name), \
        "the golden is out of date: scripts/make_torch_port_mesh_cpu_golden.py"
    tol = JAX_TOL.get(name)
    if tol is None:
        assert single == golden[name]["newick"], "port differs from JAX"
    else:
        assert same_tree(single, golden[name]["newick"], tol)
    for rank in range(dp * sp):
        rec = result(out_dir, dp, sp, name, rank)
        assert rec["newick"] == single, f"rank {rank}"
        d, s = rec["mesh"]
        assert (d, s) == divmod(rank, sp)
        p_pad = -(-rec["n_pos"] // 128) * 128
        width = -(-(p_pad // sp) // 16) * 16
        assert rec["codes"][1] == rec["W"][1] == rec["U"][1] == width
        assert rec["lo"] == s * width
        assert rec["n_local"] == max(0, min(width, rec["n_pos"] - s * width))
        assert rec["exchanges"]["calls"] > 0


def run_worlds(worlds, out_dir, names):
    """Start the worlds ({world: plan}), run the unsharded port's `names`
    here meanwhile (one torch thread), wait for the worlds.  Returns the
    unsharded Newicks by name."""
    import torch

    procs = [start_world(w, plan, out_dir) for w, plan in worlds]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {name: run_port(name)[0] for name in names}
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            finish_world(p)
    return single
