"""The -noml path over NCCL, one rank a card, on the cards of one host.

    python scripts/mesh_cards.py [--hosts]

Needs two or more CUDA cards (--hosts: four, and runs only the last
step).  Builds the kernels once, then:

* for k = 2 and k = min(cards, 4): `-nt -noml` at N=500, P=500 through
  run_pipeline on a k-rank mesh (chip_smoke.py's --mesh-rank processes,
  rank r on cuda:r, NCCL), each rank's Newick byte-identical to the -noml
  JAX golden and its tree without supports to the -nosupport one, its
  store p_pad / k positions wide; prints the wall, the phase split and the
  exchanges' host-clock ms a call (with NCCL the collective's launch);
* the command line a user types, `python -m veryfasttree_tpu_torch -nt
  -noml -nosupport -mesh-sp k aln.fasta` (cli.launch_ranks starts the k
  rank processes), its standard output byte-identical to the golden;
* with four cards, two "hosts" on this machine, each process given two
  cards by CUDA_VISIBLE_DEVICES: `-coordinator 127.0.0.1:port -n-hosts 2
  -host-id I` with -mesh-sp 4, then with -mesh-dp 2 (-mesh-sp defaulting
  to every rank over it: 2 x 2), each host starting one rank a card
  (global ranks 2I and 2I + 1); host 0's standard output byte-identical
  to the golden, host 1's empty.

Prints the card's name and power limit, and exits non-zero if a check
fails.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke as cs  # noqa: E402


def world(k: int, golden: str, noml_golden: str) -> None:
    tmp = tempfile.mkdtemp(prefix="mesh_cards_")
    try:
        t0 = time.perf_counter()
        cs.wait_mesh_worlds(cs.start_mesh_world(k, "nccl", tmp))
        world_s = time.perf_counter() - t0
        recs = []
        for r in range(k):
            with open(os.path.join(tmp, f"mesh_{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    width = -(-500 // 128) * 128 // k
    for r, rec in enumerate(recs):
        if rec["newick"] != noml_golden or rec["nosupport"] != golden:
            raise AssertionError(f"{k} ranks, rank {r}: a Newick differs "
                                 "from the JAX golden")
        if rec["U"][1] != width or rec["device"] != f"cuda:{r}":
            raise AssertionError(f"{k} ranks, rank {r}: {rec['U'][1]} "
                                 f"positions on {rec['device']}")
        cs.require_launched(f"rank {r}", rec["launches"], cs.MESH_PATH)
    main = recs[0]
    ex = main["exchanges"]
    t = {n: round(v, 4) for n, v in main["timings"].items()}
    print(f"{k} ranks over NCCL, -nt -noml N=500: wall {main['wall_s']:.2f} "
          f"s, {t}, {ex['calls']} exchanges, "
          f"{1e3 * ex['s'] / max(ex['calls'], 1):.4f} ms a call (host clock), "
          f"the rank processes {world_s:.1f} s; both Newicks byte-identical "
          f"to the goldens on every rank")
    print(json.dumps({"ranks": k, "wall_s": main["wall_s"],
                      "timings": main["timings"], "exchanges": ex,
                      "world_s": world_s,
                      "launches": {n: main["launches"][n]
                                   for n in cs.MESH_KERNELS}}))


def cli(k: int, golden: str) -> None:
    tmp = tempfile.mkdtemp(prefix="mesh_cards_cli_")
    try:
        fasta = os.path.join(tmp, "aln.fasta")
        with open(fasta, "w") as f:
            f.write(cs.fasta_text(cs.synth_codes(cs.MESH_N, 500, seed=0)))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-noml",
             "-nosupport", "-nopr", "-mesh-sp", str(k), fasta], cwd=REPO,
            capture_output=True, text=True, timeout=cs.MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if res.returncode != 0 or res.stdout != golden:
        raise AssertionError(f"the command line over {k} cards: exit "
                             f"{res.returncode}, Newick equal to the golden "
                             f"{res.stdout == golden}\n{res.stderr[-3000:]}")
    print(f"python -m veryfasttree_tpu_torch -nt -noml -nosupport -mesh-sp "
          f"{k}: {wall:.2f} s from start to end, the golden byte for byte")


def hosts(golden: str, flags) -> None:
    import socket

    tmp = tempfile.mkdtemp(prefix="mesh_cards_hosts_")
    try:
        fasta = os.path.join(tmp, "aln.fasta")
        with open(fasta, "w") as f:
            f.write(cs.fasta_text(cs.synth_codes(cs.MESH_N, 500, seed=0)))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{sock.getsockname()[1]}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "veryfasttree_tpu_torch", "-nt", "-noml",
             "-nosupport", "-nopr", *flags, "-coordinator", address,
             "-n-hosts", "2", "-host-id", str(h), fasta], cwd=REPO,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=cards),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for h, cards in enumerate(("0,1", "2,3"))]
        try:
            outs = [p.communicate(timeout=cs.MESH_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.returncode for p in procs]
    if codes != [0, 0] or outs[0][0] != golden or outs[1][0] != "":
        raise AssertionError(
            f"two hosts of two cards, {' '.join(flags)}: exits {codes}, host "
            f"0's Newick equal to the golden {outs[0][0] == golden}, host 1 "
            f"printed {len(outs[1][0])} characters\n"
            + "\n".join(err[-2000:] for _, err in outs))
    print(f"-coordinator -n-hosts 2 {' '.join(flags)}, two hosts of two "
          f"cards (CUDA_VISIBLE_DEVICES 0,1 and 2,3; four ranks): {wall:.2f} "
          "s from start to end, host 0's tree the golden byte for byte, host "
          "1 silent")


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print("mesh_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    from veryfasttree_tpu_torch.ops import _build

    print(cs.card_line())
    t0 = time.perf_counter()
    _build.build()          # once, before any rank starts
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    with open(cs.GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(cs.NOML_GOLDEN + ".nwk") as f:
        noml_golden = f.read()
    only_hosts = sys.argv[1:] == ["--hosts"]
    if only_hosts and n < 4:
        print("mesh_cards --hosts: needs four CUDA cards", file=sys.stderr)
        return 2
    if not only_hosts:
        for k in sorted({2, min(n, 4)}):
            world(k, golden, noml_golden)
        cli(min(n, 4), golden)
    if n >= 4:
        for flags in (["-mesh-sp", "4"], ["-mesh-dp", "2"]):
            hosts(golden, flags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
