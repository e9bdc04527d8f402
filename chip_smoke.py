#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script exits 0 only when all
passed):

0. the card (nvidia-smi name and power limit), torch's CUDA version;
1. build the CUDA kernels from veryfasttree_tpu_torch/csrc;
2. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with the median time of 50 runs of each (CUDA events):
   the scans and the pair distances in double (rtol 1e-12, atol 1e-12; best
   index equal), the profile average bit-identical (rtol 1e-6 in BLOSUM45
   matrix mode);
3. the -noml pipeline at N=500, P=500 against the JAX package's tree
   (tests/data/torch_port_golden_n500_p500.nwk), dense and two-tier: RF 0
   to the golden, and the two layouts give the same Newick; then the same
   input through the command line (python -m veryfasttree_tpu_torch -nt
   -noml -nosupport), RF 0 to the golden;
4. the main path: full -nt -noml -nosupport at N=2000, P=500 (the bench.py
   input) through run_pipeline, cold, then warm, then once more with the
   two-tier store forced on (-two-tier-min 0), which must give the same
   tree.  The kernel launch counts are reset just before the warm run and
   read just after it: these are the main path's launches, and each kernel
   of the dense path must have launched.  The codes scan runs only in the
   two-tier store (N >= 20000, or -two-tier-min 0), so its launches are
   counted apart, in the two-tier run, and must be nonzero there.

The last lines are the card's name and power limit, one JSON line with each
kernel's route, source, main-path launches (two-tier launches apart),
error and times, and the result line.  Without a CUDA device, or outside
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden_n500_p500")
MAIN_N, MAIN_P = 2000, 500          # bench.py's input

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
}
TOL = dict(rtol=1e-12, atol=1e-12)
BEST = 100                      # the row the scan inputs make the best


def TWINS(n):
    """Exact duplicates of row BEST: two in range, one past m_real."""
    return n // 2, 3 * n // 4, n - 10


def wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from veryfasttree_tpu_torch.ops import scan_kernels, store_kernels

    return {"nj_scan_dense": scan_kernels.nj_scan_dense,
            "nj_scan_codes": scan_kernels.nj_scan_codes,
            "me_dists": store_kernels.me_dists,
            "me_average": store_kernels.me_average}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


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
    return err, median_ms(lambda: st.me_dists(*nni)), \
        median_ms(lambda: st.me_dists_ref(*nni))


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
    return err, median_ms(lambda: st.me_average(*one)), \
        median_ms(lambda: st.me_average_ref(*one))


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
    return int(got[0]), err, median_ms(lambda: kernel(*args)), \
        median_ms(lambda: twin(*args))


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
    def record(name, err, ms, plain_ms):
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if "ms" not in entry:         # the first case is the main path's shape
            entry["ms"], entry["plain_ms"] = ms, plain_ms

    for name, shape, kernel, twin, args in cases:
        best, err, ms, plain_ms = check_kernel(name, kernel, twin, args)
        print(f"  {name} [{shape}]: best {best} (tie, lowest index), max abs "
              f"err {err:.3e}, kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
        record(name, err, ms, plain_ms)
    for name, check in (("me_dists", check_dists),
                        ("me_average", check_average)):
        for C, use_matrix, leaf_rows, label in (
                (4, False, 0, "dense 8192x512 C=4"),
                (4, False, 2000, "two-tier 2000 leaves C=4"),
                (20, True, 0, "dense 8192x512 C=20 BLOSUM45")):
            err, ms, plain_ms = check(label, C, use_matrix, leaf_rows, gen,
                                      dev)
            print(f"  {name} [{label}]: max abs err {err:.3e}, kernel "
                  f"{ms:.4f} ms, twin {plain_ms:.4f} ms")
            record(name, err, ms, plain_ms)


# ------------------------------------------------------------- phases 3, 4
def fasta_text(codes) -> str:
    """The alignment as FASTA text, names s0 .. s{N-1} (as bench.py)."""
    from bench_e2e import ALPHA

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


DENSE_PATH = ("nj_scan_dense", "me_dists", "me_average")


def phase_golden(dev):
    from bench_e2e import synth_codes
    from util import rf_distance

    with open(GOLDEN + ".nwk") as f:
        golden = f.read()
    with open(GOLDEN + ".json") as f:
        golden_len = json.load(f)["total_len"]
    fasta = fasta_text(synth_codes(500, 500, seed=0))
    trees = {}
    for label, overrides, needed in (("dense", {}, DENSE_PATH),
                                     ("two-tier", {"two_tier_min": 0},
                                      tuple(KERNELS))):
        nw, nj, wall, counts = counted_run(fasta, dev, **overrides)
        rf, n_splits = rf_distance(nw, golden)
        print(f"  N=500 {label}: {wall:.2f} s, RF {rf}/{n_splits} to the JAX "
              f"golden, byte-identical {nw == golden}, tree length "
              f"{nj.total_len():.6f} (golden {golden_len:.6f}), launches "
              f"{counts}")
        if rf != 0:
            raise AssertionError(f"{label}: RF {rf} to the golden tree")
        require_launched(label, counts, needed)
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
    from bench_e2e import synth_codes
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
              f"NNI+SPR {t['nni_spr_s']:.3f} s, lengths {t['lengths_s']:.3f} "
              f"s, split test {t['splits_s']:.3f} s; tree length "
              f"{length:.6f}; launches {counts}")
        _, leaves = newick_splits(nw)
        if len(leaves) != n or not math.isfinite(length):
            raise AssertionError(f"{label}: {len(leaves)} leaves, length "
                                 f"{length}")
        runs[label] = nw
        if label == "warm":                  # the main path's run
            require_launched(label, counts, DENSE_PATH)
            for name, count in counts.items():
                report.setdefault(name, {})["launches"] = count
        elif label == "two-tier":
            require_launched(label, counts, ("nj_scan_codes",))
            report["nj_scan_codes"]["two_tier_launches"] = \
                counts["nj_scan_codes"]
    if runs["two-tier"] != runs["cold"] or runs["warm"] != runs["cold"]:
        raise AssertionError("the three runs gave different trees")


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
        path, log = _build.build()
        print(f"  built {os.path.relpath(path, REPO)} in "
              f"{time.perf_counter() - t0:.1f} s")
        print("\n".join("  " + line for line in log.splitlines()
                        if "registers" in line or "Function properties" in line
                        or "Compiling entry" in line))
        _build.library()

    phase("0 card", card)
    phase("1 build", build)
    if "1 build" not in failed:
        phase("2 kernels vs twins", phase_kernels, report)
        cuda = torch.device("cuda")
        phase("3 N=500 vs JAX golden", phase_golden, cuda)
        phase(f"4 main path N={MAIN_N}", phase_main, report, cuda)
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
