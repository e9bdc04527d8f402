#!/usr/bin/env python3
"""Where the whole-tree ML kernels spend their cycles: a second build of
csrc/ml_sweep.cu with -DVFT_SWEEP_PROBE (clock64 probes, thread 0 of each
block; the library the port loads has none) into
build/whole_tree_probe/, run through the port's wrappers on
chip_smoke.py's trees at CAT 20:

    python scripts/profile_whole_tree.py

the caterpillar of DEEP_N leaves (Jukes-Cantor), the port's N=MAIN_N NJ
tree (Jukes-Cantor, the categories drawn from seed 0) and the balanced
tree of MAIN_N leaves at 20 codes (JTT, -approxml's gate on).  For each,
after one warm-up call, one ml_posterior_sweep and one ml_tree_loglk with
per-site sums: the cycles of every phase summed over the blocks (thread 0
of each), and for the sweep the cycles per item a block walked.  The
probes cost a few cycles a mark, so the phases' sum runs a little above
the plain build's time.

Run it from a repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# csrc/ml_sweep.cu's SweepPhase, in order
PHASES = ("unit", "window", "prefetch", "wait", "entries", "posterior", "store",
          "publish", "items", "root", "pairs", "group wait", "groups",
          "final wait", "final")
ENTRIES = ("vft_ml_posterior_sweep_grid", "vft_ml_posterior_sweep_units",
           "vft_ml_posterior_sweep_flags", "vft_ml_tree_loglk_units",
           "vft_ml_tree_loglk_group_rows", "vft_ml_tree_loglk_scratch_bytes",
           "vft_ml_posterior_sweep_f32", "vft_ml_tree_loglk_f32")


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as s
    from veryfasttree_tpu_torch.engine import ml as eml
    from veryfasttree_tpu_torch.ops import _build
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    main_lib = _build.library()
    out_dir = os.path.join(REPO, "build", "whole_tree_probe")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libvft_whole_tree_probe.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    *_build.SOURCE_FLAGS.get("ml_sweep.cu", []),
                    "-DVFT_SWEEP_PROBE", "-shared", "-o", path,
                    str(_build.SRC_DIR / "ml_sweep.cu")],
                   check=True, capture_output=True, text=True)
    probe = ctypes.CDLL(path)
    for name in ENTRIES:
        fn, ref = getattr(probe, name), getattr(main_lib, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    probe.vft_ml_sweep_probe.argtypes = [ctypes.c_void_p]
    probe.vft_ml_sweep_probe.restype = ctypes.c_int

    class Lib:
        def __getattr__(self, name):
            return getattr(probe if name in ENTRIES else main_lib, name)

    def read():
        buf = (ctypes.c_ulonglong * len(PHASES))()
        torch.cuda.synchronize()
        rc = probe.vft_ml_sweep_probe(buf)
        if rc:
            raise RuntimeError(f"vft_ml_sweep_probe: {rc}")
        return dict(zip(PHASES, buf))

    dev = torch.device("cuda")

    def cat20(nj):
        rng = np.random.default_rng(0)
        nj.ml.set_rates(eml.ml_site_rates(s.CAT_N),
                        rng.integers(0, s.CAT_N, nj.n_pos).astype(np.int32))
        nj.ml.recompute_ml_profiles()
        return nj

    starts = {
        "caterpillar": lambda: s.shaped_start(s.DEEP_N, dev, "caterpillar",
                                              "jc"),
        "nj": lambda: cat20(s.ml_start(s.MAIN_N, dev, "jc")),
        "balanced<20>": lambda: s.shaped_start(s.MAIN_N, dev, "balanced",
                                               "jtt", approx=True),
    }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for label, make in starts.items():
        nj = make()
        store = nj.ml._store()
        sw = nj.ml.tree_sweep()
        ch = sw.posteriors.chains
        _build._lib = Lib()
        try:
            for what, fn in (
                    ("sweep", lambda: mk.ml_posterior_sweep(*store,
                                                            sw.posteriors)),
                    ("loglk", lambda: mk.ml_tree_loglk(*store, sw.loglk,
                                                       True))):
                fn()
                read()
                fn()
                cyc = read()
                busy = {k: v for k, v in cyc.items() if v and k != "items"}
                line = ", ".join(f"{k} {v}" for k, v in busy.items())
                if what == "sweep":
                    n = max(cyc["items"], 1)
                    line += "; per item walked: " + ", ".join(
                        f"{k} {v / n:.0f}" for k, v in busy.items()
                        if k != "unit")
                    line = (f"{sw.posteriors.n_items} items, {ch.n_chains} "
                            f"chains (longest {int(np.diff(ch.starts).max())}"
                            f"), {cyc['items']} items walked; " + line)
                print(f"{label} {what}: {line}", flush=True)
        finally:
            _build._lib = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
