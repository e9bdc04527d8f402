#!/usr/bin/env python3
"""Where the time of the PyTorch port's main paths goes.

    python scripts/profile_torch_port.py          # -nt -noml -nosupport
    python scripts/profile_torch_port.py --ml     # the default -nt run
    python scripts/profile_torch_port.py --fastest  # -nt -noml -nosupport
                                                    # -fastest (the host join
                                                    # loop's fused step)

On the cells of chip_smoke.py (chip_smoke.synth_codes, N=2000, P=500,
seed 0) it prints:

1. a cold and a warm run's wall and phase split (``nj.timings``);
2. cProfile of a third run: the top functions by own time and by
   cumulative time (cProfile slows the host loops, so these shares are of
   a distorted wall);
3. torch.profiler (device activity only) of one smaller run, small enough
   for the trace to hold every event (N=500 for -noml, N=200 for the ML
   run): the device's busy share of that run's wall, and each kernel's
   count and total time.  Every kernel on the card is traced, those
   launched through ctypes included.

Run it from the repository root on a machine with a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import io
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ml", action="store_true",
                        help="profile the default -nt run (ML phase) "
                        "instead of -nt -noml -nosupport")
    parser.add_argument("--fastest", action="store_true",
                        help="profile -nt -noml -nosupport -fastest, whose "
                        "joins take the host loop's fused join step")
    args = parser.parse_args()
    for sub in ("", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MAIN_N, MAIN_P, fasta_text, run_port, synth_codes

    dev = torch.device("cuda")
    torch.use_deterministic_algorithms(True)
    fasta = fasta_text(synth_codes(MAIN_N, MAIN_P))
    traced_n = 200 if args.ml else 500

    def run(text):
        if not args.ml:
            return run_port(text, dev, fastest=args.fastest)
        from veryfasttree_tpu_torch.options import ml_options
        from veryfasttree_tpu_torch.pipeline import run_pipeline

        out = io.StringIO()
        t0 = time.perf_counter()
        nj, _ = run_pipeline(ml_options(), io.StringIO(text), out,
                             device=dev)
        torch.cuda.synchronize()
        return out.getvalue(), nj, time.perf_counter() - t0

    def phases(label, nj, wall):
        split = ", ".join(f"{k} {v:.3f}" for k, v in nj.timings.items())
        print(f"{label} N={MAIN_N}: wall {wall:.3f} s; {split}", flush=True)

    for label in ("cold", "warm"):
        _, nj, wall = run(fasta)
        phases(label, nj, wall)

    prof = cProfile.Profile()
    prof.enable()
    _, nj, wall = run(fasta)
    prof.disable()
    phases("under cProfile", nj, wall)
    stats = pstats.Stats(prof, stream=sys.stdout)
    stats.sort_stats("tottime").print_stats(35)
    stats.sort_stats("cumulative").print_stats(45)

    small = fasta_text(synth_codes(traced_n, MAIN_P))
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        run(small)
        wall = time.perf_counter() - t0
    count, total = collections.Counter(), collections.Counter()
    for evt in trace.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            count[evt.name] += 1
            total[evt.name] += evt.time_range.elapsed_us()
    busy = sum(total.values()) / 1e6
    print(f"torch.profiler N={traced_n}: wall {wall:.3f} s, device "
          f"busy {busy:.4f} s ({100 * busy / wall:.2f}%) in "
          f"{sum(count.values())} device events")
    for name, us in total.most_common(15):
        print(f"  {us / 1e3:10.3f} ms  {count[name]:8d} x "
              f"{us / count[name]:8.3f} us  {name[:100]}")


if __name__ == "__main__":
    main()
