"""Time the port's kernel build file by file (GPU host with nvcc only).

    python scripts/time_kernel_build.py

Compiles every `veryfasttree_tpu_torch/csrc/*.cu` with the flags of
`ops/_build.py`, all at once as the build does, into a directory of its
own under `build/`, and prints each file's seconds from the common start
to its end, slowest first, and the wall of the whole.  The library the
port loads is not touched.
"""
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from veryfasttree_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    out = os.path.join(REPO, "build", "time_kernel_build")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    nvcc = _build._nvcc()
    srcs = [s for s in _build._sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    procs = {s.name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(s.name, []),
         "-c", "-o", os.path.join(out, s.stem + ".o"), str(s)],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT) for s in srcs}
    secs, rc = {}, 0
    while len(secs) < len(procs):
        for name, p in procs.items():
            if name not in secs and p.poll() is not None:
                secs[name] = time.perf_counter() - t0
                rc |= p.returncode
        time.sleep(0.05)
    for name, s in sorted(secs.items(), key=lambda kv: -kv[1]):
        print(f"nvcc {name}: {s:.1f} s"
              f"{'' if procs[name].returncode == 0 else ' (failed)'}")
    print(f"all {len(srcs)} files at once: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
