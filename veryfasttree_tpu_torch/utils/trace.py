"""torch.profiler traces of a run (counterpart of
``veryfasttree_tpu/utils/trace.py``, which wraps the run in
``jax.profiler.trace``).

Set ``VFT_TRACE=/path/to/dir`` to write a Chrome trace of the whole
``run_pipeline`` call, CPU and CUDA activity, into that directory
(``trace_<pid>_<n>.json``, viewable in Perfetto or chrome://tracing).  The
pipeline's phases name themselves with ``record_function`` under the names
of their ``nj.timings`` entries less ``_s`` (store, tophits, joins, nni,
spr, lengths, splits, boot, ml_lengths, ml_nni, cat, gtr, sh, gamma), so
that kernel time groups by phase.  Without ``VFT_TRACE`` no profiler starts
and both context managers do nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import os

_traces = itertools.count()


@contextlib.contextmanager
def maybe_trace():
    """Wrap the block in torch.profiler when VFT_TRACE is set; the trace
    file is written when the block ends, whether it ends by an exception
    or not."""
    trace_dir = os.environ.get("VFT_TRACE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_{os.getpid()}_{next(_traces)}.json")
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """Name a pipeline phase in the trace (nothing without VFT_TRACE)."""
    if not os.environ.get("VFT_TRACE"):
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
