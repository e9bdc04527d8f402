"""Bootstrap column counts of the SH-like supports: the CUDA kernel of
``csrc/sh_resample.cu`` and its plain twin.

``sh_resample_counts(n_pos, n_boot, device)`` is the [P, B] float64
multiplicity matrix ``resample_count_matrix(resample_columns(nj), P)``
(``engine/supports.py``; ref resampleColumns tcc:705-727): how often each
position is drawn in each of B resamples of P columns from Knuth's stream
(``utils/knuth.py``, never seeded by the reference, so the default 314159).
The twin is that pair of functions, a Python draw per column; the kernel
runs the stream on the card from the state the host seeds it with
(``KnuthRandom(314159)``, after ``ran_start`` and its warm-up cycles).

As for the other kernels, the wrapper runs the twin for the CPU and
launches its kernel for a CUDA device; anything else raises (no fallback),
and ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.knuth import KnuthRandom

from . import _build

SEED = 314159                   # KnuthRandom's default, which the reference keeps


def sh_resample_counts_ref(n_pos: int, n_boot: int) -> torch.Tensor:
    """Plain twin of sh_resample_counts (on the CPU)."""
    from ..engine.supports import resample_columns, resample_count_matrix

    nj = SimpleNamespace(n_pos=n_pos,
                         options=SimpleNamespace(n_bootstrap=n_boot))
    return torch.from_numpy(resample_count_matrix(resample_columns(nj),
                                                  n_pos))


@functools.lru_cache(maxsize=1)
def _state() -> np.ndarray:
    return KnuthRandom(SEED)._x.astype(np.int32)


def knuth_state() -> np.ndarray:
    """The generator state [100] int32 that KnuthRandom's first cycle starts
    from: its first 100 values (ran_start's, computed once)."""
    return _state().copy()


def sh_resample_counts(n_pos: int, n_boot: int, device) -> torch.Tensor:
    """counts [n_pos, n_boot] float64 on `device`: counts[p, b] is how often
    position p is drawn in resample b."""
    device = torch.device(device)
    if n_pos < 1 or n_boot < 1:
        raise ValueError(f"sh_resample_counts: {n_pos} positions, {n_boot} "
                         "resamples")
    if device.type == "cpu":
        return sh_resample_counts_ref(n_pos, n_boot)
    if device.type != "cuda":
        raise ValueError(f"sh_resample_counts runs on the CPU or CUDA, not "
                         f"{device}")
    state = torch.from_numpy(knuth_state()).to(device)
    counts = torch.zeros((n_pos, n_boot), dtype=torch.int32, device=device)
    rc = _build.library().vft_sh_resample_counts(
        state.data_ptr(), n_pos, n_boot, counts.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sh_resample_counts: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    sh_resample_counts.launches += 1
    return counts.double()


sh_resample_counts.launches = 0
