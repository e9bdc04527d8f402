"""Bootstrap column counts of the SH-like supports: the CUDA kernel of
``csrc/sh_resample.cu``, its launch plan and its plain twin.

``sh_resample_counts(n_pos, n_boot, device)`` is the [P, B] float64
multiplicity matrix ``resample_count_matrix(resample_columns(nj), P)``
(``engine/supports.py``; ref resampleColumns tcc:705-727): how often each
position is drawn in each of B resamples of P columns from Knuth's stream
(``utils/knuth.py``, never seeded by the reference, so the default 314159).
The twin is that pair of functions, a Python draw per column.

The kernel cuts the stream into chunks that run side by side.  Each cycle
of the generator hands out its state s_k (100 values) and moves on to
s_{k+1} = M s_k mod 2^30, M the 100 x 100 matrix of one ``ran_array(1009)``
cycle (``cycle_matrix``).  ``resample_plan`` splits the B resamples into
ranges of R, one block each (and the P columns into slabs of S where one
range's [S, R] histogram would not fit in shared memory), and the cycles
of a range into W chunks of T cycles, one warp each.  The kernel takes
each range's start state (``range_states``) and the matrices M^(w T)
(``warp_jumps``), from which warp w computes its own start state
(``chunk_states`` is the same product on the host); both come from
powers of M (``knuth_states``), computed once per plan and kept on the
device.  Only those tables are cached; every call draws the counts anew.

As for the other kernels, the wrapper runs the twin for the CPU and
launches its kernel for a CUDA device; anything else raises (no fallback),
and ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..utils.knuth import KK, LL, QUALITY, KnuthRandom

from . import _build

SEED = 314159                   # KnuthRandom's default, which the reference keeps
MASK = (1 << 30) - 1            # the stream's values are mod 2^30
HIST_BYTES = 96 * 1024          # a block's [S, R] int32 histogram at most
MAX_WARPS = 16                  # csrc/sh_resample.cu kMaxWarps
MIN_CHUNK = 2                   # cycles a warp takes at least


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


def _mulmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b mod 2^30 for int64 matrices with entries in [0, 2^30) and an
    inner dimension of at most 100: in float64 on 15-bit halves, whose
    products and sums of 100 stay below 2^53 and so are exact (the
    high-high product is a multiple of 2^30).  Rows go in blocks of 26, so
    that each BLAS product (26 x 100 x 100) stays below the size at which
    BLAS starts threads of its own."""
    b_hi, b_lo = (b >> 15).astype(np.float64), (b & 0x7FFF).astype(np.float64)
    out = np.empty((a.shape[0], b.shape[1]), dtype=np.int64)
    for r in range(0, a.shape[0], 26):
        blk = a[r:r + 26]
        a_hi = (blk >> 15).astype(np.float64)
        a_lo = (blk & 0x7FFF).astype(np.float64)
        mid = (a_hi @ b_lo + a_lo @ b_hi).astype(np.int64)
        low = (a_lo @ b_lo).astype(np.int64)
        out[r:r + 26] = (((mid & 0x7FFF) << 15) + low) & MASK
    return out


@functools.lru_cache(maxsize=1)
def cycle_matrix() -> np.ndarray:
    """M [100, 100] int64: the state after one cycle is M @ s mod 2^30 (the
    recurrence of KnuthRandom._ran_array(1009) and its continuation, run on
    the 100 unit vectors at once)."""
    a = np.zeros((QUALITY + KK, KK), dtype=np.int64)
    a[:KK] = np.eye(KK, dtype=np.int64)
    for j in range(KK, QUALITY + KK):
        a[j] = (a[j - KK] - a[j - LL]) & MASK
    return a[QUALITY:]


_powers = []                    # M^(2^i), transposed, as far as asked


def _power(i: int) -> np.ndarray:
    while len(_powers) <= i:
        _powers.append(_mulmod(_powers[-1], _powers[-1]) if _powers
                       else cycle_matrix().T.copy())
    return _powers[i]


def _jump(k: int) -> np.ndarray:
    """(M^k)^T: a row state times it is the state k cycles later."""
    out = np.eye(KK, dtype=np.int64)
    for i in range(k.bit_length()):
        if (k >> i) & 1:
            out = _mulmod(out, _power(i))
    return out


def knuth_states(cycles) -> np.ndarray:
    """[len(cycles), 100] int32: the generator state after each number of
    whole cycles (KnuthRandom(SEED)._x after that many ran_array(1009)),
    that is, the 100 values cycle k hands out."""
    cycles = np.asarray(cycles, dtype=np.int64).reshape(-1)
    states = np.tile(_state().astype(np.int64), (len(cycles), 1))
    for i in range(int(cycles.max(initial=0)).bit_length()):
        sel = (cycles >> i) & 1 == 1
        if sel.any():
            states[sel] = _mulmod(states[sel], _power(i))
    return states.astype(np.int32)


class ResamplePlan(NamedTuple):
    """The kernel's launch: B resamples in ranges of R (grid x), P columns
    in slabs of S (grid y), W warps a block, each taking T cycles of its
    range's draws."""
    P: int
    B: int
    R: int
    S: int
    W: int
    T: int

    def cycle_ranges(self):
        """(k0, k1) [n_ranges]: the cycles that hold each range's draws."""
        b0 = np.arange(0, self.B, self.R, dtype=np.int64)
        d0 = b0 * self.P
        d1 = np.minimum(b0 + self.R, self.B) * self.P
        return d0 // KK, -(-d1 // KK)


def resample_plan(n_pos: int, n_boot: int, n_sms: int) -> ResamplePlan:
    """The chunks for P = n_pos, B = n_boot on a card of n_sms
    multiprocessors: ranges of R resamples, about two blocks a
    multiprocessor where B allows, R at most what the histogram holds;
    ranges of one resample split into slabs of columns where one does not
    fit; then W warps of T >= MIN_CHUNK cycles over a range's cycles.  The
    counts do not depend on the plan."""
    per_col = 4                                 # int32 per column and resample
    if n_pos * per_col <= HIST_BYTES:
        S = n_pos
        R = max(1, min(n_boot // (2 * n_sms), HIST_BYTES // (per_col * S)))
    else:
        R = 1
        n_slabs = -(-n_pos * per_col // HIST_BYTES)
        S = -(-n_pos // n_slabs)
    k0, k1 = ResamplePlan(n_pos, n_boot, R, S, 1, 1).cycle_ranges()
    span = int((k1 - k0).max())
    W = min(MAX_WARPS, max(1, -(-span // MIN_CHUNK)))
    return ResamplePlan(n_pos, n_boot, R, S, W, -(-span // W))


@functools.lru_cache(maxsize=8)
def range_states(plan: ResamplePlan) -> np.ndarray:
    """[n_ranges, 100] int32: the state at the start of each range's cycles
    k0.  Ranges b and b + q start k0[b + q] - k0[b] = q R P / 100 cycles
    apart (q = 100 / gcd(R P, 100)): the first q from knuth_states, then
    the others q, 2q, 4q, ... ranges on by one product each."""
    k0, _ = plan.cycle_ranges()
    n = len(k0)
    q = 100 // math.gcd(plan.R * plan.P, 100)
    out = np.empty((n, KK), dtype=np.int64)
    out[:q] = knuth_states(k0[:q])
    m, jump = q, _jump(q * plan.R * plan.P // 100)
    while m < n:
        c = min(m, n - m)
        out[m:m + c] = _mulmod(out[:c], jump)
        m += c
        jump = _mulmod(jump, jump)
    return out.astype(np.int32)


@functools.lru_cache(maxsize=8)
def warp_jumps(plan: ResamplePlan) -> np.ndarray:
    """[W, 100, 100] int32: (M^(w T))^T, which takes a range's start state
    (as a row) to warp w's, w T cycles on."""
    out = [np.eye(KK, dtype=np.int64)]
    step = _jump(plan.T)
    for _ in range(1, plan.W):
        out.append(_mulmod(out[-1], step))
    return np.stack(out).astype(np.int32)


def chunk_states(plan: ResamplePlan) -> np.ndarray:
    """[n_ranges, W, 100] int32: the state each warp starts its chunk from,
    cycle k0 + w T of its range, as the kernel computes it from
    range_states and warp_jumps (a warp whose chunk starts past its
    range's cycles takes none)."""
    starts = range_states(plan).astype(np.int64)
    jumps = warp_jumps(plan).astype(np.int64)
    return np.stack([_mulmod(starts, j) for j in jumps], axis=1).astype(
        np.int32)


_device_tables: dict = {}


def _tables_on(plan: ResamplePlan, device: torch.device):
    key = (plan, device)
    if key not in _device_tables:
        _device_tables[key] = (
            torch.from_numpy(range_states(plan)).to(device),
            torch.from_numpy(warp_jumps(plan)).to(device))
    return _device_tables[key]


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
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    plan = resample_plan(
        n_pos, n_boot,
        torch.cuda.get_device_properties(device).multi_processor_count)
    states, jumps = _tables_on(plan, device)
    counts = torch.empty((n_pos, n_boot), dtype=torch.float64, device=device)
    rc = _build.library().vft_sh_resample_counts(
        states.data_ptr(), jumps.data_ptr(), n_pos, n_boot, plan.R, plan.S,
        plan.T, plan.W, counts.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sh_resample_counts: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    sh_resample_counts.launches += 1
    return counts


sh_resample_counts.launches = 0
