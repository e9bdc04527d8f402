# Copy of veryfasttree_tpu/utils/knuth.py (the port imports none of it).
"""Knuth's lagged-Fibonacci generator (TAOCP vol. 2, 3rd ed., section 3.6).

Implements the public-domain ``ran_start`` / ``ran_array`` / ``ran_arr_next``
algorithm (9th-printing variant) that FastTree-2 / VeryFastTree use to seed
bootstrap column resampling (ref src/Knuth.cpp:30-111).  Reproducing this exact
stream keeps our local-bootstrap and SH-support resampling bit-identical to the
reference for a given -seed, which the determinism tests rely on.

This is a vectorized-ish numpy re-derivation from the published algorithm; the
per-call stream matches ``knuth_rand()`` exactly (integer arithmetic mod 2^30).
"""
from __future__ import annotations

import numpy as np

KK = 100   # long lag
LL = 37    # short lag
MM = 1 << 30
TT = 70
QUALITY = 1009


def _mod_diff(x, y):
    return (x - y) & (MM - 1)


class KnuthRandom:
    def __init__(self, seed: int | None = None):
        self._x = np.zeros(KK, dtype=np.int64)
        self._buf = np.zeros(QUALITY, dtype=np.int64)
        self._ptr = -1  # index into buf; -1 = needs refill
        self._started = False
        if seed is not None:
            self.start(seed)

    def _ran_array(self, n: int) -> np.ndarray:
        aa = np.zeros(n, dtype=np.int64)
        aa[:KK] = self._x
        for j in range(KK, n):
            aa[j] = _mod_diff(aa[j - KK], aa[j - LL])
        j = n
        for i in range(LL):
            self._x[i] = _mod_diff(aa[j - KK], aa[j - LL])
            j += 1
        for i in range(LL, KK):
            self._x[i] = _mod_diff(aa[j - KK], self._x[i - LL])
            j += 1
        return aa

    def start(self, seed: int) -> None:
        x = np.zeros(KK + KK - 1, dtype=np.int64)
        ss = (seed + 2) & (MM - 2)
        for j in range(KK):
            x[j] = ss
            ss <<= 1
            if ss >= MM:
                ss -= MM - 2
        x[1] += 1
        ss = seed & (MM - 1)
        t = TT - 1
        while t:
            for j in range(KK - 1, 0, -1):  # "square"
                x[j + j] = x[j]
                x[j + j - 1] = 0
            for j in range(KK + KK - 2, KK - 1, -1):
                x[j - (KK - LL)] = _mod_diff(x[j - (KK - LL)], x[j])
                x[j - KK] = _mod_diff(x[j - KK], x[j])
            if ss & 1:  # "multiply by z"
                for j in range(KK, 0, -1):
                    x[j] = x[j - 1]
                x[0] = x[KK]
                x[LL] = _mod_diff(x[LL], x[KK])
            if ss:
                ss >>= 1
            else:
                t -= 1
        self._x[KK - LL :] = x[:LL]
        self._x[: KK - LL] = x[LL:KK]
        for _ in range(10):
            self._ran_array(KK + KK - 1)
        self._started = True
        self._ptr = -1

    def _cycle(self) -> int:
        if not self._started:
            self.start(314159)
        self._buf = self._ran_array(QUALITY)
        self._buf[KK] = -1
        self._ptr = 1
        return int(self._buf[0])

    def next_int(self) -> int:
        if self._ptr >= 0 and self._buf[self._ptr] >= 0:
            v = int(self._buf[self._ptr])
            self._ptr += 1
            return v
        return self._cycle()

    def next_double(self) -> float:
        """knuth_rand(): uniform in [0,1) with 2**-30 resolution."""
        return 9.31322574615479e-10 * self.next_int()
