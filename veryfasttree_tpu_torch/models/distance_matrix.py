# Copy of veryfasttree_tpu/models/distance_matrix.py (the port imports none of it).
"""Minimum-evolution distance model (BLOSUM45 for proteins).

Mirrors ref src/DistanceMatrix.{h,tcc}.  The key trick (kept): the pairwise
character-distance matrix ``distances[c1][c2]`` is eigendecomposed so that a
profile's frequency vector can be stored *rotated* into eigenspace, making the
profile-vs-profile distance an O(nCodes) weighted dot product

    piece(f1, f2) = sum_k eigenval[k] * r1[k] * r2[k]

instead of O(nCodes^2) (ref src/DistanceMatrix.h:15-33).  On TPU this makes the
one-vs-many distance scan a single MXU matmul over the flattened
(position x code) axis -- see ops/kernels.py.

Unlike the reference we do not ship the precomputed eigenvectors: ``distances``
is symmetric, so we recompute eigenval/eigeninv at load with numpy.linalg.eigh
(ref consistency check src/DistanceMatrix.tcc:102-125 is run on the result).
"""
from __future__ import annotations

import numpy as np

from ..constants import CODES_STRING_AA
from ._matrices_data import distancesBLOSUM45

MAXCODES = 20


class DistanceMatrix:
    """Holds distances + eigen-representation; None-like when absent (JC mode)."""

    def __init__(self, distances: np.ndarray, eigeninv: np.ndarray | None = None,
                 eigenval: np.ndarray | None = None, dtype=np.float32):
        n = distances.shape[0]
        self.n_codes = n
        self.distances = np.asarray(distances, dtype=np.float64)
        if eigeninv is None:
            # distances = Q diag(L) Q^T  =>  eigeninv[k][i] = Q[i][k]
            eigenval, q = np.linalg.eigh(self.distances)
            eigeninv = q.T
        self.eigenval = np.asarray(eigenval, dtype=np.float64)
        self.eigeninv = np.asarray(eigeninv, dtype=np.float64)
        # eigentot[k] = sum_j eigeninv[k][j]: rotation of the all-ones vector,
        # used to read off the total unrotated frequency of a rotated vector.
        self.eigentot = self.eigeninv.sum(axis=1)
        # codeFreq[c] = rotated one-hot for character c (transpose of eigeninv)
        self.code_freq = self.eigeninv.T.copy()
        self.gap_freq = self.code_freq.mean(axis=0)
        self.dtype = dtype
        self._check()

    def _check(self):
        # ref src/DistanceMatrix.tcc:102-125 consistency audit
        recon = (self.eigeninv * self.eigenval[:, None]).T @ self.eigeninv
        if not np.allclose(recon, self.distances, atol=1e-6):
            raise ValueError("Distance matrix eigen-representation inconsistent")

    @classmethod
    def blosum45(cls, dtype=np.float32) -> "DistanceMatrix":
        return cls(distancesBLOSUM45, dtype=dtype)

    @classmethod
    def from_files(cls, prefix: str, options, dtype=np.float32) -> "DistanceMatrix":
        """Read a custom matrix from {prefix}.inverses/.distances/.eigenvalues.

        File naming follows the reference CLI contract
        (ref src/DistanceMatrix.tcc:12-31): `.inverses` holds the pairwise
        distances (with a code header line), `.distances` the eigen-inverse,
        `.eigenvalues` the eigenvalues.
        """
        distances = _read_matrix(prefix + ".inverses", options, check_codes=True)
        eigeninv = _read_matrix(prefix + ".distances", options, check_codes=False)
        eigenval = _read_vector(prefix + ".eigenvalues", options)
        return cls(distances, eigeninv, eigenval, dtype=dtype)

    @classmethod
    def from_transition_matrix(cls, tmat, dtype=np.float32) -> "DistanceMatrix":
        """ML-space pseudo distance matrix used to re-average profiles after the
        switch to posterior representation (ref VeryFastTreeImpl.tcc:517-542)."""
        obj = cls.__new__(cls)
        n = tmat.n_codes
        obj.n_codes = n
        obj.distances = np.zeros((n, n))  # never used
        obj.eigenval = np.zeros(n)        # never used for distances
        obj.eigeninv = tmat.eigeninv.copy()
        obj.code_freq = tmat.code_freq[:n].copy()
        obj.eigentot = tmat.eigeninv.sum(axis=1)
        obj.gap_freq = obj.code_freq.mean(axis=0)
        obj.dtype = dtype
        return obj


def _read_matrix(filename: str, options, check_codes: bool) -> np.ndarray:
    n = options.n_codes
    with open(filename) as fp:
        header = fp.readline().strip()
        if check_codes:
            expect = list(options.codes_string[:n])
            got = header.split("\t")
            if [g.strip() for g in got[:n]] != expect:
                raise ValueError(f"Header line in {filename} does not match codes "
                                 f"{options.codes_string}")
        rows = []
        for _ in range(n):
            fields = fp.readline().split()
            rows.append([float(x) for x in fields[-n:]])
    m = np.array(rows)
    if check_codes and not np.allclose(m, m.T, atol=1e-6):
        raise ValueError(f"Distance matrix in {filename} is not symmetric")
    return m


def _read_vector(filename: str, options) -> np.ndarray:
    with open(filename) as fp:
        vals = [float(x) for x in fp.read().split()[: options.n_codes]]
    return np.array(vals)
