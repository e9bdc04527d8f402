# Copy of veryfasttree_tpu/models/transition_matrix.py (the port imports none of it).
"""Maximum-likelihood substitution model (JTT92 / WAG01 / LG08 / GTR / custom).

Math contract (ref src/TransitionMatrix.h:9-58): the instantaneous rate matrix
M (with M.stat = 0) is symmetrized as M' = S^-1 M S with S = diag(sqrt(stat)),
eigendecomposed M' = W L W^T, and V = S W gives M = V L V^-1 with
V^-1 = W^T S^-1.  Profiles are stored rotated as r = V^T f so that

    P(f0 & f1 | t) = sum_j r0[j] r1[j] exp(l_j t)

is an O(nCodes) dot product, and the posterior profile of a parent is three
batched [P,C]x[C,C] matmuls (see ops/kernels.py) -- which is exactly the shape
the TPU MXU wants.

The reference uses Numerical-Recipes tred2/tqli (ref src/TransitionMatrix.tcc:
368-521); we use numpy.linalg.eigh on the same symmetrized matrix, which yields
an equivalent rotation (possibly differing by eigenvector sign/order -- all
downstream formulas are invariant to that).
"""
from __future__ import annotations

import numpy as np

from .. import constants
from ..constants import NOCODE
from ._matrices_data import (matrixJTT92, matrixLG08, matrixWAG01, statJTT92,
                             statLG08, statWAG01)


class TransitionMatrix:
    def __init__(self, matrix: np.ndarray, stat: np.ndarray, dtype=np.float32):
        """matrix[i][j] = instantaneous rate of j -> i (diagonals recomputed)."""
        n = len(stat)
        self.n_codes = n
        self.dtype = dtype
        stat = np.asarray(stat, dtype=np.float64)
        self.stat = stat
        self.statinv = 1.0 / stat
        sqrtstat = np.sqrt(stat)

        sym = np.array(matrix, dtype=np.float64)
        # set diagonals so column sums are 0 before symmetrization
        np.fill_diagonal(sym, 0.0)
        np.fill_diagonal(sym, -sym.sum(axis=0))
        # M' = S^-1 M S
        sym = sym * (sqrtstat[None, :] / sqrtstat[:, None])
        sym = 0.5 * (sym + sym.T)  # enforce exact symmetry for eigh

        eigenval, w = np.linalg.eigh(sym)  # columns of w are eigenvectors of M'
        self.eigenval = eigenval
        # V = S W ; V^-1 = W^T S^-1
        self.eigeninv = w.T / sqrtstat[None, :]          # [k][j]
        self.eigeninvT = self.eigeninv.T.copy()
        # code_freq rows are rotated one-hots: code_freq[c] = (V^T e_c) = row c of V
        code_freq = np.zeros((NOCODE + 1, n))
        code_freq[:n] = w * sqrtstat[:, None]            # V[i][k]
        # gap row: rotation of (1,...,1) so that P(gap)=1 (ref tcc:218-226)
        code_freq[NOCODE] = code_freq[:n].sum(axis=0)
        self.code_freq = code_freq

        self._make_near(n)

    def _make_near(self, n):
        """Approximate-posterior helpers nearP/nearFreq (ref tcc:227-279)."""
        t = constants.APPROX_ML_NEAR_T
        expv = np.exp(t * self.eigenval)
        lvinv = self.eigeninv * expv[:, None]
        # transt[i][j] = P(j->i | t) = (V exp(Lt) V^-1)[i][j]
        transt = self.code_freq[:n] @ lvinv
        near_p = self.stat[None, :] * transt ** 2        # [i][j] before normalize
        near_p /= near_p.sum(axis=1, keepdims=True)
        self.near_p = near_p
        scaled = near_p / self.stat[None, :]
        # nearFreq[i] = rotation of nearP[i]/stat.  NOTE: mirrors the reference
        # computation at tcc:272-278, which contracts against codeFreq[i] --
        # the row of the character i itself.
        self.near_freq = np.einsum("ik,ij->ij", scaled, self.code_freq[:n])

    # --- factory constructors -------------------------------------------------
    @classmethod
    def jtt92(cls, dtype=np.float32):
        return cls(matrixJTT92, statJTT92, dtype)

    @classmethod
    def wag01(cls, dtype=np.float32):
        return cls(matrixWAG01, statWAG01, dtype)

    @classmethod
    def lg08(cls, dtype=np.float32):
        return cls(matrixLG08, statLG08, dtype)

    @classmethod
    def gtr(cls, rates, freq, dtype=np.float32):
        """GTR from 6 rates (ac ag at cg ct gt) + 4 freqs (ref tcc:26-61)."""
        rates = np.asarray(rates, dtype=np.float64)
        freq = np.asarray(freq, dtype=np.float64)
        m = np.zeros((4, 4))
        k = 0
        for i in range(4):
            for j in range(i + 1, 4):
                m[i, j] = rates[k] * freq[i]
                m[j, i] = rates[k] * freq[j]
                k += 1
        total_rate = (freq[:, None] * m).sum()
        m /= total_rate
        return cls(m, freq, dtype)

    @classmethod
    def from_file(cls, filename: str, dtype=np.float32):
        """Custom 20x20 AA rate matrix in the reference's tab format
        (ref src/TransitionMatrix.tcc:63-156), with the same validations."""
        aa = constants.CODES_STRING_AA
        with open(filename) as fp:
            header = fp.readline().rstrip("\n")
            expected = "\t".join(list(aa)) + "\t*"
            if header != expected:
                raise ValueError(f"Invalid header line in transition matrix file; "
                                 f"must match: {expected}")
            matrix = np.zeros((20, 20))
            stat = np.zeros(20)
            for i in range(20):
                fields = fp.readline().rstrip("\n").split("\t")
                if fields[0] != aa[i]:
                    raise ValueError(f"Line for amino acid {aa[i]} malformed")
                row = [float(x) for x in fields[1:22]]
                matrix[i] = row[:20]
                stat[i] = row[20]
        tol = 1e-5
        if (stat < tol).any():
            raise ValueError("stationary frequencies must be positive")
        if abs(stat.sum() - 1) > tol:
            raise ValueError(f"stationary frequencies must sum to 1 -- sum is {stat.sum()}")
        if (np.diag(matrix) > -tol).any():
            raise ValueError("diagonal transition rates must be negative")
        if abs(np.dot(stat, np.diag(matrix)) + 1) > tol:
            raise ValueError("dot(stat, diag) must be -1")
        off = matrix - np.diag(np.diag(matrix))
        if (off < 0).any():
            raise ValueError("off-diagonal entries must be nonnegative")
        if (np.abs(matrix.sum(axis=0)) > tol).any():
            raise ValueError("columns must sum to zero")
        return cls(matrix, stat, dtype)
