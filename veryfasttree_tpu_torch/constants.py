# Copy of veryfasttree_tpu/constants.py (the port imports none of it).
"""Numeric constants of the VeryFastTree/FastTree-2 algorithm family.

Mirrors the contract of the reference implementation (ref src/Constants.h:9-82):
underflow rescaling thresholds for likelihood products, precision-dependent
branch-length optimization tolerances, NNI heuristic cutoffs, and the protein /
nucleotide character sets.
"""

# Likelihood underflow rescaling (ref src/Constants.h:13-15)
LK_UNDERFLOW = 1.0e-4
LK_UNDERFLOW_INV = 1.0e4
LOG_LK_UNDERFLOW = 9.21034037197618  # -log(LK_UNDERFLOW)
LOG2 = 0.693147180559945

# Branch-length optimization limits (ref src/Constants.h:26-39);
# selected into Options by precision in options.derive_settings().
ML_MIN_BRANCH_LENGTH_TOLERANCE_DOUBLE = 1.0e-9
ML_MIN_BRANCH_LENGTH_TOLERANCE_FLOAT = 1.0e-4
ML_FTOL_BRANCH_LENGTH_DOUBLE = 0.001
ML_FTOL_BRANCH_LENGTH_FLOAT = 0.001
ML_MIN_BRANCH_LENGTH_DOUBLE = 5.0e-9
ML_MIN_BRANCH_LENGTH_FLOAT = 5.0e-4
ML_MIN_REL_BRANCH_LENGTH_DOUBLE = 2.5e-9
ML_MIN_REL_BRANCH_LENGTH_FLOAT = 2.5e-4
F_POST_TOTAL_TOLERANCE_DOUBLE = 1.0e-20
F_POST_TOTAL_TOLERANCE_FLOAT = 1.0e-10

# NNI / convergence heuristics (ref src/Constants.h:41-49)
CLOSE_LOGLK_LIMIT = 5.0
TREE_LOGLK_DELTA = 0.1
APPROX_ML_MIN_F = 0.95
APPROX_ML_MIN_RATIO = 2.0 / 3.0
APPROX_ML_NEAR_T = 0.2
N_DEFAULT_RATE_CATS = 20

CODES_STRING_AA = "ARNDCQEGHILKMFPSTWYV"
CODES_STRING_NT = "ACGT"

NOCODE = 127  # gap / mixed-character marker (ref src/TransitionMatrix.h:7)

NAME = "VeryFastTree-TPU"
VERSION = "0.1.0"
COMPAT_VERSION = "4.0.5"  # reference CLI/behavior we track
