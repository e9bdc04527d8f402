# Copy of veryfasttree_tpu/options.py (the port imports none of it), with
# the port's helpers ml_options and noml_options.
"""Run options: the full FastTree-2 / VeryFastTree tunable surface.

Mirrors ref src/Options.h:12-121 plus the post-parse normalization rules of
``VeryFastTree::settings`` (ref src/VeryFastTree.cpp:46-260).  TPU-specific
knobs (mesh shape, device batching) are added at the end; OpenMP-era knobs
(thread level, disk computing) are kept for CLI compatibility and mapped onto
their TPU equivalents where meaningful.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from . import constants


@dataclasses.dataclass
class Options:
    verbose: int = 1
    show_progress: bool = True
    slow: bool = False
    fastest: bool = False
    use_tophits_2nd: bool = False
    bionj: bool = False
    tophits_mult: float = 1.0          # 0 = compare all nodes to all others
    tophits_close: float = -1.0
    topvisible_mult: float = 1.5
    tophits_refresh: float = 0.8
    tophits2_mult: float = 1.0
    tophits2_safety: int = 3
    tophits2_refresh: float = 0.6
    stale_out_limit: float = 0.01
    f_reset_out_profile: float = 0.02
    n_reset_out_profile: int = 200
    n_codes: int = 20                  # 20 protein / 4 nucleotide
    use_matrix: bool = True
    logdist: bool = True
    pseudo_weight: float = 0.0
    constraint_weight: float = 100.0
    me_min_delta: float = 1.0e-4
    fast_nni: bool = True
    gamma_loglk: bool = False
    ml_accuracy: int = 1
    exact_ml: bool = True

    codes_string: str = ""

    n_align: int = 1
    matrix_prefix: str = ""
    transition_file: str = ""
    make_matrix: bool = False
    constraints_file: str = ""
    intree_file: str = ""
    intree1: bool = False
    nni: int = -1                      # -1 => 4*log2(N) rounds
    spr: int = 2
    max_spr_length: int = 10
    ml_nni: int = -1                   # -1 => 2*log2(N) rounds
    ml_len: bool = False
    n_bootstrap: int = 1000
    n_rate_cats: int = constants.N_DEFAULT_RATE_CATS
    use_gtr: bool = False
    use_lg: bool = False
    use_wag: bool = False
    use_gtr_rates: bool = False
    gtr_rates: tuple = (1.0,) * 6
    use_gtr_freq: bool = False
    gtr_freq: tuple = (0.25,) * 4
    quote: bool = False

    in_file_name: str = ""
    out_file_name: str = ""
    log_file_name: str = ""
    expert: bool = False
    seed: int = dataclasses.field(default_factory=lambda: int(time.time()))

    # Parallel / numeric configuration (reference kept thread knobs here;
    # we keep them for CLI compat and add the TPU mesh equivalents).
    threads: int = 1
    threads_explicit: bool = False     # user passed -threads on the CLI
    threads_verbose: bool = False
    deterministic: bool = True
    threads_level: int = 3
    partitioning_tendency_window: int = 50
    double_precision: bool = False
    fastexp: int = 0
    extension: str = "AUTO"            # accepted & ignored: TPU path is single
    disk_computing: bool = False
    disk_computing_path: str = ""
    disk_dynamic_computing: bool = False
    disk_computing_limit: int = -1
    relative_progress: bool = False

    # Precision-derived (set by derive_settings)
    ml_min_branch_length_tolerance: float = 0.0
    ml_ftol_branch_length: float = 0.0
    ml_min_branch_length: float = 0.0
    ml_min_rel_branch_length: float = 0.0
    f_post_total_tolerance: float = 0.0

    # --- TPU-native additions -------------------------------------------------
    # Number of devices along the alignment-position axis ("sp") and along the
    # candidate/data axis ("dp"); None = use all of jax.devices() on sp.
    mesh_sp: Optional[int] = None
    mesh_dp: int = 1
    # Live jax.sharding.Mesh built from mesh_sp/mesh_dp by the pipeline
    # (parallel.mesh.mesh_from_options); None = single-device.
    mesh: Optional[object] = None
    # Multi-host: jax.distributed init (parallel.multihost); when set, the
    # mesh spans every host's devices and fetches allgather over DCN.
    coordinator: str = ""
    n_hosts: int = 0
    host_id: Optional[int] = None
    # Array-state checkpoint file: written after every ML-NNI round; if it
    # exists at startup, the run resumes from it (tree + profile stores +
    # rates + NNI aging state).  Empty = disabled; the reference's
    # tree-as-checkpoint contract (-log + -intree) works regardless.
    checkpoint_file: str = ""
    # Pad positions up to a multiple of this for MXU-friendly tiles.
    position_align: int = 128
    # Leaf storage tier: at >= this many unique sequences, leaves live as int8
    # codes only (expanded on the fly in kernels; the 1M-taxa HBM enabler).
    # 0 forces two-tier on, -1 (or a huge value) disables it.
    two_tier_min: int = 20000

    def derive_settings(self, log=None) -> "Options":
        """Normalize option interactions (ref src/VeryFastTree.cpp:46-260)."""
        def warn(msg):
            if log is not None:
                print(msg, file=log)

        if self.nni == 0:
            self.spr = 0
        if self.use_tophits_2nd and self.threads > 1:
            self.use_tophits_2nd = False
            warn("Warning: 2nd-level top hits ignored in multi-worker mode")

        self.codes_string = (
            constants.CODES_STRING_AA if self.n_codes == 20 else constants.CODES_STRING_NT
        )
        if self.n_codes == 4 and not self.matrix_prefix:
            self.use_matrix = False  # no default nucleotide matrix
        if self.transition_file and self.n_codes != 20:
            raise ValueError("The -trans option is only supported for amino acid alignments")
        if self.slow and self.fastest:
            raise ValueError("Cannot be both slow and fastest")
        if self.slow and self.tophits_mult > 0:
            self.tophits_mult = 0.0

        if self.double_precision:
            self.ml_min_branch_length_tolerance = constants.ML_MIN_BRANCH_LENGTH_TOLERANCE_DOUBLE
            self.ml_ftol_branch_length = constants.ML_FTOL_BRANCH_LENGTH_DOUBLE
            self.ml_min_branch_length = constants.ML_MIN_BRANCH_LENGTH_DOUBLE
            self.ml_min_rel_branch_length = constants.ML_MIN_REL_BRANCH_LENGTH_DOUBLE
            self.f_post_total_tolerance = constants.F_POST_TOTAL_TOLERANCE_DOUBLE
        else:
            self.ml_min_branch_length_tolerance = constants.ML_MIN_BRANCH_LENGTH_TOLERANCE_FLOAT
            self.ml_ftol_branch_length = constants.ML_FTOL_BRANCH_LENGTH_FLOAT
            self.ml_min_branch_length = constants.ML_MIN_BRANCH_LENGTH_FLOAT
            self.ml_min_rel_branch_length = constants.ML_MIN_REL_BRANCH_LENGTH_FLOAT
            self.f_post_total_tolerance = constants.F_POST_TOTAL_TOLERANCE_FLOAT
        return self

    @property
    def dtype(self):
        import numpy as np

        return np.float64 if self.double_precision else np.float32


def noml_options(**overrides) -> Options:
    """Derived options of ``-nt -noml -nosupport``, with no progress output;
    keyword arguments set further fields before the derivation."""
    return ml_options(**{"ml_nni": 0, "n_bootstrap": 0, **overrides})


def ml_options(**overrides) -> Options:
    """Derived options of the default ``-nt`` run (ML NNIs, CAT 20 rates,
    1000-resample SH-like supports), with no progress output; keyword
    arguments set further fields before the derivation (n_codes=20: the
    default protein run)."""
    opts = Options(**{"n_codes": 4, "show_progress": False, **overrides})
    return opts.derive_settings()
