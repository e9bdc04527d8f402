# Copy of veryfasttree_tpu/utils/debug.py (the port imports none of it).
"""Performance / heuristic counters (ref src/Debug.h:9-41).

These counters give a numeric fingerprint of heuristic behavior (profile ops
per N^2, close-neighbor reuse, hill-climb improvements, NNI/SPR counts,
posterior-approximation rates) and are printed in the final stats block, which
the parity tests compare against the reference binary's output.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Debug:
    profile_ops: int = 0
    outprofile_ops: int = 0
    seq_ops: int = 0
    profile_avg_ops: int = 0
    n_hill_better: int = 0
    n_visible_update: int = 0
    n_nni: int = 0
    n_spr: int = 0
    n_ml_nni: int = 0
    n_suboptimal_splits: int = 0
    n_close_used: int = 0
    n_close2_used: int = 0
    n_refresh_tophits: int = 0
    n_lk_compute: int = 0
    n_posterior_compute: int = 0
    n_aa_posterior_exact: int = 0
    n_aa_posterior_rough: int = 0
    n_star_tests: int = 0
    n_profile_freq_alloc: int = 0
    n_profile_freq_avoid: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)
