"""Run options: the JAX package's ``Options`` (plain Python, no jax),
re-exported so that callers of the port import only this package."""
from __future__ import annotations

from veryfasttree_tpu.options import Options

__all__ = ["Options", "ml_options", "noml_options"]


def noml_options(**overrides) -> Options:
    """Derived options of ``-nt -noml -nosupport``, with no progress output;
    keyword arguments set further fields before the derivation."""
    return ml_options(**{"ml_nni": 0, "n_bootstrap": 0, **overrides})


def ml_options(**overrides) -> Options:
    """Derived options of the default ``-nt`` run (ML NNIs, CAT 20 rates,
    1000-resample SH-like supports), with no progress output; keyword
    arguments set further fields before the derivation."""
    opts = Options(n_codes=4, show_progress=False, **overrides)
    return opts.derive_settings()
