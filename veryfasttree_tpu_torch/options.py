"""Run options: the JAX package's ``Options`` (plain Python, no jax),
re-exported so that callers of the port import only this package."""
from __future__ import annotations

from veryfasttree_tpu.options import Options

__all__ = ["Options", "noml_options"]


def noml_options(**overrides) -> Options:
    """Derived options of ``-nt -noml -nosupport`` (the main path), with no
    progress output; keyword arguments set further fields before the
    derivation."""
    opts = Options(n_codes=4, show_progress=False, ml_nni=0, n_bootstrap=0,
                   **overrides)
    return opts.derive_settings()
