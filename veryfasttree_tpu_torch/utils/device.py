"""Device and precision setup of the PyTorch port.

The port's form of the precision block at the top of
``veryfasttree_tpu.pipeline._run_single``: full-precision float32 matrix
products (TF32 off), and profile contractions accumulated in float64.  The
reference accumulates ``top`` and ``denom`` in double even over float
profiles (ref profileDist NeighbourJoining.tcc:1167-1190); the H100 has
native FP64, so the port keeps those double accumulators on the card as on
the CPU.
"""
from __future__ import annotations

import torch

ACCUM_DTYPE = torch.float64


def configure_precision() -> None:
    """Full float32 products everywhere: near-tie join and NNI decisions
    must not see TF32 rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless told otherwise.  A CUDA request
    without a CUDA device raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; the port runs on a "
                           "GPU (pass device=torch.device('cpu') explicitly "
                           "to run the plain PyTorch path)")
    return dev
