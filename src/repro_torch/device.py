"""Device resolution for every entry point of the port.

``device=None`` means the CUDA card.  There is no fallback: a machine
without CUDA raises, and the CPU runs only when the caller asks for it
by name (the parity tests do), in which case the plain PyTorch versions
of the kernels run.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; raises ``RuntimeError`` when
    CUDA is missing.  An explicit device is taken as given (a CUDA one is
    still checked); ``meta`` (tensors without storage) is the dry-run's
    (``launch/dryrun.py``)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
