"""GreenFaaS on PyTorch and CUDA: the port of the ``repro`` package.

The batch path — predict -> place -> run -> attribute -> learn — runs
through :class:`repro_torch.core.executor.GreenFaaSExecutor`; placement
is the fused MHRA window greedy, a hand-written CUDA kernel on the card
(``kernels/placement``).  Every entry point takes ``device=None``, which
means the CUDA card; ``device="cpu"`` runs the kernels' plain PyTorch
versions.  The package imports ``torch`` and ``numpy`` only.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
