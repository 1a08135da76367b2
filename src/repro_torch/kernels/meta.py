"""The model kernels' ``meta`` forms and the count they report to.

On ``meta`` tensors (shapes and dtypes without storage) each model
kernel's wrapper checks its inputs as the card's route does, returns
``meta`` outputs of the card's shapes and dtypes, and adds its launch and
its work (``launch/costs.py``) to the count that ``counting`` made
active: the dry-run's (``launch/dryrun.py``).  Outside a count a meta
form raises, so nothing but the dry-run reaches it.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list = []


def require(name: str) -> None:
    """Raise unless a count is active."""
    if not _ACTIVE:
        raise ValueError(f"{name}: unsupported device meta outside a dry-run count "
                         "(repro_torch.launch.dryrun)")


def launch(name: str, nbytes: int, flops: int) -> None:
    """One launch of kernel ``name`` moving ``nbytes`` and doing ``flops``,
    added to the active count (which has ``kernel(name, nbytes, flops)``)."""
    require(name)
    _ACTIVE[-1].kernel(name, nbytes, flops)


@contextlib.contextmanager
def counting(count):
    """Make ``count`` the active count inside the ``with`` block."""
    _ACTIVE.append(count)
    try:
        yield count
    finally:
        _ACTIVE.pop()
