"""Public op: the Mamba2 SSD on pre-weighted inputs, with its gradient.

``ssd_op`` brings the arguments to the kernels' layout (float32,
contiguous).  Where a gradient will be taken (grad mode on and an input
that requires one) it applies ``SSD``, a ``torch.autograd.Function``
whose forward runs ``kernel.ssd`` and saves its four inputs, and whose
backward runs ``kernel.ssd_bwd`` (the backward kernel on the card, the
plain reverse recurrence on the CPU) with the final state's gradient, or
none where the caller drops the state.  Otherwise it runs ``kernel.ssd``
alone, as serving always has."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel


class SSD(torch.autograd.Function):
    """xdt (b, L, nh, hd), loga (b, L, nh), B/C (b, L, n), float32 and
    contiguous -> (y, final state (b, nh, n, hd))."""

    @staticmethod
    def forward(ctx, xdt, loga, B, C, chunk: int):
        ctx.set_materialize_grads(False)
        y, S = kernel.ssd(xdt, loga, B, C, chunk=chunk)
        ctx.save_for_backward(xdt, loga, B, C)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        xdt, loga, B, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xdt)
        grads = kernel.ssd_bwd(xdt, loga, B, C, dy.float().contiguous(),
                               None if dS is None else dS.float().contiguous())
        return (*grads, None)


def ssd_op(xdt, loga, B, C, *, chunk: int = 128):
    """Pre-weighted form: xdt = x*dt, loga = dt*A.  Returns (y, final state)."""
    args = tuple(t.float().contiguous() for t in (xdt, loga, B, C))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSD.apply(*args, chunk)
    return kernel.ssd(*args, chunk=chunk)
