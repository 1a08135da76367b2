"""Public op: flash attention, with its gradient.

``flash_attention`` brings the arguments to the kernels' layout
(contiguous).  Where a gradient will be taken (grad mode on and an input
that requires one) it applies ``FlashAttention``, a
``torch.autograd.Function`` whose forward launches the forward kernel with
the rows' log-sum-exp and saves q, k, v, the output and the lse, and whose
backward launches the backward kernel (``kernel.flash_attention_bwd``).
Otherwise it launches the forward kernel alone, without the lse, as
serving always has.  On CPU tensors the wrappers run the plain versions."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel


class FlashAttention(torch.autograd.Function):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d), contiguous -> (b, sq, h, d)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        o, lse = kernel.flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                                causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d) -> (b, sq, h, d)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return kernel.flash_attention(q, k, v, causal=causal)
