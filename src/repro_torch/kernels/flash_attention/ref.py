"""Plain PyTorch version of flash attention: the math of the reference's
oracle (``kernels/flash_attention/ref.py``), in float32.  The CPU runs it,
and the kernel is held against it on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d) with h % kv == 0 -> (b, sq, h, d).
    Causal masking is aligned bottom-right: query i sees keys <= i + sk - sq."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = qi >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
