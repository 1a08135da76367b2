"""Plain PyTorch version of decode attention: the math of the reference's
oracle (``kernels/decode_attention/ref.py``), in float32.  The CPU runs it,
and the kernel is held against it on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_plain(q, k_cache, v_cache, cache_len):
    """q: (b, 1, h, d); caches: (b, S, kv, d); cache_len: (b,) -> (b, 1, h, d).
    Cache entries at or past ``cache_len`` are masked."""
    b, _, h, d = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    if kv != h:
        k_cache = k_cache.repeat_interleave(h // kv, dim=2)
        v_cache = v_cache.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * (d ** -0.5)
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             < cache_len.to(q.device)[:, None, None, None])
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())
    return o.to(q.dtype)
