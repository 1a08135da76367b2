"""Plain PyTorch versions of flash attention and its gradient: the math of
the reference's oracle (``kernels/flash_attention/ref.py``), in float32.
The CPU runs them, and the kernels are held against them on the card.

``attention_plain_lse`` is the forward that also returns each row's
log-sum-exp; ``attention_plain_bwd`` is FlashAttention-2's backward step by
step (P recomputed from the lse, D = rowsum(dO * O), dS = P (dP - D)),
the formulation the backward kernel follows."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _expand(k, h):
    """(b, s, kv, d) -> (b, s, h, d): kv head j serves query heads
    j * (h // kv) ... (j + 1) * (h // kv) - 1."""
    kv = k.shape[2]
    return k if kv == h else k.repeat_interleave(h // kv, dim=2)


def _mask(sq, sk, device):
    """(sq, sk) bool, True where query i sees key j (j <= i + sk - sq)."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return qi >= torch.arange(sk, device=device)[None, :]


def _scores(q, k, causal, scale):
    """f32 (b, h, sq, sk) scaled scores, masked entries at NEG_INF."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand(k, q.shape[2]).float()) * scale
    if causal:
        s = torch.where(_mask(q.shape[1], k.shape[1], q.device)[None, None], s, NEG_INF)
    return s


def attention_plain_lse(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d) with h % kv == 0 -> (o (b, sq,
    h, d) in q's dtype, lse f32 (b, h, sq)).  Causal masking is aligned
    bottom-right: query i sees keys <= i + sk - sq.  lse is the natural
    log-sum-exp of each row's scaled scores."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _scores(q, k, causal, scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, _expand(v, q.shape[2]).float())
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d) with h % kv == 0 -> (b, sq, h, d).
    Causal masking is aligned bottom-right: query i sees keys <= i + sk - sq."""
    return attention_plain_lse(q, k, v, causal=causal, scale=scale)[0]


def attention_plain_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: float | None = None):
    """(dq, dk, dv) in the inputs' dtype from q, k, v, the forward's output
    ``o`` and ``lse`` (f32 (b, h, sq)) and the output's gradient ``do``, in
    float32: P = exp(S scale - lse) (0 where masked), D = rowsum(dO * O),
    dV = P^T dO, dS = P (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale;
    dk and dv sum over each kv head's group of query heads."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = _expand(k, h).float(), _expand(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_mask(sq, sk, q.device)[None, None], p, 0.0)
    dsum = torch.einsum("bqhd,bqhd->bhq", dof, of)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - dsum[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def group_sum(t):
        return t.view(b, sk, kv, h // kv, d).sum(dim=3)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)
