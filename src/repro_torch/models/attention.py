"""GQA attention: params, the prefill path and the decode path.

Prefill attention goes to the flash-attention op and decode attention to
the flash-decode op: hand-written CUDA kernels on the card, their plain
versions on the CPU (``repro_torch.kernels``).  The projections are
``torch.matmul`` with the weights cast to the activation dtype at use.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention as _decode_op
from repro_torch.kernels.flash_attention.ops import flash_attention as _flash_op
from repro_torch.models.common import ParamSpec, rms_norm, rope
from repro_torch.models.config import ArchConfig


def attn_specs(cfg: ArchConfig) -> dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d), fan_in=h * hd),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), init="zeros", cast=False)
        specs["k_norm"] = ParamSpec((hd,), init="zeros", cast=False)
    return specs


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, heads, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def project_qkv(p, x, cfg: ArchConfig, positions, use_rope: bool = True):
    """x: (b, s, d) -> q (b, s, h, hd), k/v (b, s, kv, hd)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool):
    """q: (b, sq, h, hd); k/v: (b, sk, kv, hd) -> (b, sq, h, hd), through
    the flash-attention op (the reference's kernel route)."""
    return _flash_op(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention against a (b, S, kv, hd) cache, through the
    flash-decode op; entries at or past ``cache_len`` are ignored."""
    return _decode_op(q, k_cache, v_cache, cache_len)


def attn_output(p, o: torch.Tensor, x_dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, hd, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].to(x_dtype).reshape(h * hd, d)
