"""Encoder-decoder LM (the whisper-tiny backbone): serving and the loss's
gradient (the trainer, ``launch/train.py``).

The audio frontend is stubbed, as the reference stubs it: the inputs are
precomputed frame embeddings ``frames`` (b, enc_len, d).  LayerNorm,
tanh-GELU MLP, sinusoidal positions (added in bf16 to the bf16 frames and
token embeddings), MHA without rope.  The encoder attends without a mask
(flash attention, ``causal=False``, sq = sk = enc_len); each decoder layer
runs causal self-attention, then cross-attention of its queries against
the encoder output's k/v (flash attention, ``causal=False``, sq != sk),
then the MLP.  Serving keeps two caches a layer: the self k/v at
``max_len``, written at ``pos`` by each step and read up to ``pos + 1``,
and the cross k/v at ``enc_len``, filled once by the prefill and read
whole by every step (flash-decode against both).

Entry points:
  encode            — frames -> encoder output (b, enc_len, d)
  decode_train      — teacher-forced decoder -> logits (b, s, V)
  encdec_loss       — encode + decode_train, then next-token CE
  encdec_prefill    — encode, then the prompt -> (last logits, caches)
  encdec_decode_step — one token against both caches

The loss takes a gradient through flash attention's autograd op (its
backward kernel) in every encoder and decoder layer.  Where a gradient
will be taken, every layer is checkpointed (``torch.utils.checkpoint``):
its activations are dropped after the forward and recomputed in the
backward, whatever ``remat`` says, as the reference wraps both layer
bodies in ``jax.checkpoint(..., policy=nothing_saveable)``
unconditionally.  A decoder layer projects the cross k/v from the encoder
output inside its checkpoint, as the reference's ``_cross_kv`` runs inside
its body.

The layers are ``nn.ModuleList``s of per-layer tables (the reference
scans a stacked tree).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ParamSpec,
    cross_entropy_loss,
    layer_norm,
    pad_vocab,
    sinusoidal_pos_emb,
    stacked,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import _grad_taken, _layer_call, _mesh_free, embed_tokens
from repro_torch.models.mlp import mlp_apply, mlp_specs

COMPUTE_DTYPE = torch.bfloat16


def _ln_spec(d):
    return {"scale": ParamSpec((d,), init="ones", cast=False),
            "bias": ParamSpec((d,), init="zeros", cast=False)}


def _ln(p, x, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _enc_layer_specs(cfg: ArchConfig):
    return {"ln1": _ln_spec(cfg.d_model), "attn": attn.attn_specs(cfg),
            "ln2": _ln_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


def _dec_layer_specs(cfg: ArchConfig):
    return {"ln1": _ln_spec(cfg.d_model), "self_attn": attn.attn_specs(cfg),
            "ln2": _ln_spec(cfg.d_model), "cross_attn": attn.attn_specs(cfg),
            "ln3": _ln_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


def encdec_specs(cfg: ArchConfig) -> dict[str, Any]:
    vp = pad_vocab(cfg.vocab)
    d = cfg.d_model
    return {
        "embed": ParamSpec((vp, d), init="embed"),
        "enc_layers": [stacked(_enc_layer_specs(cfg), cfg.n_enc_layers)] * cfg.n_enc_layers,
        "enc_ln": _ln_spec(d),
        "dec_layers": [stacked(_dec_layer_specs(cfg), cfg.n_layers)] * cfg.n_layers,
        "dec_ln": _ln_spec(d),
        "unembed": ParamSpec((d, vp)),
    }


def _with_positions(x, offset=0):
    """x (b, s, d) in the compute dtype plus the position table from
    ``offset``, the table cast to the compute dtype first (a bf16 sum)."""
    pos = sinusoidal_pos_emb(x.shape[1], x.shape[2], offset, device=x.device)
    return x + pos.to(COMPUTE_DTYPE)


def _enc_layer(pl, x, cfg):
    h = _ln(pl["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(pl["attn"], h, cfg, None, use_rope=False)
    o = attn.chunked_attention(q, k, v, causal=False)
    x = x + attn.attn_output(pl["attn"], o, x.dtype)
    h = _ln(pl["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(pl["mlp"], h, cfg)


def encode(params, cfg: ArchConfig, frames) -> torch.Tensor:
    """frames: (b, enc_len, d) stub embeddings -> (b, enc_len, d); each
    layer checkpointed where a gradient will be taken."""
    x = _with_positions(frames.to(COMPUTE_DTYPE))
    layer = _layer_call(_enc_layer, _grad_taken(params))
    for pl in params["enc_layers"]:
        x = layer(pl, x, cfg)
    return _ln(params["enc_ln"], x, cfg.norm_eps)


def _cross_kv(pl_cross, enc_out):
    return attn._project(enc_out, pl_cross["wk"]), attn._project(enc_out, pl_cross["wv"])


def _dec_layer(pl, x, cfg, enc_out):
    """One decoder layer over the sequence -> (x, (k, v, cross k, cross v))."""
    h = _ln(pl["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(pl["self_attn"], h, cfg, None, use_rope=False)
    o = attn.chunked_attention(q, k, v, causal=True)
    x = x + attn.attn_output(pl["self_attn"], o, x.dtype)
    h = _ln(pl["ln2"], x, cfg.norm_eps)
    q2 = attn._project(h, pl["cross_attn"]["wq"])
    ck, cv = _cross_kv(pl["cross_attn"], enc_out)
    o = attn.chunked_attention(q2, ck, cv, causal=False)
    x = x + attn.attn_output(pl["cross_attn"], o, x.dtype)
    h = _ln(pl["ln3"], x, cfg.norm_eps)
    return x + mlp_apply(pl["mlp"], h, cfg), (k, v, ck, cv)


def _logits(params, cfg, x):
    x = _ln(params["dec_ln"], x, cfg.norm_eps)
    return x @ params["unembed"].to(x.dtype)


def decode_train(params, cfg: ArchConfig, tokens, enc_out) -> torch.Tensor:
    """Teacher-forced decoder forward -> logits (b, s, V); each layer
    checkpointed where a gradient will be taken."""
    x = _with_positions(embed_tokens(params, tokens))
    layer = _layer_call(_dec_layer, _grad_taken(params))
    for pl in params["dec_layers"]:
        x, _ = layer(pl, x, cfg, enc_out)
    return _logits(params, cfg, x)


def encdec_loss(params, cfg: ArchConfig, batch: dict, *, shd=None, remat=False):
    """The mean next-token CE of ``batch["tokens"]`` against
    ``batch["labels"]`` given ``batch["frames"]``; returns (loss, {"ce",
    "aux"}) with aux 0.  It takes a gradient, every layer checkpointed
    whatever ``remat`` says (the reference's rule)."""
    _mesh_free(shd)
    enc_out = encode(params, cfg, batch["frames"])
    logits = decode_train(params, cfg, batch["tokens"], enc_out)
    loss = cross_entropy_loss(logits, batch["labels"], cfg.vocab)
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=loss.device)}


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 dtype=COMPUTE_DTYPE) -> dict:
    """{name: (shape, dtype)}: the self k/v ``(L, b, max_len, kv, hd)`` and
    the cross k/v ``(L, b, enc_len, kv, hd)``, the reference's layout."""
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    self_kv = ((L, batch, max_len, kv, hd), dtype)
    cross = ((L, batch, cfg.enc_len, kv, hd), dtype)
    return {"k": self_kv, "v": self_kv, "cross_k": cross, "cross_v": cross}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=COMPUTE_DTYPE,
               device=None) -> dict:
    """The zeroed caches of ``cache_shapes`` on ``device`` (None: the card)."""
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_shapes(cfg, batch, max_len, dtype).items()}


def encdec_prefill(params, cfg: ArchConfig, frames, tokens, *,
                   max_len: int | None = None, shd=None):
    """Encode ``frames``, then the teacher-forced prompt; returns (the last
    position's logits (b, V), caches).  The self caches are allocated at
    ``max_len`` (default: the prompt length), zero past the prompt; the
    cross caches hold every layer's k/v of the encoder output."""
    _mesh_free(shd)
    enc_out = encode(params, cfg, frames)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=tokens.device)
    x = _with_positions(embed_tokens(params, tokens))
    for li, pl in enumerate(params["dec_layers"]):
        x, (k, v, ck, cv) = _dec_layer(pl, x, cfg, enc_out)
        cache["k"][li, :, :s] = k
        cache["v"][li, :, :s] = v
        cache["cross_k"][li] = ck
        cache["cross_v"][li] = cv
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def encdec_decode_step(params, cfg: ArchConfig, tokens, cache, pos: int, *, shd=None):
    """tokens: (b, 1) at position ``pos`` -> (logits (b, 1, V), cache).  The
    self caches are written at ``pos`` in place (the same dict is
    returned) and read up to ``pos + 1``; the cross caches are read whole."""
    _mesh_free(shd)
    pos = int(pos)
    b = tokens.shape[0]
    dev = tokens.device
    x = _with_positions(embed_tokens(params, tokens), offset=pos)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    enc_len = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32, device=dev)
    for li, pl in enumerate(params["dec_layers"]):
        h = _ln(pl["ln1"], x, cfg.norm_eps)
        q, k, v = attn.project_qkv(pl["self_attn"], h, cfg, None, use_rope=False)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        o = attn.decode_attention(q, kc, vc, cache_len)
        x = x + attn.attn_output(pl["self_attn"], o, x.dtype)
        h = _ln(pl["ln2"], x, cfg.norm_eps)
        q2 = attn._project(h, pl["cross_attn"]["wq"])
        o = attn.decode_attention(q2, cache["cross_k"][li], cache["cross_v"][li], enc_len)
        x = x + attn.attn_output(pl["cross_attn"], o, x.dtype)
        h = _ln(pl["ln3"], x, cfg.norm_eps)
        x = x + mlp_apply(pl["mlp"], h, cfg)
    return _logits(params, cfg, x), cache
