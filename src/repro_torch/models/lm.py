"""Decoder-only LM assembly for the dense (granite, starcoder2, qwen3,
deepseek), hybrid (zamba2) and ssm (falcon-mamba) families, inference only.

Entry points:
  lm_forward     — forward over a sequence -> logits (b, s, V)
  lm_loss        — the cache-free forward, then next-token CE (+ aux)
  lm_prefill     — forward over a prompt -> (last logits, caches)
  lm_decode_step — single-token step against the caches

A dense layer is pre-norm GQA attention (flash attention over the
sequence, flash-decode against the k/v cache) and a pre-norm MLP.  Zamba2
runs its layers in groups: the shared attention block (input concat(x,
x0) at width 2d, output back to d) once per group, then
``shared_attn_every`` Mamba2 layers.  Falcon-mamba runs its Mamba1
layers one after the other.  The layers are an ``nn.ModuleList`` of
per-layer parameter tables (the reference scans a stacked tree).  The
MoE, VLM and enc-dec families, gradients, remat and sharding (the
reference's ``remat=`` and ``shd=``) belong to later slices of the port
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ParamSpec,
    cross_entropy_loss,
    pad_vocab,
    rms_norm,
    stacked,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.mlp import mlp_apply, mlp_specs

COMPUTE_DTYPE = torch.bfloat16


#: The families the port serves.
FAMILIES = ("dense", "hybrid", "ssm")


def require_served(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port "
            "serves the dense (granite, starcoder2, qwen3, deepseek), hybrid "
            "(zamba2) and ssm (falcon-mamba) families.  The MoE family is the "
            "next slice, then the VLM and enc-dec families"
        )


def _mesh_free(shd=None, remat=False) -> None:
    if shd is not None or remat:
        raise NotImplementedError(
            "sharding (shd=) and remat belong to a later slice of the port: "
            "it runs mesh-free on one card, inference only")


def _norm_spec(d):
    return ParamSpec((d,), init="zeros", cast=False)


def _layer_specs(cfg: ArchConfig) -> dict[str, Any]:
    require_served(cfg)
    if cfg.family == "dense":
        d = cfg.d_model
        return {
            "ln1": _norm_spec(d),
            "attn": attn.attn_specs(cfg),
            "ln2": _norm_spec(d),
            "mlp": mlp_specs(cfg),
        }
    mamba = ssm_mod.mamba1_specs if cfg.family == "ssm" else ssm_mod.mamba2_specs
    return {"ln": _norm_spec(cfg.d_model), "mamba": mamba(cfg)}


def _wide_cfg(cfg: ArchConfig) -> ArchConfig:
    """Zamba2 shared block sees concat(h, x0): attention input width 2d."""
    return dataclasses.replace(cfg, d_model=2 * cfg.d_model, head_dim=cfg.hd)


def _shared_block_specs(cfg: ArchConfig) -> dict[str, Any]:
    d = cfg.d_model
    specs = attn.attn_specs(_wide_cfg(cfg))
    # output projection maps back to d (residual width), not 2d
    specs["wo"] = ParamSpec((cfg.n_heads, cfg.hd, d), fan_in=cfg.n_heads * cfg.hd)
    return {
        "ln1": ParamSpec((2 * d,), init="zeros", cast=False),
        "attn": specs,
        "ln2": _norm_spec(d),
        "mlp": mlp_specs(cfg),
    }


def lm_specs(cfg: ArchConfig) -> dict[str, Any]:
    d = cfg.d_model
    vp = pad_vocab(cfg.vocab)
    layer = stacked(_layer_specs(cfg), cfg.n_layers)
    specs: dict[str, Any] = {
        "embed": ParamSpec((vp, d), init="embed"),
        "final_norm": _norm_spec(d),
        "unembed": ParamSpec((d, vp)),
        "layers": [layer] * cfg.n_layers,
    }
    if cfg.shared_attn_every:
        if cfg.n_layers % cfg.shared_attn_every:
            raise ValueError(f"{cfg.n_layers} layers are not groups of "
                             f"{cfg.shared_attn_every}")
        specs["shared"] = _shared_block_specs(cfg)
    return specs


def n_shared_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


# ---------------------------------------------------------------------------
# layer bodies (full sequence)
# ---------------------------------------------------------------------------


def _attn_block(pl, x, cfg, positions, collect):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    q, k, v = attn.project_qkv(pl["attn"], h, cfg, positions)
    o = attn.chunked_attention(q, k, v, causal=True)
    x = x + attn.attn_output(pl["attn"], o, x.dtype)
    return x, ((k.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE)) if collect else None)


def _dense_layer(pl, x, cfg, positions, collect):
    x, kv = _attn_block(pl, x, cfg, positions, collect)
    h = rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + mlp_apply(pl["mlp"], h, cfg), kv


def _ssm_layer(pl, x, cfg, collect):
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    out, state = ssm_mod.mamba1_apply(pl["mamba"], h, cfg, return_cache=collect)
    return x + out, state


def _hybrid_layer(pl, x, cfg, collect):
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    out, state = ssm_mod.mamba2_apply(pl["mamba"], h, cfg, return_cache=collect)
    return x + out, state


def _shared_block(ps, x, x0, cfg, positions, collect):
    cat = torch.cat([x, x0], dim=-1)
    h = rms_norm(cat, ps["ln1"], cfg.norm_eps)
    q, k, v = attn.project_qkv(ps["attn"], h, _wide_cfg(cfg), positions)
    o = attn.chunked_attention(q, k, v, causal=True)
    x = x + attn.attn_output(ps["attn"], o, x.dtype)
    h2 = rms_norm(x, ps["ln2"], cfg.norm_eps)
    x = x + mlp_apply(ps["mlp"], h2, cfg)
    kv = (k.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE)) if collect else None
    return x, kv


def embed_tokens(params, tokens):
    """(b, s) token ids -> (b, s, d) in the compute dtype (the gathered
    rows are cast, which gives the values of casting the table)."""
    return params["embed"][tokens].to(COMPUTE_DTYPE)


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"].to(x.dtype)


def _backbone(params, cfg: ArchConfig, tokens, cache=None):
    """Embed and run every layer (zamba2: every group); with ``cache``
    (from ``init_cache``), write each dense layer's k/v, each Mamba layer's
    conv tail and state and each shared application's k/v into it.
    Returns the last hidden states (b, s, d)."""
    require_served(cfg)
    x = embed_tokens(params, tokens)
    collect = cache is not None
    s = tokens.shape[1]
    if cfg.family == "dense":
        positions = torch.arange(s, device=tokens.device)[None, :]
        for li in range(cfg.n_layers):
            x, kv = _dense_layer(params["layers"][li], x, cfg, positions, collect)
            if collect:
                cache["k"][li, :, :s] = kv[0]
                cache["v"][li, :, :s] = kv[1]
        return x
    if not cfg.shared_attn_every:
        for li in range(cfg.n_layers):
            x, entry = _ssm_layer(params["layers"][li], x, cfg, collect)
            if collect:
                cache["conv"][li] = entry["conv"]
                cache["h"][li] = entry["h"]
        return x
    positions = torch.arange(s, device=tokens.device)[None, :]
    x0 = x
    every = cfg.shared_attn_every
    for g in range(n_shared_apps(cfg)):
        x, kv = _shared_block(params["shared"], x, x0, cfg, positions, collect)
        if collect:
            cache["shared_k"][g, :, :s] = kv[0]
            cache["shared_v"][g, :, :s] = kv[1]
        for li in range(g * every, (g + 1) * every):
            x, entry = _hybrid_layer(params["layers"][li], x, cfg, collect)
            if collect:
                cache["conv"][li] = entry["conv"]
                cache["h"][li] = entry["h"]
    return x


def lm_forward(params, cfg: ArchConfig, tokens, *, shd=None, remat=False):
    """tokens (b, s) -> logits (b, s, V)."""
    _mesh_free(shd, remat)
    return _logits(params, cfg, _backbone(params, cfg, tokens))


def lm_loss(params, cfg: ArchConfig, batch: dict, *, shd=None, remat=False):
    """The cache-free forward over ``batch["tokens"]``, then the mean
    next-token CE over ``batch["labels"]`` (positions labelled -1 do not
    count) plus 0.01 x the MoE aux loss, which is 0 for the families the
    port serves.  Returns (loss, {"ce", "aux"}).  Forward only: parameters
    that require a gradient raise (the trainer is a later slice)."""
    _mesh_free(shd, remat)
    if torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters()):
        raise NotImplementedError(
            "gradients belong to the training slice, a later slice of the port: "
            "lm_loss runs the forward only")
    logits = lm_forward(params, cfg, batch["tokens"])
    ce = cross_entropy_loss(logits, batch["labels"], cfg.vocab)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=COMPUTE_DTYPE,
               device=None):
    """Zeroed serving caches on ``device`` (None: the CUDA card).  Dense:
    per layer the k/v at ``max_len``, ``(L, b, max_len, kv, hd)``.  Mamba:
    per layer the conv tail and the state; zamba2 adds the shared block's
    k/v at ``max_len``, which falcon-mamba does not use."""
    require_served(cfg)
    device = resolve_device(device)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if cfg.family == "dense":
        return {name: torch.zeros((L, batch, max_len, kv, hd), dtype=dtype,
                                  device=device) for name in ("k", "v")}
    init = ssm_mod.mamba1_init_cache if cfg.family == "ssm" else ssm_mod.mamba2_init_cache
    c = init(cfg, batch, dtype, device)
    base = {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in c.items()}
    if cfg.family == "ssm":
        return base
    napp = n_shared_apps(cfg)
    for name in ("shared_k", "shared_v"):
        base[name] = torch.zeros((napp, batch, max_len, kv, hd), dtype=dtype,
                                 device=device)
    return base


def extend_cache(cfg: ArchConfig, cache: dict, max_len: int) -> dict:
    """Pad the seq-indexed cache buffers with zeros out to max_len."""
    out = {}
    for name, arr in cache.items():
        if name in ("k", "v", "shared_k", "shared_v"):
            pad = torch.zeros(arr.shape[:2] + (max_len - arr.shape[2],) + arr.shape[3:],
                              dtype=arr.dtype, device=arr.device)
            arr = torch.cat([arr, pad], dim=2)
        out[name] = arr
    return out


def lm_prefill(params, cfg: ArchConfig, tokens, *, max_len: int | None = None,
               shd=None):
    """Forward over a prompt; returns (last-position logits (b, V), cache).

    The cache is allocated at ``max_len`` (default: the prompt length),
    with the seq-indexed buffers zero past the prompt, as the reference's
    ``extend_cache`` leaves them."""
    _mesh_free(shd)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=tokens.device)
    x = _backbone(params, cfg, tokens, cache)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def _decode_attn(p_attn, x_norm, kc, vc, pos, positions, cache_len, qk_cfg):
    q, k, v = attn.project_qkv(p_attn, x_norm, qk_cfg, positions)
    # the reference's iota-select write: one position, in place here
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    o = attn.decode_attention(q, kc, vc, cache_len)
    return attn.attn_output(p_attn, o, x_norm.dtype)


def lm_decode_step(params, cfg: ArchConfig, tokens, cache, pos: int, *, shd=None):
    """tokens: (b, 1); pos: the position being written -> (logits (b, 1, V),
    cache).  The cache is updated in place (the same dict is returned):
    every dense layer's k/v at ``pos``; every Mamba layer's conv tail and
    state, and (zamba2) the shared block's k/v at ``pos``."""
    require_served(cfg)
    _mesh_free(shd)
    x = embed_tokens(params, tokens)
    if cfg.family == "ssm":
        for li in range(cfg.n_layers):
            pl = params["layers"][li]
            hh = rms_norm(x, pl["ln"], cfg.norm_eps)
            out, c2 = ssm_mod.mamba1_decode_step(
                pl["mamba"], hh, {"conv": cache["conv"][li], "h": cache["h"][li]}, cfg)
            cache["conv"][li] = c2["conv"]
            cache["h"][li] = c2["h"]
            x = x + out
        return _logits(params, cfg, x), cache
    pos = int(pos)
    b = tokens.shape[0]
    x0 = x
    positions = torch.full((1, 1), pos, device=tokens.device)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=tokens.device)
    if cfg.family == "dense":
        for li in range(cfg.n_layers):
            pl = params["layers"][li]
            h = rms_norm(x, pl["ln1"], cfg.norm_eps)
            x = x + _decode_attn(pl["attn"], h, cache["k"][li], cache["v"][li], pos,
                                 positions, cache_len, cfg)
            h = rms_norm(x, pl["ln2"], cfg.norm_eps)
            x = x + mlp_apply(pl["mlp"], h, cfg)
        return _logits(params, cfg, x), cache
    every = cfg.shared_attn_every
    ps = params["shared"]
    for g in range(n_shared_apps(cfg)):
        cat = torch.cat([x, x0], dim=-1)
        hh = rms_norm(cat, ps["ln1"], cfg.norm_eps)
        x = x + _decode_attn(ps["attn"], hh, cache["shared_k"][g], cache["shared_v"][g],
                             pos, positions, cache_len, _wide_cfg(cfg))
        h2 = rms_norm(x, ps["ln2"], cfg.norm_eps)
        x = x + mlp_apply(ps["mlp"], h2, cfg)
        for li in range(g * every, (g + 1) * every):
            pl = params["layers"][li]
            hh = rms_norm(x, pl["ln"], cfg.norm_eps)
            out, c2 = ssm_mod.mamba2_decode_step(
                pl["mamba"], hh, {"conv": cache["conv"][li], "h": cache["h"][li]}, cfg)
            cache["conv"][li] = c2["conv"]
            cache["h"][li] = c2["h"]
            x = x + out
    return _logits(params, cfg, x), cache
