"""Decoder-only LM assembly, the hybrid family (zamba2), inference only.

Entry points:
  lm_forward     — forward over a sequence -> logits (b, s, V)
  lm_prefill     — forward over a prompt -> (last logits, caches)
  lm_decode_step — single-token step against the caches

Zamba2 runs its layers in groups: the shared attention block (input
concat(x, x0) at width 2d, output back to d) once per group, then
``shared_attn_every`` Mamba2 layers.  The layers are an
``nn.ModuleList`` of per-layer parameter tables (the reference scans a
stacked tree).  The other families, the training loss, remat and
sharding (the reference's ``remat=`` and ``shd=``) belong to later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamSpec, pad_vocab, rms_norm, stacked
from repro_torch.models.config import ArchConfig
from repro_torch.models.mlp import mlp_apply, mlp_specs

COMPUTE_DTYPE = torch.bfloat16


def require_hybrid(cfg: ArchConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port "
            "serves the hybrid family (zamba2).  falcon-mamba's cache-free "
            "forward is the next slice, then the dense, MoE, VLM and enc-dec "
            "families"
        )


def _mesh_free(shd=None, remat=False) -> None:
    if shd is not None or remat:
        raise NotImplementedError(
            "sharding (shd=) and remat belong to a later slice of the port: "
            "it runs mesh-free on one card, inference only")


def _norm_spec(d):
    return ParamSpec((d,), init="zeros", cast=False)


def _layer_specs(cfg: ArchConfig) -> dict[str, Any]:
    require_hybrid(cfg)
    return {"ln": _norm_spec(cfg.d_model), "mamba": ssm_mod.mamba2_specs(cfg)}


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
    """Embed and run every group; with ``cache`` (from ``init_cache``),
    write each layer's conv tail and state and each shared application's
    k/v into it.  Returns the last hidden states (b, s, d)."""
    require_hybrid(cfg)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = embed_tokens(params, tokens)
    x0 = x
    every = cfg.shared_attn_every
    collect = cache is not None
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


def lm_loss(*args, **kwargs):
    raise NotImplementedError("lm_loss (training) belongs to a later slice of the port")


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=COMPUTE_DTYPE,
               device="cpu"):
    require_hybrid(cfg)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    c = ssm_mod.mamba2_init_cache(cfg, batch, dtype, device)
    base = {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in c.items()}
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
    the token's k/v at ``pos`` and every layer's conv tail and state."""
    require_hybrid(cfg)
    _mesh_free(shd)
    pos = int(pos)
    b = tokens.shape[0]
    x = embed_tokens(params, tokens)
    x0 = x
    positions = torch.full((1, 1), pos, device=tokens.device)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=tokens.device)
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
