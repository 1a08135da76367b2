"""Decoder-only LM assembly for the dense (granite, starcoder2, qwen3,
deepseek), MoE (moonshot, llama4-scout), VLM (internvl2), hybrid (zamba2)
and ssm (falcon-mamba) families: serving, and the loss's gradient (the
trainer, ``launch/train.py``), for all five.

Entry points:
  lm_forward     — forward over a sequence -> logits (b, s, V)
  lm_loss        — the cache-free forward, then next-token CE (+ aux)
  lm_prefill     — forward over a prompt -> (last logits, caches)
  lm_decode_step — single-token step against the caches

A dense layer is pre-norm GQA attention (flash attention over the
sequence, flash-decode against the k/v cache) and a pre-norm MLP; an MoE
layer has the same attention and a pre-norm top-k MoE (``models/moe.py``)
in place of the MLP, whose aux losses the loss sums; a VLM is the dense
stack with its first ``n_vision_tokens`` positions taken by precomputed
vision embeddings (``vision_embeds``; the reference stubs the ViT).  Zamba2
runs its layers in groups: the shared attention block (input concat(x,
x0) at width 2d, output back to d) once per group, then
``shared_attn_every`` Mamba2 layers.  Falcon-mamba runs its Mamba1
layers one after the other.  The layers are an ``nn.ModuleList`` of
per-layer parameter tables (the reference scans a stacked tree).  The
enc-dec family (whisper) is served by ``models/encdec.py``, routed there
by the registry; this module's entry points refuse it.

Every family's loss takes a gradient: flash attention's autograd op
launches its backward kernel, the SSD's (``kernels/ssd/ops.py``) and the
fused Mamba1 scan's (``kernels/selective_scan/kernel.py``) theirs, the
MoE's einsums and ``bmm`` differentiate in plain PyTorch (the reference
has no MoE kernel), as do the convs, norms and gates around the scans.
``remat=True`` (the reference's default in its ``lm_loss``) wraps each
layer in ``torch.utils.checkpoint``, the counterpart of its
``jax.checkpoint(layer_body, policy=nothing_saveable)``; an MoE layer's
checkpoint returns its aux loss with its output, as the reference's scan
carries it; zamba2's groups (the shared block and its
``shared_attn_every`` Mamba2 layers) are checkpointed too, around the
checkpointed layers, as the reference nests ``group_body``'s checkpoint
around ``layer_body``'s.  Sharding (the reference's ``shd=``) belongs to
a later slice of the port and raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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


#: The families the port serves and trains (enc-dec through
#: ``models/encdec.py``).
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")
#: The families whose layers are attention and a feed-forward block, with
#: a k/v cache per layer.
_ATTN_FAMILIES = ("dense", "moe", "vlm")


def require_served(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the port "
            "serves the dense (granite, starcoder2, qwen3, deepseek), MoE "
            "(moonshot, llama4-scout), VLM (internvl2), hybrid (zamba2), ssm "
            "(falcon-mamba) and enc-dec (whisper) families"
        )


def _decoder_only(cfg: ArchConfig) -> None:
    """Serve ``cfg`` here, or raise: the enc-dec family has its own module."""
    require_served(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec family is served by models/encdec.py "
            "(get_api routes it there), not by the decoder-only models/lm.py")


def _grad_taken(params) -> bool:
    """Whether a gradient will be taken: grad mode on and a parameter that
    requires one (the trainer's float32 masters)."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())


def _layer_call(fn, remat: bool):
    """``fn`` itself, or with ``remat`` ``fn`` under a non-reentrant
    checkpoint: its activations dropped after the forward and recomputed
    in the backward."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _mesh_free(shd=None) -> None:
    if shd is not None:
        raise NotImplementedError(
            "sharding (shd=) belongs to a later slice of the port: it runs "
            "mesh-free on one card")


def _norm_spec(d):
    return ParamSpec((d,), init="zeros", cast=False)


def _layer_specs(cfg: ArchConfig) -> dict[str, Any]:
    _decoder_only(cfg)
    if cfg.family in _ATTN_FAMILIES:
        d = cfg.d_model
        specs = {"ln1": _norm_spec(d), "attn": attn.attn_specs(cfg), "ln2": _norm_spec(d)}
        if cfg.family == "moe":
            specs["moe"] = moe_mod.moe_specs(cfg)
        else:
            specs["mlp"] = mlp_specs(cfg)
        return specs
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


def _moe_layer(pl, x, cfg, positions, collect):
    """Returns (x, aux, kv): the layer's output, its float32 aux loss and
    (with ``collect``) its k/v."""
    x, kv = _attn_block(pl, x, cfg, positions, collect)
    h = rms_norm(x, pl["ln2"], cfg.norm_eps)
    out, aux = moe_mod.moe_apply(pl["moe"], h, cfg)
    return x + out, aux, kv


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


def embed_tokens(params, tokens, cfg=None, vision_embeds=None):
    """(b, s) token ids -> (b, s, d) in the compute dtype.  The table is
    cast and then gathered, as the reference does: with bf16 weights the
    cast is a no-op, and with float32 masters the gradient is the
    reference's (the rows' gradients summed in bf16, then cast to
    float32).  For a VLM config with ``vision_embeds`` (b, nv, d), the
    first nv positions are the vision embeddings, cast to the compute
    dtype."""
    x = params["embed"].to(COMPUTE_DTYPE)[tokens]
    if cfg is not None and cfg.family == "vlm" and vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(COMPUTE_DTYPE), x[:, nv:]], dim=1)
    return x


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"].to(x.dtype)


def _backbone(params, cfg: ArchConfig, tokens, cache=None, vision_embeds=None,
              remat=False):
    """Embed and run every layer (zamba2: every group); with ``cache``
    (from ``init_cache``), write each attention layer's k/v, each Mamba
    layer's conv tail and state and each shared application's k/v into it.
    With ``remat`` each layer is checkpointed: its activations are dropped
    after the forward and recomputed in the backward (an MoE layer routes
    the same tokens to the same experts again: its router and dispatch are
    deterministic); zamba2's groups are checkpointed around their
    checkpointed layers, so the backward recomputes a group, then each of
    its layers again.
    Returns the last hidden states (b, s, d) and the MoE layers' summed aux
    loss (float32; 0 for the other families)."""
    _decoder_only(cfg)
    x = embed_tokens(params, tokens, cfg, vision_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    collect = cache is not None
    s = tokens.shape[1]
    if cfg.family in _ATTN_FAMILIES:
        positions = torch.arange(s, device=tokens.device)[None, :]
        layer = _layer_call(_moe_layer if cfg.family == "moe" else _dense_layer, remat)
        for li in range(cfg.n_layers):
            out = layer(params["layers"][li], x, cfg, positions, collect)
            if cfg.family == "moe":
                x, aux_i, kv = out
                aux = aux + aux_i
            else:
                x, kv = out
            if collect:
                cache["k"][li, :, :s] = kv[0]
                cache["v"][li, :, :s] = kv[1]
        return x, aux
    if not cfg.shared_attn_every:
        layer = _layer_call(_ssm_layer, remat)
        for li in range(cfg.n_layers):
            x, entry = layer(params["layers"][li], x, cfg, collect)
            if collect:
                cache["conv"][li] = entry["conv"]
                cache["h"][li] = entry["h"]
        return x, aux
    positions = torch.arange(s, device=tokens.device)[None, :]
    x0 = x
    every = cfg.shared_attn_every
    layer = _layer_call(_hybrid_layer, remat)

    def group_body(x, g):
        x, kv = _shared_block(params["shared"], x, x0, cfg, positions, collect)
        entries = []
        for li in range(g * every, (g + 1) * every):
            x, entry = layer(params["layers"][li], x, cfg, collect)
            entries.append(entry)
        return x, kv, entries

    group = _layer_call(group_body, remat)
    for g in range(n_shared_apps(cfg)):
        x, kv, entries = group(x, g)
        if collect:
            cache["shared_k"][g, :, :s] = kv[0]
            cache["shared_v"][g, :, :s] = kv[1]
            for li, entry in zip(range(g * every, (g + 1) * every), entries):
                cache["conv"][li] = entry["conv"]
                cache["h"][li] = entry["h"]
    return x, aux


def lm_forward(params, cfg: ArchConfig, tokens, *, shd=None, remat=False,
               vision_embeds=None):
    """tokens (b, s) -> logits (b, s, V); a VLM's ``vision_embeds`` (b,
    nv, d) take its first nv positions; ``remat`` checkpoints each layer
    (and zamba2's groups)."""
    _mesh_free(shd)
    x, _ = _backbone(params, cfg, tokens, vision_embeds=vision_embeds, remat=remat)
    return _logits(params, cfg, x)


def lm_loss(params, cfg: ArchConfig, batch: dict, *, shd=None, remat=False):
    """The cache-free forward over ``batch["tokens"]`` (and a VLM's
    ``batch["vision_embeds"]``), then the mean next-token CE over
    ``batch["labels"]`` (positions labelled -1 do not count) plus 0.01 x
    the MoE layers' summed aux loss (0 for the other families).  Returns
    (loss, {"ce", "aux"}).  The loss takes a gradient, with ``remat``
    checkpointing each layer (and zamba2's groups)."""
    _mesh_free(shd)
    x, aux = _backbone(params, cfg, batch["tokens"],
                       vision_embeds=batch.get("vision_embeds"), remat=remat)
    ce = cross_entropy_loss(_logits(params, cfg, x), batch["labels"], cfg.vocab)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 dtype=COMPUTE_DTYPE) -> dict:
    """{name: (shape, dtype)} of the serving caches, the reference's
    layout.  Attention families: per layer the k/v at ``max_len``, ``(L,
    b, max_len, kv, hd)``.  Mamba: per layer the conv tail and the state;
    zamba2 adds the shared block's k/v at ``max_len``, which falcon-mamba
    does not use."""
    _decoder_only(cfg)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kv_shape = ((L, batch, max_len, kv, hd), dtype)
    if cfg.family in _ATTN_FAMILIES:
        return {"k": kv_shape, "v": kv_shape}
    per = ssm_mod.mamba1_cache_shapes if cfg.family == "ssm" \
        else ssm_mod.mamba2_cache_shapes
    out = {k: ((L,) + shape, dt) for k, (shape, dt) in per(cfg, batch, dtype).items()}
    if cfg.family == "hybrid":
        napp = n_shared_apps(cfg)
        out["shared_k"] = out["shared_v"] = ((napp, batch, max_len, kv, hd), dtype)
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=COMPUTE_DTYPE,
               device=None):
    """The zeroed serving caches of ``cache_shapes`` on ``device`` (None:
    the CUDA card)."""
    shapes = cache_shapes(cfg, batch, max_len, dtype)
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


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
               shd=None, vision_embeds=None):
    """Forward over a prompt (a VLM's ``vision_embeds`` taking its first
    positions); returns (last-position logits (b, V), cache).

    The cache is allocated at ``max_len`` (default: the prompt length),
    with the seq-indexed buffers zero past the prompt, as the reference's
    ``extend_cache`` leaves them."""
    _mesh_free(shd)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=tokens.device)
    x, _ = _backbone(params, cfg, tokens, cache, vision_embeds)
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
    every attention layer's k/v at ``pos``; every Mamba layer's conv tail
    and state, and (zamba2) the shared block's k/v at ``pos``.  An MoE
    layer routes the step's b tokens as a group of one token each (capacity
    ``top_k``), so it never drops a token; its aux loss is not kept."""
    _decoder_only(cfg)
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
    if cfg.family in _ATTN_FAMILIES:
        for li in range(cfg.n_layers):
            pl = params["layers"][li]
            h = rms_norm(x, pl["ln1"], cfg.norm_eps)
            x = x + _decode_attn(pl["attn"], h, cache["k"][li], cache["v"][li], pos,
                                 positions, cache_len, cfg)
            h = rms_norm(x, pl["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                ff, _ = moe_mod.moe_apply(pl["moe"], h, cfg)
            else:
                ff = mlp_apply(pl["mlp"], h, cfg)
            x = x + ff
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
