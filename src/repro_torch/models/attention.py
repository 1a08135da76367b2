"""GQA attention: params, the prefill path and the decode path.

Prefill attention goes to the flash-attention op and decode attention to
the flash-decode op: hand-written CUDA kernels on the card, their plain
versions on the CPU (``repro_torch.kernels``).  The projections are
``torch.matmul`` with the weights cast to the activation dtype at use.

Under a mesh (``shd``, a ``ShardCtx`` with one) q, k and v are placed at
the reference's sites, and flash runs on each rank's local shards
through ``local_map``, in the two layouts ``ctx_for`` gives:

- head_tp: q sharded on its heads, k/v replicated on those axes; a rank
  takes the kv heads of its q heads' GQA groups, and its k/v gradient is
  a partial sum over the ranks;
- seq_cp: q sharded on the sequence; k/v are gathered along those axes
  first, and the rank's queries run against the keys up to its block's
  end, which flash's bottom-right causal alignment (sq <= sk) makes exact
  causal attention.  The gathered k/v's gradient returns through the
  gather's backward.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.sharding import (
    NULL_CTX,
    ShardCtx,
    mesh_coord,
    partial_on,
    placements,
)
from repro_torch.kernels.decode_attention.ops import decode_attention as _decode_op
from repro_torch.kernels.flash_attention.ops import flash_attention as _flash_op
from repro_torch.models.common import ParamSpec, proj, rms_norm, rope
from repro_torch.models.config import ArchConfig


def attn_specs(cfg: ArchConfig) -> dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, h, hd), axes=("embed", "heads", None)),
        "wk": ParamSpec((d, kv, hd), axes=("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kv, hd), axes=("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), fan_in=h * hd, axes=("heads", None, "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), init="zeros", cast=False, axes=(None,))
        specs["k_norm"] = ParamSpec((hd,), init="zeros", cast=False, axes=(None,))
    return specs


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, heads, hd = w.shape
    return proj(x, w.to(x.dtype).reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def project_qkv(p, x, cfg: ArchConfig, positions, use_rope: bool = True,
                shd: ShardCtx = NULL_CTX):
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
    # "seq" vs "heads" follows the strategy (ShardCtx.overrides):
    #   head_tp: heads -> model, seq replicated; seq_cp: seq -> model
    q = shd.act(q, "batch", "seq", "heads", None)
    k = shd.act(k, "batch", "seq", "kv_heads", None)
    v = shd.act(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool, shd: ShardCtx = NULL_CTX):
    """q: (b, sq, h, hd); k/v: (b, sk, kv, hd) -> (b, sq, h, hd), through
    the flash-attention op (the reference's kernel route); under a mesh on
    each rank's shards."""
    if shd.mesh is None:
        return _flash_op(q, k, v, causal=causal)
    return shd.act(_sharded_flash(q, k, v, causal, shd), "batch", "seq", "heads", None)


def _sharded_flash(q, k, v, causal: bool, shd: ShardCtx):
    """Flash on each rank's local shards (head_tp or seq_cp, module doc)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = shd.mesh
    qs = shd.spec_for_shape(("batch", "seq", "heads", None), q.shape)
    ks = shd.spec_for_shape(("batch", "seq", "kv_heads", None), k.shape)
    if ks[2] is not None or qs[3] is not None:
        raise NotImplementedError(f"flash under a mesh with kv heads sharded ({ks})")
    if qs[1] is not None and qs[2] is not None:
        raise NotImplementedError(f"flash under a mesh with heads and seq sharded ({qs})")
    qp = placements(mesh, qs)
    kvp = placements(mesh, (qs[0], None, None, None))
    kv_grad = kvp
    h, kvh = q.shape[2], k.shape[2]
    group = h // kvh
    if qs[2] is not None:                          # head_tp
        r, n = mesh_coord(mesh, qs[2])
        kv_grad = partial_on(mesh, kvp, qs[2])
        hl = h // n
        j0 = r * hl

        def body(ql, kl, vl):
            if hl % group == 0:
                sel = slice(j0 // group, j0 // group + hl // group)
                kl, vl = kl[:, :, sel], vl[:, :, sel]
            elif group % hl == 0:
                sel = slice(j0 // group, j0 // group + 1)
                kl, vl = kl[:, :, sel], vl[:, :, sel]
            else:
                idx = torch.div(torch.arange(j0, j0 + hl, device=kl.device), group,
                                rounding_mode="floor")
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
            return _flash_op(ql, kl, vl, causal=causal)
    elif qs[1] is not None:                        # seq_cp
        r, n = mesh_coord(mesh, qs[1])
        kv_grad = partial_on(mesh, kvp, qs[1])
        keys = (r + 1) * (q.shape[1] // n) if causal else k.shape[1]
        if causal and q.shape[1] != k.shape[1]:
            raise NotImplementedError("seq_cp flash needs sq == sk")

        def body(ql, kl, vl):
            return _flash_op(ql, kl[:, :keys], vl[:, :keys], causal=causal)
    else:                                          # the batch alone
        def body(ql, kl, vl):
            return _flash_op(ql, kl, vl, causal=causal)
    # local_map reads a tuple as one placement list an output: one output
    # takes a list
    return local_map(body, out_placements=list(qp),
                     in_placements=(list(qp), list(kvp), list(kvp)),
                     in_grad_placements=(list(qp), list(kv_grad), list(kv_grad)),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention against a (b, S, kv, hd) cache, through the
    flash-decode op; entries at or past ``cache_len`` are ignored."""
    return _decode_op(q, k_cache, v_cache, cache_len)


def attn_output(p, o: torch.Tensor, x_dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, hd, d = p["wo"].shape
    return proj(o.flatten(-2), p["wo"].to(x_dtype).reshape(h * hd, d))
