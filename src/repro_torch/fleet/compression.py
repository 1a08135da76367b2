"""Gradient compression for pod-crossing reductions (the reference's
``fleet/compression.py``) on tensors.

int8 quantization with one scale a leaf and error feedback: the residual
is carried into the next step so the compression is unbiased over time.
Trees are dicts of tensors ({name: tensor}, nested dicts allowed) or a
``Params`` module (its named parameters).  ``psum_compressed`` is the
compressed all-reduce over one axis of a ``DeviceMesh``, in the
reference's arithmetic: the int8 values summed as int32, the scales'
maximum, and the sum times that maximum over the group's size (not the
mean of the dequantized gradients where the scales differ).
"""
from __future__ import annotations

import torch


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale): scale = max(|g|max, 1e-12) / 127,
    values round(g / scale) (half to even) clipped to +-127."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _named(tree) -> dict:
    return dict(tree.named_parameters()) if isinstance(tree, torch.nn.Module) else tree


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compress_tree(grads, error):
    """Returns (quantized tree, scales tree, new error-feedback tree): each
    leaf's gradient plus its carried error is quantized, and what the
    quantization lost is the next error."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, s = quantize(g)
        return q, s, g - dequantize(q, s)

    out = _map(one, _named(grads), _named(error))
    return tuple(_map(lambda t, i=i: t[i], out) for i in range(3))


def psum_compressed(grads, error, mesh, axis_name: str):
    """The compressed all-reduce of ``grads`` (with ``error``'s feedback)
    over ``mesh``'s axis ``axis_name``: returns (the average tree, the new
    error tree).  Three collectives a leaf: SUM of the int8 values as
    int32 (safe for groups under 2^23), MAX of the scales, and the group's
    size; then ``q_sum * s_max / n`` in float32."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    q, s, err = compress_tree(grads, error)

    def one(qq, ss):
        q32 = qq.to(torch.int32)
        dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
        s_max = ss.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        return q32.to(torch.float32) * s_max / n

    return _map(one, q, s), err


def init_error(params):
    """Zero float32 error feedback shaped as each leaf of ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                _named(params))
