"""Python wrappers of the hand-written flash-attention kernels: the
forward (``csrc/flash_attention.cu``) and the backward
(``csrc/flash_attention_bwd.cu``).

Each wrapper checks device, dtype, shape, contiguity and (bf16) 16-byte
alignment, allocates its outputs with ``torch.empty``, launches on the
current CUDA stream and raises if a launch was refused.  The dtype picks
the route before the launch: bf16 runs the tensor-core kernels, f32 the
CUDA-core ones (f32 products keep the f32 tolerance).  ``LAUNCHES``
counts the forward's launches (``flash_attention``) and the backward's
calls (``flash_attention_bwd``: one a call, for its three kernels).  On
CPU tensors they run the plain versions (``ref.attention_plain``,
``ref.attention_plain_lse``, ``ref.attention_plain_bwd``) instead and
count nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.flash_attention import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (16, 64, 80, 128)
DTYPES = (torch.bfloat16, torch.float32)

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_flash_smem.argtypes = [I, I]
    lib.gf_flash_smem.restype = ctypes.c_size_t
    lib.gf_flash_attention.argtypes = [P] * 4 + [I] * 7 + [ctypes.c_float, I, P, P]
    lib.gf_flash_attention.restype = I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_flash_attention_bwd.argtypes = [P] * 10 + [I] * 7 + [ctypes.c_float, I, P]
    lib.gf_flash_attention_bwd.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def bwd_lib() -> ctypes.CDLL:
    return _build.load(BWD_SOURCE, _bind_bwd)


def _check_shapes(name, q, k, v, causal):
    """(b, sq, sk, h, kvh, d) of the inputs, or raise on what the kernels
    do not take."""
    dev = q.device
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{name}: {h} heads are not a multiple of {kvh} kv heads")
    if sq < 1 or sk < 1:
        raise ValueError(f"{name}: empty sequence")
    if causal and sq > sk:
        raise ValueError(f"{name}: causal needs sq <= sk, got {sq} > {sk}")
    # the bf16 route copies 16-byte chunks with cp.async
    align = 16 if q.dtype == torch.bfloat16 else 1
    _build.check_tensor(q, "q", dev, DTYPES, align=align)
    _build.check_tensor(k, "k", dev, (q.dtype,), (b, sk, kvh, d), align)
    _build.check_tensor(v, "v", dev, (q.dtype,), (b, sk, kvh, d), align)
    return b, sq, sk, h, kvh, d


def flash_attention(q, k, v, *, causal: bool = True, return_lse: bool = False):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d), h % kv == 0 -> (b, sq, h, d)
    in q's dtype, and with ``return_lse`` each row's log-sum-exp of the
    scaled scores, f32 (b, h, sq), natural log (what the backward reads).
    Causal masking is aligned bottom-right and needs sq <= sk."""
    dev = q.device
    if dev.type == "cpu":
        if return_lse:
            return _ref.attention_plain_lse(q, k, v, causal=causal)
        return _ref.attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, sq, sk, h, kvh, d = _check_shapes("flash_attention", q, k, v, causal)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib().gf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, sk, h, kvh, d, int(q.dtype == torch.bfloat16), d ** -0.5,
        int(causal), lse.data_ptr() if return_lse else None, stream,
    )
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention`` in the inputs'
    dtype, from its inputs, its output ``o``, its ``lse`` (f32 (b, h, sq))
    and the output's gradient ``do``; dk and dv sum over each kv head's
    group of query heads."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {dev}")
    b, sq, sk, h, kvh, d = _check_shapes("flash_attention_bwd", q, k, v, causal)
    align = 16 if q.dtype == torch.bfloat16 else 1
    _build.check_tensor(o, "o", dev, (q.dtype,), q.shape, align)
    _build.check_tensor(do, "do", dev, (q.dtype,), q.shape, align)
    _build.check_tensor(lse, "lse", dev, (torch.float32,), (b, h, sq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bwd_lib().gf_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, kvh, d, int(q.dtype == torch.bfloat16), d ** -0.5,
        int(causal), stream,
    )
    _build.check(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
