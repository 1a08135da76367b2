"""Python wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``).

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current CUDA stream and
raises if the launch was refused.  ``LAUNCHES`` counts its launches.  On
CPU tensors it runs the plain version (``ref.attention_plain``) instead
and counts nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.flash_attention import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 64, 80, 128)
DTYPES = (torch.bfloat16, torch.float32)

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"flash_attention": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_flash_attention.argtypes = [P] * 4 + [I] * 7 + [ctypes.c_float, I, P]
    lib.gf_flash_attention.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d), h % kv == 0 -> (b, sq, h, d)
    in q's dtype.  Causal masking is aligned bottom-right and needs
    sq <= sk."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {h} heads are not a multiple of {kvh} kv heads")
    if sq < 1 or sk < 1:
        raise ValueError("flash_attention: empty sequence")
    if causal and sq > sk:
        raise ValueError(f"flash_attention: causal needs sq <= sk, got {sq} > {sk}")
    _build.check_tensor(q, "q", dev, DTYPES)
    _build.check_tensor(k, "k", dev, (q.dtype,), (b, sk, kvh, d))
    _build.check_tensor(v, "v", dev, (q.dtype,), (b, sk, kvh, d))
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib().gf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, sk, h, kvh, d, int(q.dtype == torch.bfloat16), d ** -0.5,
        int(causal), stream,
    )
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
