"""Python wrapper of the hand-written split-K flash-decode kernel
(``csrc/decode_attention.cu``).

The wrapper checks device, dtype, shape, contiguity and 16-byte
alignment, allocates the output and the per-split partials with
``torch.empty``, launches both passes on the current CUDA stream and
raises if a launch was refused.  ``LAUNCHES`` counts wrapper calls that
reach the kernel (one per call: the partial pass and its combine).  On
CPU tensors it runs the plain version (``ref.decode_attention_plain``)
instead and counts nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.decode_attention import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 64, 80, 128)
DTYPES = (torch.bfloat16, torch.float32)
MAX_GROUP = 16            # query heads per kv head (csrc MAXG)
SPLIT = 256               # cache entries per split of the partial pass
MAX_SMEM_BYTES = 232448   # an H100 block's dynamic shared memory limit

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"decode_attention": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_decode_smem.argtypes = [I, I]
    lib.gf_decode_smem.restype = ctypes.c_size_t
    lib.gf_decode_attention.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, P]
    lib.gf_decode_attention.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (b, 1, h, d); caches: (b, S, kv, d); cache_len: (b,) int32 ->
    (b, 1, h, d) in q's dtype.  Entries at or past ``cache_len`` are
    ignored."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.decode_attention_plain(q, k_cache, v_cache, cache_len)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    b, one, h, d = q.shape
    _, S, kvh, _ = k_cache.shape
    if one != 1:
        raise ValueError(f"decode_attention takes one query token, got {one}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    if kvh < 1 or h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h} heads over {kvh} kv heads "
                         f"(a group of at most {MAX_GROUP})")
    if S < 1:
        raise ValueError("decode_attention: empty cache")
    _build.check_tensor(q, "q", dev, DTYPES)
    _build.check_tensor(k_cache, "k_cache", dev, (q.dtype,), (b, S, kvh, d), 16)
    _build.check_tensor(v_cache, "v_cache", dev, (q.dtype,), (b, S, kvh, d), 16)
    _build.check_tensor(cache_len, "cache_len", dev, (torch.int32,), (b,))
    handle = lib()
    smem = handle.gf_decode_smem(h // kvh, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention needs {smem} B of shared memory")
    nsplit = -(-S // SPLIT)
    part_m = torch.empty((b, h, nsplit), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, nsplit, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = handle.gf_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        b, S, h, kvh, d, SPLIT, int(q.dtype == torch.bfloat16), d ** -0.5, stream,
    )
    _build.check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
