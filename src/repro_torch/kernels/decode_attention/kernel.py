"""Python wrapper of the hand-written split-K flash-decode kernel
(``csrc/decode_attention.cu``).

The wrapper checks device, dtype, shape, contiguity and 16-byte
alignment, plans the splits (``plan_splits``), allocates the output and
the per-split partials with ``torch.empty``, launches on the current CUDA
stream and raises if a launch was refused.  The dtype picks the route
before the launch: bf16 runs the tensor-core kernel, f32 the CUDA-core
kernel (f32 products keep the f32 tolerance); a second launch merges the
splits.  ``LAUNCHES`` counts wrapper calls that reach the kernel (one per
call: the partial pass and its combine).  On CPU tensors it runs the
plain version (``ref.decode_attention_plain``) instead and counts
nothing.  On ``meta`` tensors it checks the inputs as the card's route
does and returns a ``meta`` output, adding its launch and work
(``launch/costs.py``, the whole cache taken as live: the dry-run decodes
at its last position) to the dry-run's count (``kernels/meta.py``);
outside a count it raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.decode_attention import ref as _ref
from repro_torch.launch import costs as _costs

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 64, 80, 128)
DTYPES = (torch.bfloat16, torch.float32)
MAX_GROUP = 16            # query heads per kv head (csrc MAXG)
TILE = 64                 # keys a stage of the bf16 kernel's ring (csrc TILE)
MIN_TILES = 4             # a split walks at least this many tiles
SMS = 132                 # streaming multiprocessors of an H100 SXM
WAVES = 8                 # the grid fills every SM at least this many times
MAX_SMEM_BYTES = 232448   # an H100 block's dynamic shared memory limit

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"decode_attention": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_decode_smem.argtypes = [I, I, I]
    lib.gf_decode_smem.restype = ctypes.c_size_t
    lib.gf_decode_attention.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, P]
    lib.gf_decode_attention.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def plan_splits(b: int, S: int, h: int, kvh: int, d: int) -> dict:
    """How the partial pass cuts a (b, S, kvh, d) cache: ``split`` keys a
    split (whole tiles, at least ``MIN_TILES``), ``nsplit`` splits covering
    [0, S) exactly once, ``ctas`` = b * kvh * nsplit (at least ``WAVES``
    per SM where the cache is long enough), and the float32 workspace
    shapes of the per-split partials (m, l, acc)."""
    tiles = -(-S // TILE)
    want = -(-WAVES * SMS // (b * kvh))        # splits per (row, kv head)
    per = min(tiles, max(MIN_TILES, -(-tiles // want)))
    split = per * TILE
    nsplit = -(-S // split)
    return {"split": split, "nsplit": nsplit, "ctas": b * kvh * nsplit,
            "part_m": (b, h, nsplit), "part_l": (b, h, nsplit),
            "part_acc": (b, h, nsplit, d)}


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (b, 1, h, d); caches: (b, S, kv, d); cache_len: (b,) int32 ->
    (b, 1, h, d) in q's dtype.  Entries at or past ``cache_len`` are
    ignored."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.decode_attention_plain(q, k_cache, v_cache, cache_len)
    if dev.type == "meta":
        _meta.require("decode_attention")
    elif dev.type != "cuda":
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
    if dev.type == "meta":
        _meta.launch("decode_attention", *_costs.attention_bound(
            b, 1, S, h, kvh, d, q.element_size(), False))
        return torch.empty_like(q)
    handle = lib()
    is_bf16 = int(q.dtype == torch.bfloat16)
    smem = handle.gf_decode_smem(h // kvh, d, is_bf16)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention needs {smem} B of shared memory")
    plan = plan_splits(b, S, h, kvh, d)
    part_m, part_l, part_acc = (torch.empty(plan[k], dtype=torch.float32, device=dev)
                                for k in ("part_m", "part_l", "part_acc"))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = handle.gf_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        b, S, h, kvh, d, plan["split"], is_bf16, d ** -0.5, stream,
    )
    _build.check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
