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
count nothing.  On ``meta`` tensors they check the inputs as the card's
route does and return ``meta`` outputs, adding their launch and work
(``launch/costs.py``) to the dry-run's count (``kernels/meta.py``); outside
a count they raise.

The backward's route and scratch follow ``bwd_plan``, a pure function
(CPU-tested): bf16 at head_dim 64, 80 and 128 takes the wgmma kernel,
whose scratch holds the padded lse and D rows, an f32 dQ accumulator and
one counter a (batch, head, query tile) beside the work counter; bf16 at
16 takes the mma.sync kernels and f32 the CUDA-core ones, with D alone.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.launch import costs as _costs

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
    lib.gf_flash_attention_bwd_workspace.argtypes = [I] * 7
    lib.gf_flash_attention_bwd_workspace.restype = ctypes.c_size_t


#: The backward's key tile on the wgmma route (two consumer warpgroups of 64)
BWD_KEY_TILE = 128


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call runs (``bwd_plan``).  ``route`` is "wgmma"
    (bf16, head_dim 64, 80 or 128), "mma_sync" (bf16, 16) or "f32".
    On the wgmma route: ``bq`` queries a streamed tile (128 at head_dim
    64, 64 at 80 and 128), ``bk`` keys a work item, ``n_qt`` query tiles
    and ``n_kt`` key tiles, and the scratch's parts in 4-byte words from
    its start (lse * log2(e) and D, (b, h, sq_pad) each; the dQ
    accumulator, f32 ``acc_shape`` = (b, h, n_qt, bq, d), each query
    tile's bq x d in the kernel's fragment order; the counters,
    ``cnt_shape``, then the work counter)."""
    route: str
    b: int
    sq: int
    sk: int
    h: int
    kvh: int
    d: int
    causal: bool
    bq: int = 0
    bk: int = 0
    n_qt: int = 0
    n_kt: int = 0
    sq_pad: int = 0
    acc_shape: tuple = ()
    cnt_shape: tuple = ()
    offsets: dict = dataclasses.field(default_factory=dict)
    workspace_bytes: int = 0

    def items(self) -> list[tuple[int, int, int]]:
        """The work items (key tile, kv head, batch) in the order the
        persistent grid hands them out: ascending key tile."""
        per = self.kvh * self.b
        return [(n // per, n % per % self.kvh, n % per // self.kvh)
                for n in range(self.n_kt * per)]

    def first_query_tile(self, j: int) -> int:
        """The first query tile that sees key tile ``j``'s keys."""
        if not self.causal:
            return 0
        return max(0, j * self.bk - (self.sk - self.sq)) // self.bq

    def steps(self, j: int, kvi: int) -> list[tuple[int, int]]:
        """Item (j, kvi, .)'s (query tile, head) in walking order: query
        tiles from the last down, the group's heads inside."""
        grp = self.h // self.kvh
        return [(t, kvi * grp + g) for t in range(self.n_qt - 1, self.first_query_tile(j) - 1, -1)
                for g in range(grp)]


def bwd_plan(b, sq, sk, h, kvh, d, dtype, causal=True) -> BwdPlan:
    """The backward's route by (head_dim, dtype), and on the wgmma route
    its tiles, its scratch and its order (what ``csrc/flash_attention_bwd.cu``
    computes as ``workspace``); elsewhere the scratch is D, (b, h, sq) f32."""
    if dtype == torch.bfloat16 and d in (64, 80, 128):
        bq, bk = (128 if d == 64 else 64), BWD_KEY_TILE
        n_qt, n_kt = -(-sq // bq), -(-sk // bk)
        sq_pad = n_qt * bq
        offsets = {"lse2": 0, "dsum": b * h * sq_pad, "acc": 2 * b * h * sq_pad}
        offsets["cnt"] = offsets["acc"] + b * h * sq_pad * d
        offsets["work"] = offsets["cnt"] + b * h * n_qt
        return BwdPlan("wgmma", b, sq, sk, h, kvh, d, causal, bq, bk, n_qt, n_kt, sq_pad,
                       (b, h, n_qt, bq, d), (b, h, n_qt), offsets, 4 * (offsets["work"] + 1))
    route = "mma_sync" if dtype == torch.bfloat16 else "f32"
    return BwdPlan(route, b, sq, sk, h, kvh, d, causal, workspace_bytes=4 * b * h * sq)


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
    if dev.type == "meta":
        _meta.require("flash_attention")
    elif dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, sq, sk, h, kvh, d = _check_shapes("flash_attention", q, k, v, causal)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    if dev.type == "meta":
        _meta.launch("flash_attention", *_costs.attention_bound(
            b, sq, sk, h, kvh, d, q.element_size(), causal, lse=return_lse))
        return (o, lse) if return_lse else o
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
    if dev.type == "meta":
        _meta.require("flash_attention_bwd")
    elif dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {dev}")
    b, sq, sk, h, kvh, d = _check_shapes("flash_attention_bwd", q, k, v, causal)
    align = 16 if q.dtype == torch.bfloat16 else 1
    _build.check_tensor(o, "o", dev, (q.dtype,), q.shape, align)
    _build.check_tensor(do, "do", dev, (q.dtype,), q.shape, align)
    _build.check_tensor(lse, "lse", dev, (torch.float32,), (b, h, sq))
    if dev.type == "meta":
        _meta.launch("flash_attention_bwd", *_costs.flash_bwd_bound(
            b, sq, sk, h, kvh, d, q.element_size(), causal))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    is_bf16 = int(q.dtype == torch.bfloat16)
    plan = bwd_plan(b, sq, sk, h, kvh, d, q.dtype, causal)
    bl = bwd_lib()
    if bl.gf_flash_attention_bwd_workspace(b, sq, sk, h, kvh, d, is_bf16) != plan.workspace_bytes:
        raise RuntimeError("flash_attention_bwd: the library's scratch size is not the plan's")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    work = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bl.gf_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, kvh, d, is_bf16, d ** -0.5, int(causal), stream,
    )
    _build.check(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
