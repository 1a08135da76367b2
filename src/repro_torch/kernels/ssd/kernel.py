"""Python wrappers of the hand-written Mamba2 SSD kernels: the forward
(``csrc/ssd.cu``) and its gradient (``csrc/ssd_bwd.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (and the backward's scratch) with ``torch.empty``, launches on the
current CUDA stream and raises if a launch was refused.  ``LAUNCHES``
counts the forward's launches (``ssd``) and the backward's calls
(``ssd_bwd``: one a call, for its three kernels).  On CPU tensors they run
the plain versions (``ref.ssd_plain``, the sequential recurrence, and
``ref.ssd_plain_bwd``, its reverse recurrence) instead and count nothing.
The wrappers take no part in autograd: ``ssd`` refuses inputs that
require a gradient, and ``ops.ssd_op`` is the differentiable op.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ssd import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd.cu"
BWD_SOURCE = SOURCE.with_name("ssd_bwd.cu")
MAX_SMEM_BYTES = 232448   # an H100 block's dynamic shared memory limit
#: The backward's chunk sizes, the largest whose shared memory fits first
BWD_CHUNKS = (64, 32, 16)

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"ssd": 0, "ssd_bwd": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_ssd_smem.argtypes = [I, I, I]
    lib.gf_ssd_smem.restype = ctypes.c_size_t
    lib.gf_ssd.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.gf_ssd.restype = I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_ssd_bwd_smem.argtypes = [I, I, I]
    lib.gf_ssd_bwd_smem.restype = ctypes.c_size_t
    lib.gf_ssd_bwd_scratch.argtypes = [I] * 6
    lib.gf_ssd_bwd_scratch.restype = ctypes.c_longlong
    lib.gf_ssd_bwd.argtypes = [P] * 11 + [I] * 6 + [P]
    lib.gf_ssd_bwd.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def bwd_lib() -> ctypes.CDLL:
    return _build.load(BWD_SOURCE, _bind_bwd)


def ssd(xdt, loga, B, C, *, chunk: int = 128):
    """xdt = x*dt: (b, L, nh, hd); loga = dt*A: (b, L, nh); B/C: (b, L, n),
    all float32 -> (y (b, L, nh, hd), final state (b, nh, n, hd)).  The
    plain version ignores ``chunk``: the recurrence is the same function."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, loga, B, C)):
        raise ValueError("ssd: the kernel wrapper takes no part in autograd; take "
                         "gradients through ops.ssd_op")
    dev = xdt.device
    if dev.type == "cpu":
        return _ref.ssd_plain(xdt, loga, B, C)
    if dev.type != "cuda":
        raise ValueError(f"ssd: unsupported device {dev}")
    b, L, nh, hd = xdt.shape
    n = B.shape[-1]
    if L < 1 or hd % 16 or not 16 <= hd <= 128 or not 1 <= n <= 128:
        raise ValueError(f"ssd: needs L >= 1, head_dim a multiple of 16 up to "
                         f"128 and state up to 128; got L={L}, hd={hd}, n={n}")
    if chunk % 16 or not 16 <= chunk <= 128:
        raise ValueError(f"ssd: chunk must be a multiple of 16 up to 128, got {chunk}")
    f32 = (torch.float32,)
    _build.check_tensor(xdt, "xdt", dev, f32, align=16)
    _build.check_tensor(loga, "loga", dev, f32, (b, L, nh))
    _build.check_tensor(B, "B", dev, f32, (b, L, n))
    _build.check_tensor(C, "C", dev, f32, (b, L, n))
    handle = lib()
    smem = handle.gf_ssd_smem(chunk, n, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd needs {smem} B of shared memory for chunk {chunk}, "
                         f"state {n}, head_dim {hd}; a block has {MAX_SMEM_BYTES}")
    y = torch.empty_like(xdt)
    state = torch.empty((b, nh, n, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = handle.gf_ssd(xdt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
                       y.data_ptr(), state.data_ptr(), b, L, nh, hd, n, chunk, stream)
    _build.check(rc, "ssd")
    LAUNCHES["ssd"] += 1
    return y, state


def ssd_bwd(xdt, loga, B, C, dy, dS=None):
    """The gradient of ``ssd`` from a zero state: dy (b, L, nh, hd) and the
    final state's gradient dS (b, nh, n, hd), or None for zero, all float32
    -> (dxdt, dloga, dB, dC) in the inputs' shapes."""
    dev = xdt.device
    if dev.type == "cpu":
        return _ref.ssd_plain_bwd(xdt, loga, B, C, dy, dS)
    if dev.type != "cuda":
        raise ValueError(f"ssd_bwd: unsupported device {dev}")
    b, L, nh, hd = xdt.shape
    n = B.shape[-1]
    if L < 1 or not 1 <= hd <= 128 or not 1 <= n <= 128:
        raise ValueError(f"ssd_bwd: needs L >= 1, head_dim and state up to 128; got "
                         f"L={L}, hd={hd}, n={n}")
    f32 = (torch.float32,)
    _build.check_tensor(xdt, "xdt", dev, f32)
    _build.check_tensor(loga, "loga", dev, f32, (b, L, nh))
    _build.check_tensor(B, "B", dev, f32, (b, L, n))
    _build.check_tensor(C, "C", dev, f32, (b, L, n))
    _build.check_tensor(dy, "dy", dev, f32, (b, L, nh, hd))
    if dS is not None:
        _build.check_tensor(dS, "dS", dev, f32, (b, nh, n, hd))
    handle = bwd_lib()
    fits = [q for q in BWD_CHUNKS if handle.gf_ssd_bwd_smem(q, n, hd) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"ssd_bwd: state {n} and head_dim {hd} do not fit a block's "
                         f"shared memory")
    q = fits[0]
    scratch = torch.empty(handle.gf_ssd_bwd_scratch(b, L, nh, hd, n, q),
                          dtype=torch.float32, device=dev)
    dxdt, dloga = torch.empty_like(xdt), torch.empty_like(loga)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = handle.gf_ssd_bwd(
        xdt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
        None if dS is None else dS.data_ptr(), dxdt.data_ptr(), dloga.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(), b, L, nh, hd, n, q, stream)
    _build.check(rc, "ssd_bwd")
    LAUNCHES["ssd_bwd"] += 1
    return dxdt, dloga, dB, dC
