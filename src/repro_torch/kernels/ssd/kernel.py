"""Python wrapper of the hand-written Mamba2 SSD kernel (``csrc/ssd.cu``).

The wrapper checks device, dtype, shape and contiguity, allocates y and
the final state with ``torch.empty``, launches on the current CUDA
stream and raises if the launch was refused.  ``LAUNCHES`` counts its
launches.  On CPU tensors it runs the plain version (``ref.ssd_plain``,
the sequential recurrence) instead and counts nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ssd import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd.cu"
MAX_SMEM_BYTES = 232448   # an H100 block's dynamic shared memory limit

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"ssd": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_ssd_smem.argtypes = [I, I, I]
    lib.gf_ssd_smem.restype = ctypes.c_size_t
    lib.gf_ssd.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.gf_ssd.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def ssd(xdt, loga, B, C, *, chunk: int = 128):
    """xdt = x*dt: (b, L, nh, hd); loga = dt*A: (b, L, nh); B/C: (b, L, n),
    all float32 -> (y (b, L, nh, hd), final state (b, nh, n, hd)).  The
    plain version ignores ``chunk``: the recurrence is the same function."""
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
