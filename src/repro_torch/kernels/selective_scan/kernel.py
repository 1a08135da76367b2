"""Python wrapper of the hand-written Mamba1 selective-scan kernel
(``csrc/selective_scan.cu``).

The wrapper refuses inputs that require a gradient (the kernel has no
backward; training is a later slice of the port), checks device, dtype,
shape and contiguity, allocates y and, on request, the final state with
``torch.empty``, launches on the current CUDA stream and raises if the
launch was refused.  ``LAUNCHES`` counts its launches.  On CPU tensors
it runs the plain version (``ref.selective_scan_plain``) instead and
counts nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.selective_scan import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 64            # csrc MAX_N

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"selective_scan": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gf_selective_scan.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.gf_selective_scan.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def selective_scan(x, dt, A, B, C, D, *, return_state: bool = False):
    """x/dt: (b, L, d); A: (d, n); B/C: (b, L, n); D: (d,), all float32 ->
    y (b, L, d), or (y, final state (b, d, n)) with ``return_state``."""
    args = (x, dt, A, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "selective_scan has no backward: gradients belong to the training "
            "slice, a later slice of the port")
    dev = x.device
    if dev.type == "cpu":
        return _ref.selective_scan_plain(*args, return_state=return_state)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    b, L, d = x.shape
    n = A.shape[-1]
    if L < 1 or not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: needs L >= 1 and a state of 1 to "
                         f"{MAX_STATE}; got L={L}, n={n}")
    if b > 65535:
        raise ValueError(f"selective_scan: batch {b} exceeds the grid's 65535 rows")
    f32 = (torch.float32,)
    _build.check_tensor(x, "x", dev, f32)
    _build.check_tensor(dt, "dt", dev, f32, (b, L, d))
    _build.check_tensor(A, "A", dev, f32, (d, n))
    _build.check_tensor(B, "B", dev, f32, (b, L, n))
    _build.check_tensor(C, "C", dev, f32, (b, L, n))
    _build.check_tensor(D, "D", dev, f32, (d,))
    handle = lib()
    y = torch.empty_like(x)
    state = (torch.empty((b, d, n), dtype=torch.float32, device=dev)
             if return_state else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = handle.gf_selective_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), y.data_ptr(), None if state is None else state.data_ptr(),
        b, L, d, n, stream)
    _build.check(rc, "selective_scan")
    LAUNCHES["selective_scan"] += 1
    return (y, state) if return_state else y
