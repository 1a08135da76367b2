"""Python wrappers of the hand-written Mamba1 selective-scan kernel
(``csrc/selective_scan.cu``), one CUDA design in two forms:

- ``selective_scan``: the reference's interface, float32 in and out;
- ``mamba1_scan_fused``: the Mamba1 block's work from the ``dt_w`` product
  to ``out_proj`` (the dt_b add and softplus, the scan, D*x, the SiLU
  gate and the bf16 cast) in one launch, reading bf16 inputs through the
  strided views the projections leave.

The wrappers refuse inputs that require a gradient (the kernel has no
backward; training is a later slice of the port), check device, dtype,
shape, strides and alignment (the kernel reads rows as 16-byte vectors),
allocate y and, on request, the final state with ``torch.empty``, launch
on the current CUDA stream and raise if the launch was refused.
``selective_scan`` takes any d, as the reference's interface does: where
d is not a multiple of the kernel's 4-float vector, or a row does not
start on 16 bytes, it runs on zero-padded copies (a zero channel stays
zero) and returns the first d channels.
``LAUNCHES`` counts the launches of each form.  On CPU tensors they run
the plain versions (``ref.selective_scan_plain``,
``ref.mamba1_scan_fused_plain``) instead and count nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels.selective_scan import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 64            # csrc MAX_N

#: Kernel launches per form (plain-version calls are not counted).
LAUNCHES = {"selective_scan": 0, "mamba1_scan_fused": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_mamba1_scan.argtypes = (
        [I] + [P, LL, LL] * 3 + [P, LL, LL] * 2 + [P] * 5 + [I] * 4 + [P])
    lib.gf_mamba1_scan.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _refuse_grad(name, args) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            f"{name} has no backward: gradients belong to the training slice, "
            f"a later slice of the port")


def _check_rows(t, name: str, dev, dtype, shape, vec: int = 1) -> None:
    """Raise unless ``t`` is a ``shape`` tensor of ``dtype`` on ``dev``
    whose last stride is 1; with ``vec`` > 1 its rows must start on 16
    bytes (the kernel reads them as 16-byte vectors of ``vec`` elements)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride in its last dimension")
    if vec > 1 and (t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1])):
        raise ValueError(f"{name} rows must start on 16 bytes (the kernel reads "
                         f"16-byte vectors)")


def _check_sizes(name, b, L, d, n, vec=1) -> None:
    if L < 1 or not 1 <= n <= MAX_STATE:
        raise ValueError(f"{name}: needs L >= 1 and a state of 1 to {MAX_STATE}; "
                         f"got L={L}, n={n}")
    if b > 65535:
        raise ValueError(f"{name}: batch {b} exceeds the grid's 65535 rows")
    if d % vec:
        raise ValueError(f"{name}: needs d a multiple of {vec} (16-byte rows of the "
                         f"kernel's vectors); got d={d}")


def _launch(fused, x, dt, z, B, C, A, D, dt_b, y, state, b, L, d, n):
    """One launch of the kernel on checked tensors."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    zz = z if z is not None else x
    rc = lib().gf_mamba1_scan(
        int(fused),
        x.data_ptr(), x.stride(0), x.stride(1),
        dt.data_ptr(), dt.stride(0), dt.stride(1),
        zz.data_ptr() if z is not None else None, zz.stride(0), zz.stride(1),
        B.data_ptr(), B.stride(0), B.stride(1),
        C.data_ptr(), C.stride(0), C.stride(1),
        A.data_ptr(), D.data_ptr(), None if dt_b is None else dt_b.data_ptr(),
        y.data_ptr(), None if state is None else state.data_ptr(),
        b, L, d, n, stream)
    _build.check(rc, "mamba1_scan_fused" if fused else "selective_scan")


def selective_scan(x, dt, A, B, C, D, *, return_state: bool = False):
    """x/dt: (b, L, d); A: (d, n); B/C: (b, L, n); D: (d,), all float32 ->
    y (b, L, d), or (y, final state (b, d, n)) with ``return_state``."""
    args = (x, dt, A, B, C, D)
    _refuse_grad("selective_scan", args)
    dev = x.device
    if dev.type == "cpu":
        return _ref.selective_scan_plain(*args, return_state=return_state)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    b, L, d = x.shape
    n = A.shape[-1]
    _check_sizes("selective_scan", b, L, d, n)
    f32 = (torch.float32,)
    _build.check_tensor(x, "x", dev, f32)
    _build.check_tensor(dt, "dt", dev, f32, (b, L, d))
    _build.check_tensor(A, "A", dev, f32, (d, n))
    _build.check_tensor(B, "B", dev, f32, (b, L, n))
    _build.check_tensor(C, "C", dev, f32, (b, L, n))
    _build.check_tensor(D, "D", dev, f32, (d,))
    pad = -d % 4
    if pad or x.data_ptr() % 16 or dt.data_ptr() % 16:
        # fresh copies start on 16 bytes; a padded channel (dt = A = D = 0)
        # keeps a zero state and a zero y
        x, dt, D = (F.pad(t, (0, pad)) for t in (x, dt, D))
        A = F.pad(A, (0, 0, 0, pad))
    y = torch.empty_like(x)
    state = (torch.empty((b, d + pad, n), dtype=torch.float32, device=dev)
             if return_state else None)
    _launch(False, x, dt, None, B, C, A, D, None, y, state, b, L, d + pad, n)
    LAUNCHES["selective_scan"] += 1
    if pad:
        y = y[..., :d].contiguous()
        state = state[:, :d].contiguous() if return_state else None
    return (y, state) if return_state else y


def mamba1_scan_fused(xc, dt_raw, dt_b, A, B, C, D, z, *, return_state: bool = False):
    """The Mamba1 block from the ``dt_w`` product to ``out_proj``:

        (scan(xc.float(), softplus(dt_raw.float() + dt_b), A, B.float(),
              C.float(), D) * silu(z.float())).to(bf16)

    xc, dt_raw, z: (b, L, d) bf16; B, C: (b, L, n) bf16; dt_b, D: (d,) and
    A = -exp(A_log): (d, n) float32.  z, B and C may be the strided views
    that ``chunk`` and ``split`` of the projections give (the last stride
    1); nothing is copied.  Returns y (b, L, d) bf16, and with
    ``return_state`` also the final state (b, d, n) float32.
    """
    args = (xc, dt_raw, dt_b, A, B, C, D, z)
    _refuse_grad("mamba1_scan_fused", args)
    dev = xc.device
    if dev.type == "cpu":
        return _ref.mamba1_scan_fused_plain(*args, return_state=return_state)
    if dev.type != "cuda":
        raise ValueError(f"mamba1_scan_fused: unsupported device {dev}")
    b, L, d = xc.shape
    n = A.shape[-1]
    _check_sizes("mamba1_scan_fused", b, L, d, n, 8)
    bf16, f32 = torch.bfloat16, (torch.float32,)
    for name, t in (("xc", xc), ("dt_raw", dt_raw), ("z", z)):
        _check_rows(t, name, dev, bf16, (b, L, d), vec=8)
    _check_rows(B, "B", dev, bf16, (b, L, n))
    _check_rows(C, "C", dev, bf16, (b, L, n))
    _build.check_tensor(A, "A", dev, f32, (d, n))
    _build.check_tensor(dt_b, "dt_b", dev, f32, (d,))
    _build.check_tensor(D, "D", dev, f32, (d,))
    y = torch.empty((b, L, d), dtype=bf16, device=dev)
    state = (torch.empty((b, d, n), dtype=torch.float32, device=dev)
             if return_state else None)
    _launch(True, xc, dt_raw, z, B, C, A, D, dt_b, y, state, b, L, d, n)
    LAUNCHES["mamba1_scan_fused"] += 1
    return (y, state) if return_state else y
