"""Python wrappers of the hand-written Mamba1 selective-scan kernels
(``csrc/selective_scan.cu``, one CUDA design in two forms, and the fused
form's gradient, ``csrc/selective_scan_bwd.cu``):

- ``selective_scan``: the reference's interface, float32 in and out;
- ``mamba1_scan_fused``: the Mamba1 block's work from the ``dt_w`` product
  to ``out_proj`` (the dt_b add and softplus, the scan, D*x, the SiLU
  gate and the bf16 cast) in one launch, reading bf16 inputs through the
  strided views the projections leave.  Where a gradient will be taken
  it applies ``Mamba1ScanFused``, a ``torch.autograd.Function`` whose
  backward runs ``mamba1_scan_fused_bwd`` (the backward kernel on the
  card, the plain reverse recurrence on the CPU).

``selective_scan`` refuses inputs that require a gradient: the model
trains through the fused form, and the f32 form, off its path, has no
backward.  The wrappers check device, dtype, shape, strides and alignment
(the kernel reads rows as 16-byte vectors), allocate y and, on request,
the final state with ``torch.empty``, launch on the current CUDA stream
and raise if the launch was refused.
``selective_scan`` takes any d, as the reference's interface does: where
d is not a multiple of the kernel's 4-float vector, or a row does not
start on 16 bytes, it runs on zero-padded copies (a zero channel stays
zero) and returns the first d channels.
``LAUNCHES`` counts the launches of each form and the backward's calls
(``mamba1_scan_bwd``: one a call, for its two kernels).  On CPU tensors
they run the plain versions (``ref.selective_scan_plain``,
``ref.mamba1_scan_fused_plain``, ``ref.mamba1_scan_fused_plain_bwd``)
instead and count nothing.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels.selective_scan import ref as _ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
BWD_SOURCE = SOURCE.with_name("selective_scan_bwd.cu")
MAX_STATE = 64            # csrc MAX_N

#: Kernel launches per form (plain-version calls are not counted).
LAUNCHES = {"selective_scan": 0, "mamba1_scan_fused": 0, "mamba1_scan_bwd": 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_mamba1_scan.argtypes = (
        [I] + [P, LL, LL] * 3 + [P, LL, LL] * 2 + [P] * 5 + [I] * 4 + [P])
    lib.gf_mamba1_scan.restype = I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_mamba1_scan_bwd_scratch.argtypes = [I] * 4
    lib.gf_mamba1_scan_bwd_scratch.restype = LL
    lib.gf_mamba1_scan_bwd.argtypes = [P, LL, LL] * 5 + [P] * 13 + [I] * 4 + [P]
    lib.gf_mamba1_scan_bwd.restype = I


def lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def bwd_lib() -> ctypes.CDLL:
    return _build.load(BWD_SOURCE, _bind_bwd)


def _grad_taken(args) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in args)


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
    if _grad_taken(args):
        raise NotImplementedError(
            "selective_scan (the reference's f32 interface, off the model's path) "
            "has no backward: the model trains through mamba1_scan_fused, whose "
            "backward kernel is csrc/selective_scan_bwd.cu")
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
    """The Mamba1 block from the ``dt_w`` product to ``out_proj`` (see
    ``_mamba1_scan_fused``), differentiable: where a gradient will be taken
    it runs through ``Mamba1ScanFused`` (no final state then: the trainer
    drops it)."""
    args = (xc, dt_raw, dt_b, A, B, C, D, z)
    if _grad_taken(args):
        if return_state:
            raise ValueError("mamba1_scan_fused: the final state takes no gradient; "
                             "ask for it without one (serving)")
        return Mamba1ScanFused.apply(*args)
    return _mamba1_scan_fused(*args, return_state=return_state)


def _mamba1_scan_fused(xc, dt_raw, dt_b, A, B, C, D, z, *, return_state: bool = False):
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


class Mamba1ScanFused(torch.autograd.Function):
    """``_mamba1_scan_fused`` without the final state; the backward runs
    ``mamba1_scan_fused_bwd`` on the saved inputs."""

    @staticmethod
    def forward(ctx, xc, dt_raw, dt_b, A, B, C, D, z):
        ctx.save_for_backward(xc, dt_raw, dt_b, A, B, C, D, z)
        return _mamba1_scan_fused(xc, dt_raw, dt_b, A, B, C, D, z)

    @staticmethod
    def backward(ctx, dy):
        return mamba1_scan_fused_bwd(*ctx.saved_tensors, dy.contiguous())


def mamba1_scan_fused_bwd(xc, dt_raw, dt_b, A, B, C, D, z, dy):
    """The gradient of ``mamba1_scan_fused``: dy (b, L, d) in y's dtype ->
    (dxc, ddt_raw, ddt_b, dA, dB, dC, dD, dz), each in its input's shape
    and dtype (contiguous)."""
    dev = xc.device
    if dev.type == "cpu":
        return _ref.mamba1_scan_fused_plain_bwd(xc, dt_raw, dt_b, A, B, C, D, z, dy)
    if dev.type != "cuda":
        raise ValueError(f"mamba1_scan_fused_bwd: unsupported device {dev}")
    b, L, d = xc.shape
    n = A.shape[-1]
    _check_sizes("mamba1_scan_fused_bwd", b, L, d, n)
    bf16, f32 = torch.bfloat16, (torch.float32,)
    for name, t in (("xc", xc), ("dt_raw", dt_raw), ("z", z)):
        _check_rows(t, name, dev, bf16, (b, L, d))
    _check_rows(B, "B", dev, bf16, (b, L, n))
    _check_rows(C, "C", dev, bf16, (b, L, n))
    _build.check_tensor(dy, "dy", dev, (bf16,), (b, L, d))
    _build.check_tensor(A, "A", dev, f32, (d, n))
    _build.check_tensor(dt_b, "dt_b", dev, f32, (d,))
    _build.check_tensor(D, "D", dev, f32, (d,))
    handle = bwd_lib()
    scratch = torch.empty(handle.gf_mamba1_scan_bwd_scratch(b, L, d, n),
                          dtype=torch.float32, device=dev)
    dxc, ddt, dz = (torch.empty((b, L, d), dtype=bf16, device=dev) for _ in range(3))
    dB, dC = (torch.empty((b, L, n), dtype=bf16, device=dev) for _ in range(2))
    dA = torch.empty((d, n), dtype=torch.float32, device=dev)
    dD, ddt_b = (torch.empty((d,), dtype=torch.float32, device=dev) for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = handle.gf_mamba1_scan_bwd(
        xc.data_ptr(), xc.stride(0), xc.stride(1),
        dt_raw.data_ptr(), dt_raw.stride(0), dt_raw.stride(1),
        z.data_ptr(), z.stride(0), z.stride(1),
        B.data_ptr(), B.stride(0), B.stride(1),
        C.data_ptr(), C.stride(0), C.stride(1),
        dy.data_ptr(), A.data_ptr(), D.data_ptr(), dt_b.data_ptr(),
        dxc.data_ptr(), ddt.data_ptr(), dz.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dA.data_ptr(), dD.data_ptr(), ddt_b.data_ptr(), scratch.data_ptr(),
        b, L, d, n, stream)
    _build.check(rc, "mamba1_scan_fused_bwd")
    LAUNCHES["mamba1_scan_bwd"] += 1
    return dxc, ddt, ddt_b, dA, dB, dC, dD, dz
