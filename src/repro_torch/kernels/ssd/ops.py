"""Public op: the Mamba2 SSD on pre-weighted inputs.  Brings the
arguments to the kernel's layout (float32, contiguous) and calls the
wrapper, which launches the CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors."""
from __future__ import annotations

from repro_torch.kernels.ssd import kernel


def ssd_op(xdt, loga, B, C, *, chunk: int = 128):
    """Pre-weighted form: xdt = x*dt, loga = dt*A.  Returns (y, final state)."""
    return kernel.ssd(*(t.float().contiguous() for t in (xdt, loga, B, C)),
                      chunk=chunk)
