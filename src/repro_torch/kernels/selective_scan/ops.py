"""Public op: the Mamba1 selective scan.  Brings the arguments to the
kernel's layout (float32, contiguous) and calls the wrapper, which
launches the CUDA kernel for CUDA tensors and runs the plain version for
CPU tensors."""
from __future__ import annotations

from repro_torch.kernels.selective_scan import kernel


def selective_scan_op(x, dt, A, B, C, D, *, return_state: bool = False):
    """y (b, L, d), or (y, final state (b, d, n)) with ``return_state``."""
    return kernel.selective_scan(*(t.float().contiguous() for t in (x, dt, A, B, C, D)),
                                 return_state=return_state)
