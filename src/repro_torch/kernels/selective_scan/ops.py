"""Public op of the Mamba1 selective scan: ``selective_scan_op`` brings
its arguments to the kernel's layout (float32, contiguous), then launches
the CUDA kernel for CUDA tensors or runs the plain version for CPU
tensors.  The Mamba1 block calls ``kernel.mamba1_scan_fused`` directly:
it takes the block's tensors as they are."""
from __future__ import annotations

from repro_torch.kernels.selective_scan import kernel


def selective_scan_op(x, dt, A, B, C, D, *, return_state: bool = False):
    """y (b, L, d), or (y, final state (b, d, n)) with ``return_state``."""
    return kernel.selective_scan(*(t.float().contiguous() for t in (x, dt, A, B, C, D)),
                                 return_state=return_state)
