"""Public op: flash attention.  Brings the arguments to the kernel's
layout (contiguous) and calls the wrapper, which launches the CUDA kernel
for CUDA tensors and runs the plain version for CPU tensors."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (b, sq, h, d); k/v: (b, sk, kv, d) -> (b, sq, h, d)."""
    return kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal)
