"""Public op: decode attention.  Brings the arguments to the kernel's
layout (contiguous tensors, ``cache_len`` as int32 on the query's
device) and calls the wrapper, which launches the CUDA kernel for CUDA
tensors and runs the plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (b, 1, h, d); caches: (b, S, kv, d); cache_len: (b,) -> (b, 1, h, d)."""
    lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32).contiguous()
    return kernel.decode_attention(q.contiguous(), k_cache.contiguous(),
                                   v_cache.contiguous(), lens)
