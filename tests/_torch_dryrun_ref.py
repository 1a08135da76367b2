"""The reference's dry-run beside the port's, for the cells the fleet
examples' jobs name (granite-3-2b ``train_4k`` and ``decode_32k``,
qwen3-14b ``prefill_32k``, zamba2-2.7b ``decode_32k``).

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices
when it is imported, so it runs in a process of its own: this script.  For
each cell it lowers and compiles the reference's step on its single-pod
mesh (``lower_cell(arch, shape, False)``, 256 devices) and fits its cost
to the depth (``extrapolate_cost``), then counts the port's step on one
card (``repro_torch.launch.dryrun.count_cell``) and prints one JSON line a
cell: the reference's per-device ``flops_extrap`` and ``bytes_extrap`` times
its 256 devices beside the port's one-card FLOPs and bytes, and their
ratios::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_dryrun_ref.py [ARCH:SHAPE ...]

The two stacks define the counts differently (``repro_torch/launch/
dryrun.py``'s docstring): XLA counts a FLOP for every elementwise result
and the bytes of its fused kernels; the port counts the matmul-class ops'
FLOPs and every unfused op's bytes, and the kernels' work by
``launch/costs.py``.  Minutes on the CPU (granite's train cell the most).
"""
from __future__ import annotations

import json
import sys
import time

from repro.launch import dryrun as ref_dryrun  # sets XLA_FLAGS before jax starts

CELLS = ["granite-3-2b:train_4k", "granite-3-2b:decode_32k", "qwen3-14b:prefill_32k",
         "zamba2-2.7b:decode_32k"]


def main(cells) -> None:
    import torch

    from repro_torch.launch import dryrun as port_dryrun
    torch.set_num_threads(1)
    for cell in cells:
        arch, shape = cell.split(":")
        t0 = time.perf_counter()
        res = ref_dryrun.lower_cell(arch, shape, False, verbose=False)
        ex = ref_dryrun.extrapolate_cost(arch, shape, False)
        ref_s = time.perf_counter() - t0
        port = port_dryrun.count_cell(arch, shape)
        n = res["n_devices"]
        ref_flops, ref_bytes = ex["flops_extrap"] * n, ex["bytes_extrap"] * n
        print(json.dumps({
            "cell": cell, "ref_devices": n,
            "ref_flops_extrap_per_device": ex["flops_extrap"],
            "ref_bytes_extrap_per_device": ex["bytes_extrap"],
            "ref_flops_x_devices": ref_flops, "ref_bytes_x_devices": ref_bytes,
            "ref_collective_bytes_per_device": res["collective_bytes_per_device"],
            "ref_s": round(ref_s, 2),
            "port_flops": port["flops_per_device"], "port_bytes":
                port["bytes_accessed_per_device"],
            "port_kernel_flops": port["kernel_flops"], "port_count_s": port["count_s"],
            "flops_ratio": port["flops_per_device"] / ref_flops,
            "bytes_ratio": port["bytes_accessed_per_device"] / ref_bytes}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or CELLS)
