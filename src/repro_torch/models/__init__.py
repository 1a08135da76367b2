"""The model stack: configs, parameters, layers and the LM assembly.

The hybrid family (zamba2) runs here, inference only: prefill and
decode.  Attention and the Mamba2 SSD go through the hand-written
kernels in ``repro_torch.kernels``; projections and the MLP are
``torch.matmul``.
"""
