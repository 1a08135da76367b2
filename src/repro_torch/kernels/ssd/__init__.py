"""Mamba2 chunked SSD (state-space dual) on pre-weighted inputs, CUDA
C++ for sm_90a in ``csrc/ssd.cu``: its products on the tensor cores as
3xTF32."""
