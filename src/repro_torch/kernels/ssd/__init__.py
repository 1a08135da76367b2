"""Mamba2 chunked SSD (state-space dual) on pre-weighted inputs, CUDA
C++ for sm_90a in ``csrc/ssd.cu``."""
