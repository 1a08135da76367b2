"""Placement kernels: the fused score+argmin (``score_fleet``) and the
fused window greedy (``greedy_window``), CUDA C++ for sm_90a in
``csrc/placement.cu``."""
