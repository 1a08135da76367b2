"""Mamba1 selective scan: the sequential recurrence over a sequence,
CUDA C++ for sm_90a in ``csrc/selective_scan.cu``."""
