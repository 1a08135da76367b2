"""Flash-decode: one query token against a KV cache, split-K over the
cache with a log-sum-exp combine, CUDA C++ for sm_90a in
``csrc/decode_attention.cu``."""
