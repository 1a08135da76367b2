"""Flash attention: blocked online-softmax attention with GQA and
bottom-right causal masking, CUDA C++ for sm_90a in
``csrc/flash_attention.cu``."""
