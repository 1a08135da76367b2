"""starcoder2-7b [arXiv:2402.19173]: dense GQA, RoPE."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152, rope_theta=1e5, mlp_act="gelu",
    attn_strategy="seq_cp",  # 36 heads not divisible by model axis 16
)
