"""qwen3-14b [hf:Qwen/Qwen3-14B]: dense GQA with qk_norm."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    attn_strategy="seq_cp",  # 40 heads not divisible by model axis 16
)
