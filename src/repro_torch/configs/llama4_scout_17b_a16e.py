"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: MoE 16e top-1."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, n_experts=16, top_k=1,
    attn_strategy="seq_cp",  # 40 heads not divisible by model axis 16
)
