"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: MoE 64e top-6."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6,
)
