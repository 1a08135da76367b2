"""internvl2-26b [arXiv:2404.16821]: InternLM2-20B backbone; ViT stubbed."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, n_vision_tokens=256, rope_theta=1e6,
)
