"""falcon-mamba-7b [arXiv:2410.05355]: pure Mamba1, attention-free."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, ssm_state=16, d_inner=8192,
    attention="none", sub_quadratic=True,
)
