"""whisper-tiny [arXiv:2212.04356]: enc-dec, conv frontend stubbed."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, enc_len=1500,
    pos_emb="sinusoidal", norm="layernorm", mlp_act="gelu",
    attn_strategy="seq_cp",
)
