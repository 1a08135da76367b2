"""Architecture configuration: the port's copy of the reference's
``models/config.py`` (the whole file, ``reduced()`` included)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba) ---
    ssm_state: int = 0
    d_inner: int = 0                  # 0 -> 2 * d_model
    conv_width: int = 4
    dt_rank: int = 0                  # 0 -> ceil(d_model / 16)
    ssm_head_dim: int = 64            # mamba2 only
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0        # apply shared attn block every N layers
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 1500               # fixed audio-frame count (stub frontend)
    # --- vlm ---
    n_vision_tokens: int = 0
    # --- flags ---
    qk_norm: bool = False
    rope_theta: float = 1e4
    pos_emb: str = "rope"             # rope | sinusoidal
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    mlp_act: str = "swiglu"           # swiglu | gelu
    attention: str = "full"           # full | none
    norm_eps: float = 1e-5
    sub_quadratic: bool = False       # eligible for long_500k
    # --- distribution hints ---
    attn_strategy: str = "auto"       # auto | head_tp | seq_cp

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtrank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def resolve_attn_strategy(self, model_axis: int) -> str:
        if self.attn_strategy != "auto":
            return self.attn_strategy
        if self.n_heads and self.n_heads % model_axis == 0:
            return "head_tp"
        return "seq_cp"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.shared_attn_every == 0 else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_inner=128 if self.inner else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=8 if self.ssm_state else 0,
            ssm_head_dim=16,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_len=32 if self.n_enc_layers else 1500,
            n_vision_tokens=min(self.n_vision_tokens, 8),
        )
