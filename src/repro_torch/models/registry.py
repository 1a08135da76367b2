"""Model API over the families the port serves (the hybrid family).

``get_config`` reads an architecture whose config the port keeps
(``repro_torch/configs/``: zamba2-2.7b, and granite-3-2b of the dense
family); each later slice adds the configs of the family it serves.
``get_api`` raises ``NotImplementedError``, naming the later slice, for a
family the port does not serve yet.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import Params, init_tree, param_count
from repro_torch.models.config import ArchConfig


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    )
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig

    def specs(self) -> dict[str, Any]:
        return lm.lm_specs(self.cfg)

    def n_params(self) -> int:
        return param_count(self.specs())

    def init(self, gen: torch.Generator | int, device=None,
             dtype=lm.COMPUTE_DTYPE) -> Params:
        """Weights drawn from ``gen`` (a generator on ``device``, or a seed)
        on ``device`` (None: the CUDA card).  Matmul, conv and embedding
        weights are stored in ``dtype``, the float32 leaves in float32."""
        dev = resolve_device(device)
        if isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        return Params(init_tree(self.specs(), gen, dev, dtype))

    def prefill(self, params, batch: dict, *, max_len: int | None = None, shd=None):
        return lm.lm_prefill(params, self.cfg, batch["tokens"], max_len=max_len,
                             shd=shd)

    def decode_step(self, params, tokens, cache, pos: int, *, shd=None):
        return lm.lm_decode_step(params, self.cfg, tokens, cache, pos, shd=shd)

    def init_cache(self, batch: int, max_len: int, device=None):
        return lm.init_cache(self.cfg, batch, max_len, device=resolve_device(device))

    def loss(self, *args, **kwargs):
        return lm.lm_loss(*args, **kwargs)


def build_api(cfg: ArchConfig) -> ModelAPI:
    lm.require_hybrid(cfg)
    return ModelAPI(cfg)


def get_api(arch_id: str, reduced: bool = False) -> ModelAPI:
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    return build_api(cfg)
