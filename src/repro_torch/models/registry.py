"""Model API over the families the port serves (dense, MoE, VLM, hybrid,
ssm and enc-dec), and the reference's shape cells with their inputs.

``get_config`` reads an architecture whose config the port keeps
(``repro_torch/configs/``: granite-3-2b, starcoder2-7b, qwen3-14b and
deepseek-67b of the dense family, moonshot-v1-16b-a3b and
llama4-scout-17b-a16e (MoE), internvl2-26b (VLM), zamba2-2.7b,
falcon-mamba-7b and whisper-tiny (enc-dec): every architecture of the
reference).  ``build_api`` routes the enc-dec family to
``models/encdec.py`` and the others to ``models/lm.py``.  ``input_specs``
gives a cell's inputs as ``meta`` tensors: their shapes and dtypes, no
storage.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.common import Params, init_tree, param_axes, param_count
from repro_torch.models.config import ArchConfig

# the reference's architectures, in its order
ARCH_IDS = [
    "whisper-tiny",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "qwen3-14b",
    "granite-3-2b",
    "starcoder2-7b",
    "deepseek-67b",
    "zamba2-2.7b",
    "internvl2-26b",
    "falcon-mamba-7b",
]

# (seq_len, global_batch, kind), the reference's cells
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


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

    def axes(self):
        """Each parameter's logical axes, in the specs' layout."""
        return param_axes(self.specs())

    def init(self, gen: torch.Generator | int, device=None,
             dtype=lm.COMPUTE_DTYPE, trainable: bool = False) -> Params:
        """Weights drawn from ``gen`` (a generator on ``device``, or a seed)
        on ``device`` (None: the CUDA card).  Matmul, conv and embedding
        weights are stored in ``dtype``, the float32 leaves in float32.
        ``trainable`` makes every leaf require a gradient: the trainer asks
        for ``dtype=torch.float32`` (the reference's float32 masters, cast
        to bf16 at use)."""
        dev = resolve_device(device)
        if isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        return Params(init_tree(self.specs(), gen, dev, dtype), trainable)

    def prefill(self, params, batch: dict, *, max_len: int | None = None, shd=None):
        """``batch``: ``tokens``, and a VLM's ``vision_embeds``."""
        return lm.lm_prefill(params, self.cfg, batch["tokens"], max_len=max_len,
                             shd=shd, vision_embeds=batch.get("vision_embeds"))

    def decode_step(self, params, tokens, cache, pos: int, *, shd=None):
        return lm.lm_decode_step(params, self.cfg, tokens, cache, pos, shd=shd)

    def init_cache(self, batch: int, max_len: int, device=None):
        return lm.init_cache(self.cfg, batch, max_len, device=device)

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """{name: (shape, dtype)} of the serving caches."""
        return lm.cache_shapes(self.cfg, batch, max_len)

    def loss(self, params, batch: dict, *, shd=None, remat: bool = False):
        """(loss, {"ce", "aux"}) of ``batch`` (``tokens`` and ``labels``, and
        a VLM's ``vision_embeds``); the dense, MoE and VLM families' takes a
        gradient, with ``remat`` checkpointing each layer."""
        return lm.lm_loss(params, self.cfg, batch, shd=shd, remat=remat)


@dataclasses.dataclass(frozen=True)
class EncDecAPI(ModelAPI):
    """The enc-dec family's API: the same methods over ``models/encdec.py``;
    ``prefill`` and ``loss`` read the audio frames from ``batch["frames"]``."""

    def specs(self) -> dict[str, Any]:
        return encdec.encdec_specs(self.cfg)

    def prefill(self, params, batch: dict, *, max_len: int | None = None, shd=None):
        """``batch``: ``frames`` (b, enc_len, d) and ``tokens``."""
        return encdec.encdec_prefill(params, self.cfg, batch["frames"], batch["tokens"],
                                     max_len=max_len, shd=shd)

    def decode_step(self, params, tokens, cache, pos: int, *, shd=None):
        return encdec.encdec_decode_step(params, self.cfg, tokens, cache, pos, shd=shd)

    def init_cache(self, batch: int, max_len: int, device=None):
        return encdec.init_cache(self.cfg, batch, max_len, device=device)

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        return encdec.cache_shapes(self.cfg, batch, max_len)

    def loss(self, params, batch: dict, *, shd=None, remat: bool = False):
        """(loss, {"ce", "aux"}) of ``batch`` (``frames``, ``tokens`` and
        ``labels``); it takes a gradient, every layer checkpointed."""
        return encdec.encdec_loss(params, self.cfg, batch, shd=shd, remat=remat)


def build_api(cfg: ArchConfig) -> ModelAPI:
    lm.require_served(cfg)
    return EncDecAPI(cfg) if cfg.family == "encdec" else ModelAPI(cfg)


def get_api(arch_id: str, reduced: bool = False) -> ModelAPI:
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    return build_api(cfg)


def shape_cells(arch_id: str) -> list[str]:
    """Shape cells that lower for this arch (long_500k only if sub-quadratic)."""
    cfg = get_config(arch_id)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str) -> dict[str, Any]:
    """A cell's inputs as ``meta`` tensors (shapes and dtypes, no storage).
    Train: ``tokens`` and ``labels``; prefill: ``tokens``; a VLM adds its
    ``vision_embeds`` (b, n_vision_tokens, d) and an enc-dec its ``frames``
    (b, enc_len, d), in bf16, to both.  Decode: one new token, the cache at
    the cell's length (an enc-dec's cross caches at ``enc_len``) and
    ``pos``."""
    lm.require_served(cfg)
    seq, gb, kind = SHAPES[shape_name]
    i32 = torch.int32
    if kind == "decode":
        return {
            "tokens": _meta((gb, 1), i32),
            "cache": {k: _meta(shape, dt)
                      for k, (shape, dt) in build_api(cfg).cache_shapes(gb, seq).items()},
            "pos": _meta((), i32),
        }
    batch = {"tokens": _meta((gb, seq), i32)}
    if kind == "train":
        batch["labels"] = _meta((gb, seq), i32)
    if cfg.family == "encdec":
        batch["frames"] = _meta((gb, cfg.enc_len, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta((gb, cfg.n_vision_tokens, cfg.d_model),
                                       torch.bfloat16)
    return batch
