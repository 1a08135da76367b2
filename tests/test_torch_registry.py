"""The port's shape cells (``SHAPES``, ``shape_cells``, ``input_specs``)
against the reference's: every ported architecture at every cell it
lowers, each input's shape and dtype (``meta`` tensors on the port's
side, ``ShapeDtypeStruct`` on the reference's), the decode cells' caches
included (the enc-dec family's frames and cross caches too); the enc-dec
family's loss runs forward only, as the others'."""
import dataclasses
import pathlib

import jax
import pytest
import torch

from repro.models import registry as j_reg
from repro_torch.models import registry as p_reg
from repro_torch.models.config import ArchConfig

CONFIG_FILES = [p for p in (pathlib.Path(p_reg.__file__).parents[1] / "configs").glob("*.py")
                if p.stem != "__init__"]
#: every architecture of the reference
ARCHS = list(j_reg.ARCH_IDS)


def _tree(specs):
    """{name: (shape, dtype name)} of a (nested) input dict."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out[k] = _tree(v)
        elif isinstance(v, torch.Tensor):
            assert v.device.type == "meta", k
            out[k] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        else:
            out[k] = (tuple(v.shape), str(v.dtype))
    return out


def test_every_config_the_port_keeps_is_covered():
    assert len(ARCHS) == len(CONFIG_FILES) == 10


def test_arch_ids_and_cells_are_the_references():
    """The port's ``ARCH_IDS`` (the dry-run's sweep) in the reference's
    order, and its 32 (arch x shape) cells."""
    assert p_reg.ARCH_IDS == j_reg.ARCH_IDS
    cells = [(a, s) for a in p_reg.ARCH_IDS for s in p_reg.shape_cells(a)]
    assert cells == [(a, s) for a in j_reg.ARCH_IDS for s in j_reg.shape_cells(a)]
    assert len(cells) == 32


def test_shapes_are_the_reference_cells():
    assert p_reg.SHAPES == j_reg.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    assert p_reg.shape_cells(arch) == j_reg.shape_cells(arch)
    for cell in p_reg.shape_cells(arch):
        got = _tree(p_reg.input_specs(p_reg.get_config(arch), cell))
        want = _tree(j_reg.input_specs(j_reg.get_config(arch), cell))
        assert got == want, (arch, cell)


def test_vlm_train_cell_carries_the_vision_embeds():
    """tests/test_endpoints.py::test_frontend_stubs_in_specs on the port:
    whisper's precomputed frames and internvl2's patch embeddings; then the
    decode cells' caches (whisper's cross caches at its 1,500 frames)."""
    whisper = p_reg.input_specs(p_reg.get_config("whisper-tiny"), "train_4k")
    assert whisper["frames"].shape == (256, 1500, 384)
    assert whisper["frames"].dtype == torch.bfloat16
    cache = p_reg.input_specs(p_reg.get_config("whisper-tiny"), "decode_32k")["cache"]
    assert cache["cross_k"].shape == cache["cross_v"].shape == (4, 128, 1500, 6, 64)
    assert cache["k"].shape == (4, 128, 32768, 6, 64)
    vlm = p_reg.input_specs(p_reg.get_config("internvl2-26b"), "train_4k")
    assert vlm["vision_embeds"].shape == (256, 256, 6144)
    assert vlm["vision_embeds"].dtype == torch.bfloat16
    cache = p_reg.input_specs(p_reg.get_config("zamba2-2.7b"), "long_500k")["cache"]
    assert cache["shared_k"].shape[2] == 524288


def test_encdec_cells_are_the_next_slice():
    """The enc-dec cells lower on the port as on the reference, and the
    trainer's slice runs them: a gradient flows through the enc-dec loss
    into every parameter, the frames' encoder included."""
    cfg = ArchConfig(**dataclasses.asdict(j_reg.get_config("whisper-tiny")))
    assert set(p_reg.input_specs(cfg, "train_4k")) == set(
        j_reg.input_specs(j_reg.get_config("whisper-tiny"), "train_4k"))
    api = p_reg.build_api(cfg.reduced())
    params = api.init(0, "cpu", dtype=torch.float32, trainable=True)
    gen = torch.Generator().manual_seed(0)
    batch = {"frames": torch.randn((1, 32, 64), generator=gen).to(torch.bfloat16),
             "tokens": torch.randint(0, 512, (1, 4), generator=gen),
             "labels": torch.randint(0, 512, (1, 4), generator=gen)}
    loss, metrics = api.loss(params, batch)
    loss.backward()
    assert float(metrics["aux"]) == 0.0
    for name, p in params.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert float(params["enc_layers"][0]["attn"]["wq"].grad.abs().sum()) > 0
    assert jax.tree.leaves(j_reg.input_specs(j_reg.get_config("whisper-tiny"),
                                             "train_4k"))
