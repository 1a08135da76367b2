"""The port's shape cells (``SHAPES``, ``shape_cells``, ``input_specs``)
against the reference's: every ported architecture at every cell it
lowers, each input's shape and dtype (``meta`` tensors on the port's
side, ``ShapeDtypeStruct`` on the reference's), the decode cells' caches
included; the enc-dec family (whisper-tiny) is the next slice and
raises."""
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
#: every architecture of the reference but the enc-dec whisper-tiny
ARCHS = [a for a in j_reg.ARCH_IDS if a != "whisper-tiny"]


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
    assert len(ARCHS) == len(CONFIG_FILES) == 9


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
    """tests/test_endpoints.py::test_frontend_stubs_in_specs on the port."""
    vlm = p_reg.input_specs(p_reg.get_config("internvl2-26b"), "train_4k")
    assert vlm["vision_embeds"].shape == (256, 256, 6144)
    assert vlm["vision_embeds"].dtype == torch.bfloat16
    cache = p_reg.input_specs(p_reg.get_config("zamba2-2.7b"), "long_500k")["cache"]
    assert cache["shared_k"].shape[2] == 524288


def test_encdec_cells_are_the_next_slice():
    cfg = ArchConfig(**dataclasses.asdict(j_reg.get_config("whisper-tiny")))
    with pytest.raises(NotImplementedError, match="enc-dec"):
        p_reg.input_specs(cfg, "train_4k")
    assert jax.tree.leaves(j_reg.input_specs(j_reg.get_config("whisper-tiny"),
                                             "train_4k"))
