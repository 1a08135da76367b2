"""Rules of the port: it imports neither JAX nor the JAX package, and
its entry points run on the CUDA card unless the caller names the CPU —
with no CUDA device they raise instead of falling back."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from _torch_common import reference_case, to_port
from repro_torch import resolve_device
from repro_torch.core import scheduler as port_sched
from repro_torch.core.endpoint import table1_testbed
from repro_torch.core.engine import OnlineEngine
from repro_torch.core.executor import GreenFaaSExecutor
from repro_torch.core.testbed import TestbedSim as PortSim
from repro_torch.kernels.placement import ops
from repro_torch.launch.serve import serve_batch
from repro_torch.models import lm, ssm
from repro_torch.models.registry import get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
_IMPORTS_REFERENCE = re.compile(
    r"^\s*(import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s+import))", re.M)
_IMPORTS_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.executor\n"
        "import repro_torch.core.engine, repro_torch.core.region\n"
        "import repro_torch.kernels.placement.ops\n"
        "import repro_torch.launch.serve, repro_torch.models.registry\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.costs\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
        "assert not any(m == 'repro' or m.startswith('repro.') "
        "for m in sys.modules), 'the port imported the JAX package'\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_files_do_not_import_reference_or_jax(path):
    text = path.read_text()
    assert not _IMPORTS_REFERENCE.search(text), path
    assert not _IMPORTS_JAX.search(text), path
    assert "import repro " not in text and "from repro." not in text, path


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks, eps, store, _ = reference_case(14)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sched.mhra(ptasks, peps, pstore, ptm)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        GreenFaaSExecutor(table1_testbed(), PortSim())
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineEngine(table1_testbed(), PortSim())
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.greedy_window(1, {}, {}, {})
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_default_device_raises_without_cuda(monkeypatch):
    """serve_batch and the model API's init take device=None as the CUDA
    card: with no CUDA device they raise before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batch("zamba2-2.7b", reduced=True, batch=1, prompt_len=8,
                    gen_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_api("zamba2-2.7b", reduced=True).init(0)


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b", "falcon-mamba-7b"])
def test_init_cache_default_device_raises_without_cuda(arch, monkeypatch):
    """lm.init_cache, and the Mamba cache helpers under it, take
    device=None as the CUDA card: on a machine without CUDA they raise,
    and the CPU runs only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_api(arch, reduced=True).cfg
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 1, 8)
    init = ssm.mamba1_init_cache if cfg.family == "ssm" else ssm.mamba2_init_cache
    if cfg.family != "dense":
        with pytest.raises(RuntimeError, match="CUDA"):
            init(cfg, 1)
        assert init(cfg, 1, device="cpu")["h"].device.type == "cpu"
    assert all(t.device.type == "cpu" for t in lm.init_cache(cfg, 1, 8, device="cpu").values())
