"""The port's CUDA kernels on the card: each wrapper against its plain
PyTorch version on the same inputs, bitwise, and placement on the card
against the reference's SoA engine.  Marked ``gpu``; every test skips
where there is no CUDA device (decided in the ``cuda_device`` fixture).
This file imports no JAX, so it runs on a GPU machine without it::

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from _torch_common import (  # noqa: F401 — cuda_device is a fixture
    SCHEDULE_FIELDS,
    cuda_device,
    reference_case,
    to_port,
)
from repro.core import scheduler as ref_sched
from repro_torch.core import scheduler as port_sched
from repro_torch.kernels.placement import kernel, ops, ref

REGS = ("e_base", "nl", "g_base", "lk", "fw", "wt")


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _score_case(seed, n, ties, device):
    rng = np.random.default_rng(seed)
    regs = {k: rng.uniform(0.0, hi, n) for k, hi in zip(
        REGS, (5e4, 300.0, 10.0, 3.0, 2.0, 1.0))}
    alive = rng.random(n) < 0.8
    if ties:
        regs = {k: np.zeros(n) for k in REGS}
        alive[: n // 3] = False
    alive[int(rng.integers(n))] = True
    kw = {k: torch.from_numpy(v).to(device) for k, v in regs.items()}
    kw["alive"] = torch.from_numpy(alive).to(device)
    kw.update(c_cur=float(rng.uniform(0.0, 200.0)),
              idle_on_sum=float(rng.uniform(0.0, 500.0)),
              a1=float(rng.uniform(0.0, 1e-4)), b1=float(rng.uniform(0.0, 1e-2)),
              g1=float(rng.uniform(0.0, 1.0)),
              w_idle_on=float(rng.uniform(0.0, 1e-3)))
    return kw


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,ties", [(0, 32, False), (1, 32, True),
                                         (2, 1000, False), (3, 1000, True),
                                         (4, 1, False), (5, 257, True)])
def test_score_fleet_kernel_matches_plain(cuda_device, seed, n, ties):
    kw = _score_case(seed, n, ties, cuda_device)
    before = kernel.LAUNCHES["score_fleet"]
    obj_k, idx_k = kernel.score_fleet(**kw)
    obj_p, idx_p = ref.score_fleet_plain(**kw)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["score_fleet"] == before + 1
    assert torch.equal(_bits(obj_k), _bits(obj_p))
    assert int(idx_k) == int(idx_p)
    if ties:
        assert int(idx_k) == int(torch.nonzero(kw["alive"])[0])


def _window(n_tasks, replicas, device, nb_max=20.0):
    tasks, eps, store, _ = reference_case(n_tasks, replicas, True,
                                          nb_max=nb_max)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    table = port_sched.PredictionTable(ptasks, peps, pstore)
    sf1, sf2 = port_sched._normalizers_fast(ptasks, peps, table, ptm)
    n_ep, consts, init, xs, _ = port_sched.window_inputs(
        [[t] for t in ptasks], [[i] for i in range(n_tasks)], peps, table,
        ptm, 0.5, port_sched.HEURISTICS, sf1, sf2,
        port_sched.SoAState(peps, ptm), None, device)
    p, n_units = ops.pack(consts, init, xs, device)
    return p, n_ep, n_units


@pytest.mark.gpu
@pytest.mark.parametrize("n_tasks,replicas", [(500, 8), (300, 1), (1, 2)])
def test_greedy_window_kernel_matches_plain(cuda_device, n_tasks, replicas):
    p, n_ep, n_units = _window(n_tasks, replicas, cuda_device)
    before = kernel.LAUNCHES["greedy_window"]
    out_k = kernel.greedy_window(p, n_ep, n_units)
    out_p = ops._greedy_scan_plain(p, n_ep, n_units)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    assert set(out_k) == set(out_p)
    for k in out_k:
        assert torch.equal(_bits(out_k[k]), _bits(out_p[k])), k


@pytest.mark.gpu
def test_greedy_window_rejects_cpu_tensors(cuda_device):
    """A CPU tensor inside a window on the card raises; nothing launches."""
    p, n_ep, n_units = _window(20, 1, cuda_device)
    p["rt_tab"] = p["rt_tab"].cpu()
    before = kernel.LAUNCHES["greedy_window"]
    with pytest.raises(ValueError, match="rt_tab is on cpu"):
        kernel.greedy_window(p, n_ep, n_units)
    assert kernel.LAUNCHES["greedy_window"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("replicas,alive_dead", [(8, ()), (2, (1, 6))])
def test_mhra_on_card_matches_soa(cuda_device, replicas, alive_dead):
    tasks, eps, store, tm = reference_case(400, replicas, True, nb_max=15.0)
    alive = (tuple(i not in alive_dead for i in range(len(eps)))
             if alive_dead else None)
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=0.5, engine="soa",
                       alive=alive)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    before = kernel.LAUNCHES["greedy_window"]
    b = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=0.5, alive=alive)
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    for f in SCHEDULE_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
