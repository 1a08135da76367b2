"""The port's CUDA kernels on the card: each wrapper against its plain
PyTorch version on the same inputs (the placement kernels bitwise, the
attention and SSD kernels within the reference's tolerances), placement
on the card against the reference's SoA engine, and the reduced zamba2
slice on the card against the same slice on the CPU.  Marked ``gpu``;
every test skips where there is no CUDA device (decided in the
``cuda_device`` fixture).  This file imports no JAX, so it runs on a GPU
machine without it::

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
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.placement import kernel, ops, ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.registry import get_api

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


# ---------------------------------------------------------------------------
# attention and SSD kernels (tolerances of tests/test_kernels.py)
# ---------------------------------------------------------------------------


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-5)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,dtype", [
    (2, 128, 128, 4, 2, 64, True, torch.float32),
    (1, 256, 256, 8, 8, 128, True, torch.float32),
    (2, 128, 256, 2, 1, 64, False, torch.float32),
    (2, 512, 512, 32, 32, 80, True, torch.bfloat16),   # the shared block's heads
    (1, 100, 300, 4, 4, 80, True, torch.bfloat16),     # sq < sk, ragged tiles
    (2, 77, 77, 4, 4, 16, True, torch.float32),        # the reduced config's head_dim
    (1, 200, 130, 8, 2, 128, False, torch.bfloat16),
])
def test_flash_attention_kernel_matches_plain(cuda_device, b, sq, sk, h, kv, d,
                                              causal, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(sq * 31 + sk)
    q = _randn(gen, (b, sq, h, d), dtype, cuda_device)
    k = _randn(gen, (b, sk, kv, d), dtype, cuda_device)
    v = _randn(gen, (b, sk, kv, d), dtype, cuda_device)
    before = flash_kernel.LAUNCHES["flash_attention"]
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    want = flash_ref.attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,h,kv,d,dtype", [
    (8, 2176, 32, 32, 80, torch.bfloat16),   # the serving shape
    (2, 256, 4, 2, 64, torch.float32),
    (1, 512, 8, 1, 128, torch.float32),
    (3, 300, 16, 1, 128, torch.bfloat16),    # a GQA group of 16, ragged S
    (2, 64, 4, 4, 16, torch.float32),
])
def test_decode_attention_kernel_matches_plain(cuda_device, b, S, h, kv, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(S + h)
    q = _randn(gen, (b, 1, h, d), dtype, cuda_device)
    kc = _randn(gen, (b, S, kv, d), dtype, cuda_device)
    vc = _randn(gen, (b, S, kv, d), dtype, cuda_device)
    lens = torch.randint(1, S + 1, (b,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    lens[0] = S
    before = dec_kernel.LAUNCHES["decode_attention"]
    got = dec_kernel.decode_attention(q, kc, vc, lens)
    want = dec_ref.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert dec_kernel.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
def test_decode_attention_kernel_ignores_stale_tail(cuda_device):
    """Entries at or past cache_len never contribute: not even NaN there
    changes the output."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b, S, h, kv, d = 3, 700, 8, 2, 80
    q = _randn(gen, (b, 1, h, d), torch.bfloat16, cuda_device)
    kc = _randn(gen, (b, S, kv, d), torch.bfloat16, cuda_device)
    vc = _randn(gen, (b, S, kv, d), torch.bfloat16, cuda_device)
    lens = torch.tensor([40, 257, 700], dtype=torch.int32, device=cuda_device)
    a = dec_kernel.decode_attention(q, kc, vc, lens)
    for i, n in enumerate(lens.tolist()):
        kc[i, n:] = 1e4
        vc[i, n:] = float("nan")
    b_ = dec_kernel.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("b,L,nh,hd,n,chunk", [
    (2, 64, 4, 64, 32, 32),
    (1, 128, 2, 64, 64, 64),
    (1, 128, 8, 128, 64, 32),
    (2, 130, 8, 16, 8, 128),     # the reduced config's widths, ragged L
    (1, 1000, 16, 64, 64, 128),  # zamba2's head_dim and state
])
def test_ssd_kernel_matches_plain(cuda_device, b, L, nh, hd, n, chunk):
    gen = torch.Generator(device=cuda_device).manual_seed(L + nh)
    x = torch.randn((b, L, nh, hd), generator=gen, device=cuda_device)
    dt = torch.nn.functional.softplus(
        torch.randn((b, L, nh), generator=gen, device=cuda_device) * 0.5)
    A = -torch.exp(torch.randn((nh,), generator=gen, device=cuda_device) * 0.3)
    B = torch.randn((b, L, n), generator=gen, device=cuda_device)
    C = torch.randn((b, L, n), generator=gen, device=cuda_device)
    args = (x * dt[..., None], dt * A, B, C)
    before = ssd_kernel.LAUNCHES["ssd"]
    y, S = ssd_kernel.ssd(*args, chunk=chunk)
    yp, Sp = ssd_ref.ssd_plain(*args)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd"] == before + 1
    torch.testing.assert_close(y, yp, atol=5e-4, rtol=5e-3)
    torch.testing.assert_close(S, Sp, atol=5e-4, rtol=5e-3)
    # chunk invariance (the state carry across chunks)
    for other in (16, 128):
        y2, S2 = ssd_kernel.ssd(*args, chunk=other)
        torch.testing.assert_close(y2, y, atol=5e-4, rtol=5e-3)
        torch.testing.assert_close(S2, S, atol=5e-4, rtol=5e-3)


@pytest.mark.gpu
def test_kernels_reject_cpu_tensors_on_the_card(cuda_device):
    q = torch.zeros((1, 16, 4, 64), device=cuda_device)
    before = dict(flash_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="k is on cpu"):
        flash_kernel.flash_attention(q, q.cpu(), q, causal=True)
    assert flash_kernel.LAUNCHES == before


@pytest.mark.gpu
def test_reduced_zamba2_on_card_matches_cpu(cuda_device):
    """The serving path on the card (flash, decode and SSD kernels) against
    the same path on the CPU (their plain versions), same weights and
    teacher-forced tokens: logits within the slice tolerance, 0.15."""
    api = get_api("zamba2-2.7b", reduced=True)
    cpu_params = api.init(0, "cpu")
    gpu_params = api.init(0, "cpu").to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 132)))
    counts = [dict(m.LAUNCHES) for m in (flash_kernel, dec_kernel, ssd_kernel)]
    outs = []
    for params, dev in ((cpu_params, torch.device("cpu")), (gpu_params, cuda_device)):
        t = toks.to(dev)
        lg, cache = api.prefill(params, {"tokens": t[:, :128]}, max_len=136)
        got = [lg.float().cpu()]
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    napp = api.cfg.n_layers // api.cfg.shared_attn_every
    assert flash_kernel.LAUNCHES["flash_attention"] == counts[0]["flash_attention"] + napp
    assert dec_kernel.LAUNCHES["decode_attention"] == counts[1]["decode_attention"] + 4 * napp
    assert ssd_kernel.LAUNCHES["ssd"] == counts[2]["ssd"] + api.cfg.n_layers
    for a, b_ in zip(*outs):
        assert torch.isfinite(b_).all()
        assert float((a - b_).abs().max()) < 0.15
