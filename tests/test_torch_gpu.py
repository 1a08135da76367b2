"""The port's CUDA kernels on the card: each wrapper against its plain
PyTorch version on the same inputs (the placement kernels bitwise, the
attention, SSD and selective-scan kernels within the reference's
tolerances), placement on the card against the reference's SoA engine,
the reduced zamba2, falcon-mamba, dense, MoE and VLM slices on the card
against the same slices on the CPU, the MoE routing on the card against
the CPU's, and the trainer's slice: flash attention's lse and backward
kernel against their plain versions, the autograd op's launches, and
reduced granite train steps on the card against the CPU; the SSD's and
the fused scan's backward kernels against their plain versions, the
gradient through ``ssd_op`` and ``mamba1_scan_fused`` on the card, and
reduced zamba2 and falcon-mamba train steps on the card against the
CPU.  Marked ``gpu``;
every test skips where there is no CUDA device (decided in the
``cuda_device`` fixture).  This file imports no JAX, so it runs on a GPU
machine without it::

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from _torch_common import (  # noqa: F401 — cuda_device is a fixture
    REGISTERS,
    SCHEDULE_FIELDS,
    cuda_device,
    port_registers,
    reference_case,
    register_case,
    to_port,
)
from repro.core import scheduler as ref_sched
from repro_torch.core import scheduler as port_sched
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.placement import kernel, ops, ref
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import lm, moe
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


def _window(n_tasks, replicas, device, nb_max=20.0, regs=()):
    """A packed window of single-input tasks; ``regs`` arms those of the
    four registers (``register_case`` snapshots, seed 31)."""
    tasks, eps, store, _ = reference_case(n_tasks, replicas, True,
                                          nb_max=nb_max)
    kw = {}
    if regs:
        tasks, kw = register_case(tasks, eps, 31, which=regs)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    pkw = port_registers(kw)
    table = port_sched.PredictionTable(ptasks, peps, pstore)
    sf1, sf2, sf3 = port_sched._normalizers_fast(ptasks, peps, table, ptm,
                                                 pkw.get("carbon"))
    n_ep, consts, init, xs, _ = port_sched.window_inputs(
        [[t] for t in ptasks], [[i] for i in range(n_tasks)], peps, table,
        ptm, 0.5, port_sched.HEURISTICS, sf1, sf2,
        port_sched.SoAState(peps, ptm), None, device, sf3=sf3, **pkw)
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
    # the tensor-core route's tile edges (128 query rows a CTA, two m16
    # tiles a warp at d <= 80, 64-key tiles)
    (2, 1, 1, 4, 4, 64, True, torch.bfloat16),         # one query, one key
    (2, 1, 300, 8, 2, 80, True, torch.bfloat16),       # one query row, sq < sk
    (1, 65, 65, 4, 4, 80, True, torch.bfloat16),       # one row past a q tile
    (1, 129, 129, 4, 1, 64, True, torch.bfloat16),     # one key past two tiles
    (2, 100, 229, 8, 8, 80, True, torch.bfloat16),     # sq < sk, ragged q and k tiles
    (2, 130, 130, 4, 4, 16, True, torch.bfloat16),     # the reduced config's head_dim
    (1, 192, 192, 8, 8, 64, True, torch.bfloat16),
    (1, 256, 320, 8, 8, 128, True, torch.bfloat16),
    (2, 200, 200, 16, 4, 80, True, torch.bfloat16),    # GQA group 4
    (1, 160, 300, 32, 4, 128, True, torch.bfloat16),   # GQA group 8, sq < sk
    (2, 90, 333, 8, 1, 16, False, torch.bfloat16),     # non-causal, ragged keys
    (8, 2048, 2048, 32, 32, 80, True, torch.bfloat16),  # zamba2's prefill shape
    # the dense family: GQA groups 5 (qwen3) and 9 (starcoder2) at head_dim
    # 128, ragged tiles; then each config's prefill heads at s=1024
    (2, 200, 200, 10, 2, 128, True, torch.bfloat16),
    (1, 130, 333, 18, 2, 128, True, torch.bfloat16),
    (2, 257, 257, 9, 1, 128, False, torch.bfloat16),
    (2, 1024, 1024, 32, 8, 64, True, torch.bfloat16),    # granite-3-2b
    (1, 1024, 1024, 36, 4, 128, True, torch.bfloat16),   # starcoder2-7b
    (1, 1024, 1024, 40, 8, 128, True, torch.bfloat16),   # qwen3-14b
    # the MoE and VLM families: group 1 and group 6 at head_dim 128
    (1, 1024, 1024, 16, 16, 128, True, torch.bfloat16),  # moonshot-v1-16b-a3b
    (1, 1024, 1024, 48, 8, 128, True, torch.bfloat16),   # internvl2-26b
    (2, 300, 300, 12, 2, 128, True, torch.bfloat16),     # group 6, ragged tiles
    # the enc-dec family (whisper-tiny, 6 heads of 64, MHA): the encoder's
    # 1,500 frames against themselves (a ragged 92-key last tile, no
    # diagonal), the decoder's causal self-attention, then cross-attention
    # of the 384-token prompt against the 1,500 frames
    (8, 1500, 1500, 6, 6, 64, False, torch.bfloat16),
    (8, 384, 384, 6, 6, 64, True, torch.bfloat16),
    (8, 384, 1500, 6, 6, 64, False, torch.bfloat16),
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
    (2, 1000, 16, 1, 80, torch.bfloat16),    # a GQA group of 16 at d=80
    (4, 777, 8, 2, 64, torch.bfloat16),      # S not a multiple of the 64-key tile
    (3, 200, 4, 4, 16, torch.bfloat16),      # the reduced config's head_dim
    # the dense family: granite's serving shape (group 4 at d=64), then
    # groups 5 (qwen3) and 9 (starcoder2) at d=128, which leave 11 and 7
    # of the 16 rows of the tensor-core tile as padding
    (8, 2176, 32, 8, 64, torch.bfloat16),
    (8, 2176, 40, 8, 128, torch.bfloat16),
    (8, 2176, 36, 4, 128, torch.bfloat16),
    (3, 777, 10, 2, 128, torch.bfloat16),
    (3, 300, 9, 1, 128, torch.bfloat16),
    (2, 300, 9, 1, 128, torch.float32),
    # the MoE and VLM families: group 1 (15 padding rows of the tile) and
    # group 6 (10) at d=128, at the serving cache
    (8, 2176, 16, 16, 128, torch.bfloat16),
    (8, 2176, 48, 8, 128, torch.bfloat16),
    (3, 777, 6, 1, 128, torch.bfloat16),
    # the enc-dec family: whisper's self cache (prompt 384 + 64 new tokens)
    # with ragged live lengths
    (8, 448, 6, 6, 64, torch.bfloat16),
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_on_a_fully_live_cache(cuda_device, dtype):
    """whisper's cross-decode: every row's ``cache_len`` is the whole cache,
    S = 1,500 frames (not a multiple of the 64-key tile), b=8, 6 heads of
    64 over 6; the wrapper's split plan for b·kv = 48."""
    b, S, h, kv, d = 8, 1500, 6, 6, 64
    gen = torch.Generator(device=cuda_device).manual_seed(1500)
    q = _randn(gen, (b, 1, h, d), dtype, cuda_device)
    kc = _randn(gen, (b, S, kv, d), dtype, cuda_device)
    vc = _randn(gen, (b, S, kv, d), dtype, cuda_device)
    lens = torch.full((b,), S, dtype=torch.int32, device=cuda_device)
    plan = dec_kernel.plan_splits(b, S, h, kv, d)
    assert plan["split"] >= 1
    got = dec_kernel.decode_attention(q, kc, vc, lens)
    want = dec_ref.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_at_split_edges(cuda_device, dtype):
    """cache_len of 1, exactly on a split boundary, one past it, one short
    of it, and the whole cache, for the split the wrapper plans."""
    b, S, h, kv, d = 6, 2176, 8, 2, 80
    split = dec_kernel.plan_splits(b, S, h, kv, d)["split"]
    assert split < S
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q = _randn(gen, (b, 1, h, d), dtype, cuda_device)
    kc = _randn(gen, (b, S, kv, d), dtype, cuda_device)
    vc = _randn(gen, (b, S, kv, d), dtype, cuda_device)
    lens = torch.tensor([1, split, split + 1, split - 1, 2 * split, S],
                        dtype=torch.int32, device=cuda_device)
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
    (1, 2048, 80, 64, 64, 128),  # one row of zamba2's serving prefill
    (2, 1, 4, 64, 64, 128),      # one token
    (1, 17, 4, 64, 64, 128),     # one ragged chunk, L < chunk
    (1, 300, 4, 128, 128, 128),  # the widest head and state
    (1, 256, 6, 16, 8, 64),      # n=8 at hd=16 (the reduced config)
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
@pytest.mark.parametrize("b,L,nh,hd,n,chunk", [
    (2, 1000, 16, 64, 64, 128),
    (1, 500, 8, 32, 24, 64),     # widths other than zamba2's
])
def test_ssd_kernel_is_deterministic(cuda_device, b, L, nh, hd, n, chunk):
    """The kernel uses no atomics: two calls on the same inputs give the
    same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    args = (torch.randn((b, L, nh, hd), generator=gen, device=cuda_device),
            -torch.rand((b, L, nh), generator=gen, device=cuda_device) * 0.5,
            torch.randn((b, L, n), generator=gen, device=cuda_device),
            torch.randn((b, L, n), generator=gen, device=cuda_device))
    y1, S1 = ssd_kernel.ssd(*args, chunk=chunk)
    y2, S2 = ssd_kernel.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(S1, S2)
    assert bool(torch.isfinite(y1).all()) and bool(torch.isfinite(S1).all())


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-7b", "qwen3-14b"])
def test_reduced_dense_on_card_matches_cpu(cuda_device, arch):
    """The dense serving path on the card (flash on every layer of the
    prefill, decode on every layer of each step) against the same path on
    the CPU, same weights and teacher-forced tokens: logits within the
    CPU tests' bound for the config (tests/test_torch_dense.py)."""
    tol = {"granite-3-2b": 0.11, "starcoder2-7b": 0.17, "qwen3-14b": 0.09}[arch]
    api = get_api(arch, reduced=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 132)))
    counts = [dict(m.LAUNCHES) for m in (flash_kernel, dec_kernel)]
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        params = api.init(0, "cpu").to(dev)
        t = toks.to(dev)
        lg, cache = api.prefill(params, {"tokens": t[:, :128]}, max_len=136)
        got = [lg.float().cpu()]
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    L = api.cfg.n_layers
    assert flash_kernel.LAUNCHES["flash_attention"] == counts[0]["flash_attention"] + L
    assert dec_kernel.LAUNCHES["decode_attention"] == counts[1]["decode_attention"] + 4 * L
    for a, b_ in zip(*outs):
        assert torch.isfinite(b_).all()
        assert float((a - b_).abs().max()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("arch,max_tol,mean_tol", [
    ("moonshot-v1-16b-a3b", 0.33, 0.051), ("llama4-scout-17b-a16e", 5.5, 0.129),
    ("internvl2-26b", 0.09, 0.018)])
def test_reduced_moe_and_vlm_on_card_match_cpu(cuda_device, arch, max_tol, mean_tol):
    """The MoE and VLM serving paths on the card against the same paths on
    the CPU, same weights, teacher-forced tokens and (internvl2) vision
    embeddings: the largest logit error and each output's mean within the
    CPU tests' bounds (tests/test_torch_moe.py, tests/test_torch_vlm.py);
    flash on every layer of the prefill, decode on every layer a step."""
    api = get_api(arch, reduced=True)
    cfg = api.cfg
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 132)))
    vision = None
    if cfg.family == "vlm":
        vision = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    counts = [dict(m.LAUNCHES) for m in (flash_kernel, dec_kernel)]
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        params = api.init(0, "cpu").to(dev)
        t = toks.to(dev)
        batch = {"tokens": t[:, :128]}
        if vision is not None:
            batch["vision_embeds"] = vision.to(dev)
        lg, cache = api.prefill(params, batch, max_len=136)
        got = [lg.float().cpu()]
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    L = cfg.n_layers
    assert flash_kernel.LAUNCHES["flash_attention"] == counts[0]["flash_attention"] + L
    assert dec_kernel.LAUNCHES["decode_attention"] == counts[1]["decode_attention"] + 4 * L
    for a, b_ in zip(*outs):
        assert torch.isfinite(b_).all()
        assert float((a - b_).abs().max()) < max_tol
        assert float((a - b_).abs().mean()) < mean_tol


@pytest.mark.gpu
@pytest.mark.parametrize("enc_len", [32, 256])
def test_reduced_whisper_on_card_matches_cpu(cuda_device, enc_len):
    """The enc-dec serving path on the card (flash for the encoder, the
    decoder's self-attention and cross-attention on every layer of the
    prefill; decode against the self and the cross caches on every layer
    of each step) against the same path on the CPU, same weights, frames
    and teacher-forced tokens: logits within the CPU tests' bound, 0.44
    (tests/test_torch_encdec.py), at the reduced config's 32 frames and at
    256."""
    import dataclasses

    from repro_torch.models.registry import build_api

    api = build_api(dataclasses.replace(get_api("whisper-tiny", reduced=True).cfg,
                                        enc_len=enc_len))
    cfg = api.cfg
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 132)))
    frames = torch.from_numpy(rng.standard_normal((2, enc_len, cfg.d_model)).astype(
        np.float32))
    counts = [dict(m.LAUNCHES) for m in (flash_kernel, dec_kernel)]
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        params = api.init(0, "cpu").to(dev)
        t = toks.to(dev)
        lg, cache = api.prefill(params, {"frames": frames.to(dev), "tokens": t[:, :128]},
                                max_len=136)
        got = [lg.float().cpu()]
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    n_enc, L = cfg.n_enc_layers, cfg.n_layers
    assert flash_kernel.LAUNCHES["flash_attention"] == counts[0]["flash_attention"] \
        + n_enc + 2 * L
    assert dec_kernel.LAUNCHES["decode_attention"] == counts[1]["decode_attention"] \
        + 4 * 2 * L
    for a, b_ in zip(*outs):
        assert torch.isfinite(b_).all()
        assert float((a - b_).abs().max()) < 0.44


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"])
def test_moe_routing_on_card_equals_cpu(cuda_device, arch):
    """moe.route in float32 on the card and on the CPU (a router at scale
    1, groups of 16 that drop tokens): the same experts, the same slots,
    the same drops; the output within 1e-4."""
    cfg = get_api(arch, reduced=True).cfg
    gen = torch.Generator().manual_seed(5)
    p = {"router": torch.randn((cfg.d_model, cfg.n_experts), generator=gen)}
    for name, shape in (("wi", (cfg.n_experts, cfg.d_model, cfg.d_ff)),
                        ("wg", (cfg.n_experts, cfg.d_model, cfg.d_ff)),
                        ("wo", (cfg.n_experts, cfg.d_ff, cfg.d_model))):
        p[name] = torch.randn(shape, generator=gen) / shape[1] ** 0.5
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    want = moe.route(p, x, cfg, 16)
    got = moe.route(pc, x.to(cuda_device), cfg, 16)
    assert torch.equal(got["topi"].cpu(), want["topi"])
    assert torch.equal(got["dispatch"].cpu(), want["dispatch"])
    assert moe.dropped(got) == moe.dropped(want) > 0
    out_c, aux_c = moe.moe_apply(p, x, cfg, 16)
    out_g, aux_g = moe.moe_apply(pc, x.to(cuda_device), cfg, 16)
    torch.testing.assert_close(out_g.cpu(), out_c, atol=1e-4, rtol=1e-4)
    assert abs(float(aux_g) - float(aux_c)) < 1e-6


# ---------------------------------------------------------------------------
# Mamba1 selective scan (tolerance of tests/test_kernels.py: 1e-4)
# ---------------------------------------------------------------------------


def _scan_inputs(gen, b, L, d, n, device):
    x = torch.randn((b, L, d), generator=gen, device=device)
    dt = torch.nn.functional.softplus(
        torch.randn((b, L, d), generator=gen, device=device) * 0.5 - 1)
    A = -torch.exp(torch.randn((d, n), generator=gen, device=device) * 0.3)
    B = torch.randn((b, L, n), generator=gen, device=device)
    C = torch.randn((b, L, n), generator=gen, device=device)
    D = torch.randn((d,), generator=gen, device=device)
    return x, dt, A, B, C, D


@pytest.mark.gpu
@pytest.mark.parametrize("b,L,d,n", [
    (2, 64, 128, 16),      # tests/test_kernels.py SCAN_CASES
    (1, 128, 64, 8),
    (1, 64, 256, 16),
    (2, 130, 128, 8),      # the reduced config's widths, ragged L
    (3, 1000, 200, 5),     # ragged L and d, a state that is not a multiple of 4
    (1, 77, 96, 64),       # the largest state
    (2, 40, 64, 1),
])
def test_selective_scan_kernel_matches_plain(cuda_device, b, L, d, n):
    gen = torch.Generator(device=cuda_device).manual_seed(L + d + n)
    args = _scan_inputs(gen, b, L, d, n, cuda_device)
    before = scan_kernel.LAUNCHES["selective_scan"]
    y, h = scan_kernel.selective_scan(*args, return_state=True)
    y_only = scan_kernel.selective_scan(*args)
    yp, hp = scan_ref.selective_scan_plain(*args, return_state=True)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES["selective_scan"] == before + 2
    assert y.shape == (b, L, d) and h.shape == (b, d, n)
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)
    assert torch.equal(y_only, y)


@pytest.mark.gpu
@pytest.mark.parametrize("b,L,d,n", [(2, 100, 13, 16), (1, 257, 518, 8), (1, 9, 1, 3)])
def test_selective_scan_kernel_takes_any_d(cuda_device, b, L, d, n):
    """The reference's interface takes any d: d not a multiple of the
    kernel's 4-float vector, and x one float into its storage (rows not on
    16 bytes), run on padded copies; y and the state come back at d."""
    gen = torch.Generator(device=cuda_device).manual_seed(L + d + n)
    x, *rest = _scan_inputs(gen, b, L, d, n, cuda_device)
    x = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x).copy_(x)
    assert x.data_ptr() % 16
    before = scan_kernel.LAUNCHES["selective_scan"]
    y, h = scan_kernel.selective_scan(x, *rest, return_state=True)
    yp, hp = scan_ref.selective_scan_plain(x, *rest, return_state=True)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES["selective_scan"] == before + 1
    assert y.shape == (b, L, d) and h.shape == (b, d, n)
    assert y.is_contiguous() and h.is_contiguous()
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_selective_scan_rejects_cpu_tensors_and_gradients(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, dt, A, B, C, D = _scan_inputs(gen, 1, 16, 64, 16, cuda_device)
    before = scan_kernel.LAUNCHES["selective_scan"]
    with pytest.raises(ValueError, match="B is on cpu"):
        scan_kernel.selective_scan(x, dt, A, B.cpu(), C, D)
    with pytest.raises(ValueError, match="state of 1 to"):
        scan_kernel.selective_scan(x, dt, torch.zeros((64, 65), device=cuda_device),
                                   torch.zeros((1, 16, 65), device=cuda_device),
                                   torch.zeros((1, 16, 65), device=cuda_device), D)
    with pytest.raises(NotImplementedError, match="trains through mamba1_scan_fused"):
        scan_kernel.selective_scan(x.requires_grad_(), dt, A, B, C, D)
    assert scan_kernel.LAUNCHES["selective_scan"] == before


@pytest.mark.gpu
def test_reduced_falcon_mamba_on_card_matches_cpu(cuda_device):
    """The loss forward and the serving path on the card (the scan kernel)
    against the same paths on the CPU (its plain version), same weights
    and tokens: loss within 4e-4, logits within 0.125 and the forward's
    within 2e-3 on average, the strict-precision bounds of
    tests/test_torch_falcon_mamba.py (both sides round bf16 at the same
    places)."""
    api = get_api("falcon-mamba-7b", reduced=True)
    cpu_params = api.init(0, "cpu")
    gpu_params = api.init(0, "cpu").to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 133)))
    before = dict(scan_kernel.LAUNCHES)
    outs = []
    for params, dev in ((cpu_params, torch.device("cpu")), (gpu_params, cuda_device)):
        t = toks.to(dev)
        batch = {"tokens": t[:, :128], "labels": t[:, 1:129]}
        loss, _ = api.loss(params, batch)
        got = [loss.reshape(1).cpu(), lm.lm_forward(params, api.cfg, batch["tokens"])
               .float().cpu()]
        lg, cache = api.prefill(params, {"tokens": t[:, :128]})
        got.append(lg.float().cpu())
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    # a loss, a forward and a prefill, one fused launch a layer each
    assert scan_kernel.LAUNCHES["mamba1_scan_fused"] == \
        before["mamba1_scan_fused"] + 3 * api.cfg.n_layers
    assert scan_kernel.LAUNCHES["selective_scan"] == before["selective_scan"]
    assert abs(float(outs[0][0] - outs[1][0])) < 4e-4
    assert float((outs[0][1] - outs[1][1]).abs().mean()) < 2e-3
    for a, b_ in zip(outs[0][1:], outs[1][1:]):
        assert torch.isfinite(b_).all()
        assert float((a - b_).abs().max()) < 0.125


# ---------------------------------------------------------------------------
# the fused Mamba1 scan (the block from the dt_w product to out_proj)
# ---------------------------------------------------------------------------

#: y in bf16: the scan's 1e-4 before the cast, one bf16 ulp (at most 2^-7 of
#: the value) after it, where the kernel and the plain version round apart
FUSED_TOL = dict(atol=1e-4, rtol=1e-4 + 2.0 ** -7)


def _fused_inputs(gen, b, L, d, n, r, device):
    """Laid out as the block leaves them: z the second half of an in_proj
    product, B and C views of an x_proj product."""
    bf = torch.bfloat16
    xc = torch.randn((b, L, d), generator=gen, device=device).to(bf)
    dt_raw = (torch.randn((b, L, d), generator=gen, device=device) * 0.5 - 1).to(bf)
    dt_b = torch.randn((d,), generator=gen, device=device) * 0.1
    A = -torch.exp(torch.randn((d, n), generator=gen, device=device) * 0.3)
    D = torch.randn((d,), generator=gen, device=device)
    xz = torch.randn((b, L, 2 * d), generator=gen, device=device).to(bf)
    dbc = torch.randn((b, L, r + 2 * n), generator=gen, device=device).to(bf)
    return xc, dt_raw, dt_b, A, dbc[..., r:r + n], dbc[..., r + n:], D, xz[..., d:]


@pytest.mark.gpu
@pytest.mark.parametrize("b,L,d,n,r", [
    (2, 64, 128, 16, 256),     # chip_smoke.py SCAN_CASES, falcon-mamba's dt_rank
    (1, 128, 64, 8, 8),        # the reduced config's state and dt_rank
    (1, 64, 256, 16, 256),
    (2, 1000, 520, 16, 256),   # ragged L and d
    (3, 33, 200, 5, 3),        # a state that is not a multiple of the lanes
    (1, 77, 96, 64, 4),        # the largest state
    (2, 1, 16, 16, 8),         # one token
])
def test_fused_scan_kernel_matches_plain(cuda_device, b, L, d, n, r):
    gen = torch.Generator(device=cuda_device).manual_seed(b + L + d + n)
    args = _fused_inputs(gen, b, L, d, n, r, cuda_device)
    before = dict(scan_kernel.LAUNCHES)
    y, h = scan_kernel.mamba1_scan_fused(*args, return_state=True)
    y_only = scan_kernel.mamba1_scan_fused(*args)
    yp, hp = scan_ref.mamba1_scan_fused_plain(*args, return_state=True)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES["mamba1_scan_fused"] == before["mamba1_scan_fused"] + 2
    assert scan_kernel.LAUNCHES["selective_scan"] == before["selective_scan"]
    assert y.dtype == torch.bfloat16 and y.shape == (b, L, d) and h.shape == (b, d, n)
    torch.testing.assert_close(y.float(), yp.float(), **FUSED_TOL)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)
    assert torch.equal(y_only, y)


@pytest.mark.gpu
def test_fused_scan_refuses_what_it_cannot_read(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    args = list(_fused_inputs(gen, 1, 16, 64, 16, 8, cuda_device))
    before = dict(scan_kernel.LAUNCHES)
    bad = args.copy()
    wide = torch.zeros((1, 16, 129), dtype=torch.bfloat16, device=cuda_device)
    bad[7] = wide[..., 1:65]                             # rows off 16 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        scan_kernel.mamba1_scan_fused(*bad)
    with pytest.raises(ValueError, match="d a multiple of 8"):
        scan_kernel.mamba1_scan_fused(*(t[..., :60] if t.dim() == 3 and i != 4 and i != 5
                                        else t for i, t in enumerate(args)))
    bad = args.copy()
    bad[1] = args[1].float()
    with pytest.raises(ValueError, match="dt_raw has dtype"):
        scan_kernel.mamba1_scan_fused(*bad)
    bad = args.copy()
    bad[7] = args[7].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="unit stride"):
        scan_kernel.mamba1_scan_fused(*bad)
    assert scan_kernel.LAUNCHES == before


@pytest.mark.gpu
def test_mamba1_apply_launches_the_fused_scan_once_a_layer(cuda_device):
    """The reduced falcon-mamba's prefill on the card: one fused launch a
    layer, no unfused launch."""
    api = get_api("falcon-mamba-7b", reduced=True)
    params = api.init(0, "cpu").to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, api.cfg.vocab, (2, 40))).to(cuda_device)
    before = dict(scan_kernel.LAUNCHES)
    logits, cache = api.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES["mamba1_scan_fused"] == \
        before["mamba1_scan_fused"] + api.cfg.n_layers
    assert scan_kernel.LAUNCHES["selective_scan"] == before["selective_scan"]
    assert torch.isfinite(logits.float()).all()


# ---------------------------------------------------------------------------
# the placement window at fleets above 384 endpoints and 1,024 lanes
# ---------------------------------------------------------------------------


# per fleet (scaled_testbed replicas): its lanes and what its launch plan
# must hold
_LARGE_PLANS = {
    100: (416, {"lanes_per_thread": 1, "state_on_chip": True, "slots_on_chip": False}),
    257: (1056, {"lanes_per_thread": 2, "state_on_chip": True, "operands_on_chip": True}),
    400: (1600, {"lanes_per_thread": 2, "state_on_chip": True, "operands_on_chip": False}),
    540: (2176, {"lanes_per_thread": 3, "state_on_chip": False,
                 "operands_on_chip": False}),
    600: (2400, {"lanes_per_thread": 3, "state_on_chip": False,
                 "operands_on_chip": False}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("n_tasks,replicas", [(300, 100), (200, 257), (48, 400),
                                              (48, 540), (48, 600)])
def test_greedy_window_kernel_matches_plain_on_large_fleets(cuda_device, n_tasks,
                                                           replicas):
    """416 lanes (scaled_testbed(100), C = 64: the slot matrix no longer fits
    in a block's shared memory), 1,056 lanes (two lanes a thread), 1,600
    (the step operands in global memory), and 2,176 and 2,400 (three a
    thread, the lane state in global memory too)."""
    p, n_ep, n_units = _window(n_tasks, replicas, cuda_device)
    lanes, want_plan = _LARGE_PLANS[replicas]
    assert p["base"].shape[2] == lanes
    got_plan = kernel.plan(lanes, p["slots"].shape[2], p["staged"].shape[1])
    assert {k: got_plan[k] for k in want_plan} == want_plan
    before = kernel.LAUNCHES["greedy_window"]
    out_k = kernel.greedy_window(p, n_ep, n_units)
    out_p = ops._greedy_scan_plain(p, n_ep, n_units)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    for k in out_k:
        assert torch.equal(_bits(out_k[k]), _bits(out_p[k])), k


@pytest.mark.gpu
def test_mhra_on_card_matches_soa_at_400_endpoints(cuda_device):
    tasks, eps, store, tm = reference_case(256, 100, True, nb_max=15.0)
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=0.5, engine="soa")
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    before = kernel.LAUNCHES["greedy_window"]
    b = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=0.5)
    c = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=0.5, device="cpu")
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    for f in SCHEDULE_FIELDS:
        assert getattr(a, f) == getattr(b, f) == getattr(c, f), f


@pytest.mark.gpu
def test_all_singleton_cluster_mhra_on_card_matches_cpu_and_soa(cuda_device):
    """``max_cluster_size=1``: every cluster one single-input task, so
    Cluster MHRA takes the fused route, one window launch on the card,
    equal to the CPU's plain path and the reference's soa engine."""
    tasks, eps, store, tm = reference_case(384, 8, True, nb_max=6.0)
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=0.5,
                               max_cluster_size=1, engine="soa")
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    before = kernel.LAUNCHES["greedy_window"]
    b = port_sched.cluster_mhra(ptasks, peps, pstore, ptm, alpha=0.5,
                                max_cluster_size=1)
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    c = port_sched.cluster_mhra(ptasks, peps, pstore, ptm, alpha=0.5,
                                max_cluster_size=1, device="cpu")
    for f in SCHEDULE_FIELDS:
        assert getattr(a, f) == getattr(b, f) == getattr(c, f), f
    before = kernel.LAUNCHES["greedy_window"]
    d = port_sched.cluster_mhra(ptasks, peps, pstore, ptm, alpha=0.5)
    assert kernel.LAUNCHES["greedy_window"] == before   # clustered: host
    assert set(d.assignments) == set(b.assignments)


@pytest.mark.gpu
def test_soa_engine_equals_window_kernel(cuda_device):
    """The reference's soa <=> jax contract inside the port, on the card:
    one window of single-input tasks through the host SoA engine and
    through the CUDA window kernel, with the end states."""
    tasks, eps, store, tm = reference_case(2048, 8, True, nb_max=20.0)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    table = port_sched.PredictionTable(ptasks, peps, pstore)
    sf1, sf2, _ = port_sched._normalizers_fast(ptasks, peps, table, ptm)
    s_host = port_sched.SoAState(peps, ptm)
    s_card = port_sched.SoAState(peps, ptm)
    a = port_sched._mhra_soa([[t] for t in ptasks],
                             [[i] for i in range(len(ptasks))], peps, table,
                             ptm, 0.5, port_sched.HEURISTICS, sf1, sf2, s_host)
    before = kernel.LAUNCHES["greedy_window"]
    b = port_sched.mhra(ptasks, peps, pstore, ptm, 0.5, state=s_card)
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    for f in SCHEDULE_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert s_host.metrics() == s_card.metrics()
    assert s_host.cached == s_card.cached
    np.testing.assert_array_equal(s_host.free, s_card.free)


# ---------------------------------------------------------------------------
# the four scoring registers armed in the window kernel
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("replicas,regs", [
    (8, ("carbon",)), (8, ("lookahead",)), (8, ("warm",)), (8, ("fairness",)),
    (8, REGISTERS), (100, REGISTERS), (400, REGISTERS), (540, REGISTERS)])
def test_greedy_window_kernel_matches_plain_with_registers(cuda_device, replicas,
                                                           regs):
    """Each register alone at 32 lanes, then all four with a hop table of
    many rows at 32, 416, 1,600 and 2,176 lanes (every launch plan with
    the lane state and the step operands on and off chip)."""
    p, n_ep, n_units = _window(320 if replicas == 8 else 96, replicas,
                               cuda_device, regs=regs)
    if "lookahead" in regs:
        assert p["hv_tab"].shape[0] > 8
    if replicas in _LARGE_PLANS:
        lanes, want_plan = _LARGE_PLANS[replicas]
        got_plan = kernel.plan(lanes, p["slots"].shape[2], p["staged"].shape[1])
        assert {k: got_plan[k] for k in want_plan} == want_plan
    before = kernel.LAUNCHES["greedy_window"]
    out_k = kernel.greedy_window(p, n_ep, n_units)
    out_p = ops._greedy_scan_plain(p, n_ep, n_units)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    for k in out_k:
        assert torch.equal(_bits(out_k[k]), _bits(out_p[k])), k


@pytest.mark.gpu
@pytest.mark.parametrize("replicas,alive_dead", [(8, ()), (2, (1, 6))])
def test_mhra_on_card_with_registers_matches_cpu_and_soa(cuda_device, replicas,
                                                         alive_dead):
    """All four registers through ``mhra(device=None)``: one window launch,
    ``==`` the CPU's plain path and the reference's soa engine."""
    tasks, eps, store, tm = reference_case(400, replicas, True, nb_max=15.0)
    tasks, kw = register_case(tasks, eps, 32)
    alive = (tuple(i not in alive_dead for i in range(len(eps)))
             if alive_dead else None)
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=0.4, engine="soa",
                       alive=alive, **kw)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    pkw = port_registers(kw)
    before = kernel.LAUNCHES["greedy_window"]
    b = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=0.4, alive=alive,
                        **pkw)
    assert kernel.LAUNCHES["greedy_window"] == before + 1
    c = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=0.4, alive=alive,
                        device="cpu", **pkw)
    for f in SCHEDULE_FIELDS:
        assert getattr(a, f) == getattr(b, f) == getattr(c, f), f
    assert b.carbon_g is not None


@pytest.mark.gpu
def test_online_arrivals_stream_on_card_matches_cpu(cuda_device):
    """The online-arrivals stream (``examples/online_arrivals.py``: the
    Table-I testbed, 4 windows of 140, monitoring on) through the port's
    ``OnlineEngine`` on the card and on the CPU: one window launch a
    window against the live state, and every window's schedule, records
    and attributed joules, the learned profiles and the summary equal."""
    from repro_torch.core.endpoint import table1_testbed
    from repro_torch.core.engine import OnlineEngine
    from repro_torch.core.scheduler import TaskSpec
    from repro_torch.core.testbed import SEBS_FUNCTIONS, TestbedSim

    runs = []
    for device in (None, "cpu"):
        eps = table1_testbed()
        eng = OnlineEngine(eps, TestbedSim(eps, seed=0), policy="mhra",
                           alpha=0.2, window_s=30.0, max_batch=512,
                           monitoring=True, device=device)
        out = []
        for w in range(4):
            eng.submit_many([TaskSpec(id=f"w{w}t{i}",
                                      fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)])
                             for i in range(140)])
            before = kernel.LAUNCHES["greedy_window"]
            res = eng.flush()
            launched = kernel.LAUNCHES["greedy_window"] - before
            assert launched == (1 if device is None else 0)
            out.append((tuple(getattr(res.schedule, f) for f in SCHEDULE_FIELDS),
                        res.attributed_j,
                        [(r.task_id, r.endpoint, r.t_start, r.t_end, r.energy_j)
                         for r in res.sim.records]))
        s = eng.summary()
        runs.append((out, eng.store.stats(), s.energy_j, s.makespan_s,
                     s.attributed_j, s.objective))
    assert runs[0] == runs[1]


def _scenario_on_card_and_cpu(scenario):
    """Every run of one ``paper_eval`` scenario at its tiny size on the card
    and on the CPU: the rows, and the window launches on the card."""
    from _torch_eval import PORT, RUNS, run_bits, run_case
    launches = 0
    for label, *_ in RUNS[scenario]:
        before = kernel.LAUNCHES["greedy_window"]
        card = run_case(PORT, scenario, label, where={"device": None})
        launches += kernel.LAUNCHES["greedy_window"] - before
        cpu = run_case(PORT, scenario, label)
        assert run_bits(card) == run_bits(cpu), label
        assert card.engine == ("n/a" if cpu.engine == "n/a" else "cuda")
    return launches


@pytest.mark.gpu
def test_paper_eval_dag_scenario_on_card_matches_cpu(cuda_device):
    """The molecular-design DAG scenario (``examples/paper_eval.py`` at its
    tiny size, every policy row) through ``run_policy`` on the card and on
    the CPU: every ``PolicyRun`` field but the clock and the engine label
    equal, at least one window launch, and every DAG edge honored on the
    card's windows."""
    from _torch_eval import PORT, run_case
    from repro_torch.core.evaluate import verify_dag_order
    assert _scenario_on_card_and_cpu("moldesign") >= 1
    _, windows = run_case(PORT, "moldesign", "lookahead_mhra",
                          where={"device": None}, return_windows=True)
    assert verify_dag_order(windows) > 0


@pytest.mark.gpu
def test_paper_eval_synthetic_scenario_on_card_matches_cpu(cuda_device, capsys):
    """The synthetic scenario the same way; its windows hold two-input io
    tasks, so they go to the host SoA engine: the launch count is printed."""
    launches = _scenario_on_card_and_cpu("synthetic")
    with capsys.disabled():
        print(f"\nsynthetic scenario (tiny): {launches} greedy_window launches")


# ---------------------------------------------------------------------------
# the trainer's slice: flash attention's lse and its backward kernel
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, d, causal, dtype): head dims 16, 64, 80 and 128; GQA
# groups 1, 4, 5 and 6; causal with sq = sk and sq < sk, and not (sq = sk
# and sq != sk); lengths that are not multiples of the 64-row tiles; one
# query row; granite's heads; whisper-tiny's encoder (1,500 frames: a
# 92-key last tile of 128), cross-attention (448 queries, ragged in both)
# and causal decoder (6 heads of 64, group 1), and internvl2's 48 heads
# over 8 (group 6) at a length of 15 tiles of 64 and 40
BWD_CASES = [
    (2, 128, 128, 4, 4, 16, True, torch.bfloat16),
    (2, 200, 200, 8, 2, 64, True, torch.bfloat16),
    (1, 100, 229, 10, 2, 128, True, torch.bfloat16),
    (2, 257, 257, 5, 1, 128, False, torch.bfloat16),
    (1, 130, 333, 4, 1, 80, True, torch.bfloat16),
    (2, 1, 300, 8, 2, 64, True, torch.bfloat16),
    (2, 90, 333, 8, 8, 16, False, torch.bfloat16),
    (2, 1024, 1024, 32, 8, 64, True, torch.bfloat16),
    (1, 1500, 1500, 6, 6, 64, False, torch.bfloat16),
    (2, 448, 1500, 6, 6, 64, False, torch.bfloat16),
    (2, 448, 448, 6, 6, 64, True, torch.bfloat16),
    (1, 1000, 1000, 48, 8, 128, True, torch.bfloat16),
    (1, 65, 65, 4, 4, 16, True, torch.float32),
    (2, 100, 229, 8, 2, 64, True, torch.float32),
    (1, 90, 90, 10, 2, 128, False, torch.float32),
    (1, 70, 150, 4, 1, 80, True, torch.float32),
]


def _bwd_inputs(cuda_device, b, sq, sk, h, kv, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(7 * sq + sk + h)
    q = _randn(gen, (b, sq, h, d), dtype, cuda_device)
    k = _randn(gen, (b, sk, kv, d), dtype, cuda_device)
    v = _randn(gen, (b, sk, kv, d), dtype, cuda_device)
    do = _randn(gen, (b, sq, h, d), dtype, cuda_device)
    return q, k, v, do


def _assert_grad_close(name, got, want, dtype):
    """A gradient against its plain version, element by element: |err| <=
    tol * (|want| + the RMS of its row (the d entries of one position and
    head) + a tenth of the whole gradient's RMS), tol 2e-2 in bf16 (P^T and
    dS rounded to bf16 for their products, as the forward rounds P) and
    2e-5 in f32; and the error's Frobenius norm within 1e-2 (f32 1e-5) of
    the gradient's.  The gradients fall off with the position (a causal
    row of length i weights each key about 1/i), so a bound from the
    largest element would pass errors on the later tiles; chip_smoke.py
    holds the kernel to the same rule (``grad_errors``)."""
    tol, fro_tol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-5)
    g, w = got.float(), want.float()
    err = (g - w).abs()
    row = w.pow(2).mean(-1, keepdim=True).sqrt()
    allowed = tol * (w.abs() + row + 0.1 * float(w.pow(2).mean().sqrt()))
    assert bool(torch.isfinite(g).all()), name
    assert not bool((err > allowed).any()), (name, float((err / allowed).max()))
    fro = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    assert fro <= fro_tol, (name, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,dtype", BWD_CASES)
def test_flash_attention_lse_matches_plain(cuda_device, b, sq, sk, h, kv, d, causal,
                                           dtype):
    """The forward's log-sum-exp (natural log of the scaled scores; the
    bf16 route keeps it in base 2 and converts) against the plain one, and
    the output unchanged by asking for it."""
    q, k, v, _ = _bwd_inputs(cuda_device, b, sq, sk, h, kv, d, dtype)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=causal, return_lse=True)
    o_only = flash_kernel.flash_attention(q, k, v, causal=causal)
    want_o, want_lse = flash_ref.attention_plain_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert torch.equal(o, o_only)
    torch.testing.assert_close(o.float(), want_o.float(), **_tol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.bfloat16 else 2e-5,
                               rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,dtype", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, b, sq, sk, h, kv, d,
                                                  causal, dtype):
    """dq, dk and dv of the backward kernel against the plain backward on
    the same inputs (the kernel forward's o and lse), each element within
    its tolerance (``_assert_grad_close``); one count a call, and bitwise
    the same on a second call (dQ summed in a fixed order)."""
    q, k, v, do = _bwd_inputs(cuda_device, b, sq, sk, h, kv, d, dtype)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=causal, return_lse=True)
    before = flash_kernel.LAUNCHES["flash_attention_bwd"]
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_ref.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention_bwd"] == before + 2
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), name
        _assert_grad_close(name, g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,sk,h,kv,d,causal", [
    (2, 1024, 1024, 8, 2, 64, True), (2, 1024, 1024, 8, 2, 64, False),
    (1, 640, 640, 8, 8, 128, True), (2, 448, 1500, 6, 6, 64, False)])
def test_flash_attention_bwd_is_bitwise_the_same_call_after_call(cuda_device, b, s, sk, h,
                                                                kv, d, causal):
    """On the wgmma route, where many key tiles add into each query tile's
    dQ (8 key tiles of 128 at 1,024, 5 at 640, 12 at whisper's 1,500
    cross keys, the last of 92) on a persistent grid that hands them to
    whichever SM is free: three calls give the same bits, as the counters
    fix the order of the adds; and the gradients hold."""
    q, k, v, do = _bwd_inputs(cuda_device, b, s, sk, h, kv, d, torch.bfloat16)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert flash_kernel.bwd_plan(b, s, sk, h, kv, d, q.dtype, causal).route == "wgmma"
    calls = [flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
             for _ in range(3)]
    want = flash_ref.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for i, name in enumerate(("dq", "dk", "dv")):
        assert torch.equal(calls[0][i], calls[1][i]) and torch.equal(calls[0][i], calls[2][i])
        _assert_grad_close(name, calls[0][i], want[i], torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd_launches_both_kernels(cuda_device, dtype):
    """Through the op with inputs that require a gradient: one forward
    launch (with the lse) and one backward call, and the gradients of the
    backward kernel; without a gradient, the forward alone."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    b, sq, sk, h, kv, d = 2, 96, 96, 8, 2, 64
    q, k, v, do = _bwd_inputs(cuda_device, b, sq, sk, h, kv, d, dtype)
    before = dict(flash_kernel.LAUNCHES)
    with torch.no_grad():
        flash_ops.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert flash_kernel.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = flash_ops.flash_attention(qg, kg, vg, causal=True)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    o, lse = flash_kernel.flash_attention(q.detach(), k, v, causal=True, return_lse=True)
    want = flash_kernel.flash_attention_bwd(q.detach(), k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention"] == before["flash_attention"] + 3
    assert flash_kernel.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
    assert torch.equal(out, o)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_reduced_granite_train_steps_on_card_match_cpu(cuda_device):
    """4 train steps of reduced granite on the card (the forward and
    backward kernels, remat) against the same steps on the CPU (their
    plain versions) from one float32 state, within the CPU tests' bounds
    (twice the reference's own spread, tests/test_torch_train.py): the
    loss 3.46e-3 and the grad norm 12% (relative) at every step, the
    params 0.0106, m 8.6e-3 and v 8.8e-4 on every element; 2 flash
    launches and one backward call a layer a step."""
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    api = get_api("granite-3-2b", reduced=True)
    toks = np.random.default_rng(0).integers(0, api.cfg.vocab, (4, 4, 129))
    runs = {}
    for name, where in (("cpu", "cpu"), ("card", cuda_device)):
        params = api.init(0, "cpu", dtype=torch.float32, trainable=True).to(where)
        state = {"params": params, "opt": init_opt_state(params)}
        step = build_train_step(api, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
        metrics = []
        for t in toks:
            before = dict(flash_kernel.LAUNCHES)
            state, m = step(state, {"tokens": torch.from_numpy(t[:, :-1]).to(where),
                                    "labels": torch.from_numpy(t[:, 1:]).to(where)})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if name == "card":
                L = api.cfg.n_layers
                assert flash_kernel.LAUNCHES["flash_attention"] == \
                    before["flash_attention"] + 2 * L
                assert flash_kernel.LAUNCHES["flash_attention_bwd"] == \
                    before["flash_attention_bwd"] + L
        runs[name] = (metrics, {n: p.detach().cpu() for n, p in
                                state["params"].named_parameters()},
                      {k: {n: t.cpu() for n, t in state["opt"][k].items()} for k in "mv"})
    (cm, cp, co), (gm, gp, go) = runs["cpu"], runs["card"]
    for (cl, cg), (gl, gg) in zip(cm, gm):
        assert np.isfinite(gl) and abs(gl - cl) <= 3.46e-3
        assert abs(gg - cg) <= 0.12 * cg
    for tol, c, g in ((0.0106, cp, gp), (8.6e-3, co["m"], go["m"]),
                      (8.8e-4, co["v"], go["v"])):
        assert max(float((g[n] - c[n]).abs().max()) for n in c) <= tol


# ---------------------------------------------------------------------------
# the SSD's and the fused scan's backward kernels
# ---------------------------------------------------------------------------

def _smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("dS_used", [True, False])
def test_ssd_gradient_on_the_card_is_the_plain_backward(cuda_device, dS_used):
    """A gradient through ``ssd_op`` on the card is never cut at the SSD:
    it runs the backward kernel once and equals the plain backward within
    ``chip_smoke.ssm_grad_errors``'s bound; the kernel wrapper itself
    refuses inputs that require a gradient."""
    cs = _smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(27)
    xdt, loga, B, C, dy, dS = cs.ssd_bwd_case(gen, cuda_device, 2, 300, 4, 64, 64, True)
    leaves = [t.clone().requires_grad_() for t in (xdt, loga, B, C)]
    with pytest.raises(ValueError, match="ssd_op"):
        ssd_kernel.ssd(*leaves)
    before = dict(ssd_kernel.LAUNCHES)
    y, S = ssd_ops.ssd_op(*leaves)
    loss = (y * dy).sum() + ((S * dS).sum() if dS_used else 0)
    loss.backward()
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd"] == before["ssd"] + 1
    assert ssd_kernel.LAUNCHES["ssd_bwd"] == before["ssd_bwd"] + 1
    want = ssd_ref.ssd_plain_bwd(xdt, loga, B, C, dy, dS if dS_used else None)
    got = {k: t.grad for k, t in zip(cs.SSD_GRADS, leaves)}
    errs = cs.ssm_grad_errors(got, dict(zip(cs.SSD_GRADS, want)))
    assert all(e["ratio"] <= 1.0 for e in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 300, 4, 64, 64, True), (1, 100, 3, 16, 8, False),
                                  (1, 130, 2, 128, 128, True)])
def test_ssd_bwd_kernel_matches_plain_and_is_deterministic(cuda_device, case):
    cs = _smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(sum(case))
    a = cs.ssd_bwd_case(gen, cuda_device, *case)
    cs.ssm_bwd_check(f"ssd_bwd {case}", lambda: ssd_kernel.ssd_bwd(*a),
                     lambda: ssd_ref.ssd_plain_bwd(*a), cs.SSD_GRADS, "test", plant="dxdt")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 100, 72, 16), (2, 33, 200, 64), (1, 1, 8, 4)])
def test_fused_scan_bwd_kernel_matches_plain_and_is_deterministic(cuda_device, case):
    """Within the bound of the plain backward, bitwise on a second call;
    a 1% error planted in dB is caught where dB has more than one token
    (one token's four values sit within a bf16 ulp and the bound's 1e-3 of
    it)."""
    cs = _smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(sum(case))
    args, dy = cs.scan_bwd_case(gen, cuda_device, *case)
    cs.ssm_bwd_check(f"mamba1_scan_bwd {case}",
                     lambda: scan_kernel.mamba1_scan_fused_bwd(*args, dy),
                     lambda: scan_ref.mamba1_scan_fused_plain_bwd(*args, dy),
                     cs.SCAN_GRADS, "test", plant="dB" if case[1] > 1 else None)


@pytest.mark.gpu
def test_fused_scan_gradient_on_the_card_launches_the_backward(cuda_device):
    """The fused op under autograd on the card: one forward launch, one
    backward call, the gradients in the inputs' dtypes and within the
    check's bound of the plain backward."""
    cs = _smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    args, dy = cs.scan_bwd_case(gen, cuda_device, 2, 64, 128, 16)
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point() else t
              for t in args]
    before = dict(scan_kernel.LAUNCHES)
    y = scan_kernel.mamba1_scan_fused(*leaves)
    y.backward(dy)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES["mamba1_scan_fused"] == before["mamba1_scan_fused"] + 1
    assert scan_kernel.LAUNCHES["mamba1_scan_bwd"] == before["mamba1_scan_bwd"] + 1
    want = scan_ref.mamba1_scan_fused_plain_bwd(*args, dy)
    got = {k: t.grad for k, t in zip(cs.SCAN_GRADS, leaves)}
    assert all(got[k].dtype == w.dtype for k, w in zip(cs.SCAN_GRADS, want))
    errs = cs.ssm_grad_errors(got, dict(zip(cs.SCAN_GRADS, want)))
    assert all(e["ratio"] <= 1.0 for e in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "falcon-mamba-7b"])
def test_reduced_ssm_train_steps_on_card_match_cpu(cuda_device, arch):
    """Reduced zamba2 and falcon-mamba train steps on the card against the
    CPU (``chip_smoke.train_slice_compare`` at ``FAMILY_SLICE_TOL``;
    falcon-mamba's steps each from the CPU's state, as phase 34)."""
    cs = _smoke()
    counters = (kernel.LAUNCHES, flash_kernel.LAUNCHES, dec_kernel.LAUNCHES,
                ssd_kernel.LAUNCHES, scan_kernel.LAUNCHES)
    cs.train_slice_compare(cuda_device, "test", get_api(arch, reduced=True),
                           cs.FAMILY_SLICE_TOL[arch], counters, 3, arch,
                           steps_from_cpu=arch in cs.SSM_STEPS_FROM_CPU)
