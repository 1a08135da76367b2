"""Port score+argmin (``repro_torch.kernels.placement``) against the
reference: ``pairwise_sum`` against ``np.sum``, ``score_fleet_plain``
against the NumPy oracle (bitwise) and against the Pallas kernel in
interpret mode (rtol 5e-15, the reference's own bound for XLA:CPU's FMA
contraction) and first-min ties.  The CUDA kernel against its plain
version on the card is in ``test_torch_gpu.py``."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.placement import kernel as ref_kernel
from repro.kernels.placement import ref as ref_oracle
from repro_torch.kernels.placement import kernel, ref

SCALARS = ("c_cur", "idle_on_sum", "a1", "b1", "g1", "w_idle_on")
REGS = ("e_base", "nl", "g_base", "lk", "fw", "wt")


def _case(seed, n):
    rng = np.random.default_rng(seed)
    kw = dict(
        e_base=rng.uniform(0.0, 5e4, n),
        nl=rng.uniform(0.0, 300.0, n),
        g_base=rng.uniform(0.0, 10.0, n),
        lk=rng.uniform(0.0, 3.0, n),
        fw=rng.uniform(0.0, 2.0, n),
        wt=rng.uniform(0.0, 1.0, n),
        alive=rng.random(n) < 0.8,
        c_cur=float(rng.uniform(0.0, 200.0)),
        idle_on_sum=float(rng.uniform(0.0, 500.0)),
        a1=float(rng.uniform(0.0, 1e-4)),
        b1=float(rng.uniform(0.0, 1e-2)),
        g1=float(rng.uniform(0.0, 1.0)),
        w_idle_on=float(rng.uniform(0.0, 1e-3)),
    )
    kw["alive"][int(rng.integers(n))] = True   # never a dead fleet
    return kw


def _tensors(kw, device="cpu"):
    out = {k: torch.from_numpy(kw[k]).to(device) for k in REGS}
    out["alive"] = torch.from_numpy(kw["alive"]).to(device)
    out.update({k: kw[k] for k in SCALARS})
    return out


def _pallas(kw):
    """The reference's Pallas kernel, interpret mode, float64."""
    n = len(kw["e_base"])
    lanes = ((n + 127) // 128) * 128
    with jax.enable_x64(True):
        import jax.numpy as jnp

        def p(v):
            return jnp.pad(jnp.asarray(v, dtype=jnp.float64), (0, lanes - n))

        scalars = jnp.array([kw[k] for k in SCALARS], dtype=jnp.float64)
        obj, _, idx = ref_kernel.score_fleet(
            scalars, *(p(kw[k]) for k in REGS),
            p(np.asarray(kw["alive"], dtype=np.float64)), interpret=True,
        )
        return np.asarray(obj)[:n], int(idx)


@pytest.mark.parametrize("n", [0, 1, 5, 7, 8, 9, 64, 127, 128, 129, 1000])
def test_pairwise_sum_matches_numpy_bitwise(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-1e6, 1e6, max(n, 1) + 3)
    assert float(ref.pairwise_sum(x, n)) == float(np.sum(x[:n]))
    assert float(ref.pairwise_sum(torch.from_numpy(x), n, base=2)) == \
        float(np.sum(x[2:2 + n]))


def test_pairwise_sum_batched_columns_match_numpy():
    """An (n, H) tensor sums each column with numpy's tree (the batched
    window greedy sums the run basis of every heuristic at once)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1e4, 1e4, (200, 4))
    got = ref.pairwise_sum(torch.from_numpy(x), 200)
    for h in range(4):
        assert float(got[h]) == float(np.sum(np.ascontiguousarray(x[:, h])))


@pytest.mark.parametrize("seed,n", [(0, 4), (1, 12), (2, 128), (3, 200),
                                    (4, 1000)])
def test_score_fleet_plain_matches_numpy_oracle_bitwise(seed, n):
    kw = _case(seed, n)
    obj_r, idx_r = ref_oracle.score_fleet(**kw)
    obj_p, idx_p = ref.score_fleet_plain(**_tensors(kw))
    np.testing.assert_array_equal(obj_p.numpy(), obj_r)
    assert int(idx_p) == idx_r


@pytest.mark.parametrize("seed,n", [(0, 4), (1, 12), (2, 128), (3, 200)])
def test_score_fleet_plain_matches_pallas_interpret(seed, n):
    kw = _case(seed, n)
    obj_k, idx_k = _pallas(kw)
    obj_p, idx_p = ref.score_fleet_plain(**_tensors(kw))
    np.testing.assert_allclose(obj_p.numpy(), obj_k, rtol=5e-15)
    assert np.array_equal(np.isinf(obj_p.numpy()), np.isinf(obj_k))
    assert int(idx_p) == idx_k


@pytest.mark.parametrize("dead_prefix", [0, 1, 130])
def test_score_fleet_first_min_ties(dead_prefix):
    """Equal scores across lanes (and across the Pallas kernel's 128-lane
    tiles) resolve to the lowest alive index, like np.argmin."""
    n = 256
    kw = _case(7, n)
    for k in REGS:
        kw[k] = np.zeros(n)
    kw["alive"] = np.ones(n, dtype=bool)
    kw["alive"][:dead_prefix] = False
    _, idx_p = ref.score_fleet_plain(**_tensors(kw))
    _, idx_r = ref_oracle.score_fleet(**kw)
    _, idx_k = _pallas(kw)
    assert int(idx_p) == idx_r == idx_k == dead_prefix


def test_score_fleet_wrapper_runs_plain_on_cpu_without_launching():
    kw = _case(3, 40)
    kernel.reset_launches()
    obj_w, idx_w = kernel.score_fleet(**_tensors(kw))
    obj_p, idx_p = ref.score_fleet_plain(**_tensors(kw))
    assert torch.equal(obj_w, obj_p) and int(idx_w) == int(idx_p)
    assert kernel.LAUNCHES == {"score_fleet": 0, "greedy_window": 0}
