"""Port decode attention (``repro_torch.kernels.decode_attention``)
against the reference: the plain version against the JAX oracle
(``decode_attention_ref``) and against the Pallas kernel called directly
in interpret mode, on the cases of ``tests/test_kernels.py`` (GQA, ragged
``cache_len``), plus the stale-tail property.  Tolerances are the
reference's own: float32 2e-5, bfloat16 2e-2.  The CUDA kernel against
its plain version on the card is in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import kernel, ops, ref

CASES = [
    # (b, S, h, kv, d, block_k, dtype) — test_kernels.py DECODE_CASES
    (2, 256, 4, 2, 64, 64, "float32"),
    (1, 512, 8, 1, 128, 128, "float32"),
    (3, 128, 4, 4, 64, 64, "bfloat16"),
    (1, 256, 8, 8, 80, 128, "float32"),
    # the shared block's head width in bf16, GQA group of 4
    (4, 384, 8, 2, 80, 128, "bfloat16"),
]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, S, h, kv, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, 1, h, d), (b, S, kv, d), (b, S, kv, d))]
    lens = (np.arange(1, b + 1) * (S // (b + 1)) + 3).astype(np.int32)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt, lens


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle_and_pallas(case):
    b, S, h, kv, d, bk, dtype = case
    (jq, jk, jv), (q, k, v), lens = _inputs(sum(case[:5]), b, S, h, kv, d, dtype)
    got = ref.decode_attention_plain(q, k, v, torch.from_numpy(lens))
    assert got.dtype == q.dtype and got.shape == (b, 1, h, d)
    jl = jnp.asarray(lens)
    np.testing.assert_allclose(_np(got), _np(decode_attention_ref(jq, jk, jv, jl)),
                               **_tol(dtype))
    pallas = pallas_decode(jq, jk, jv, jl, block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


def test_plain_ignores_stale_cache_tail():
    """Garbage past cache_len must not affect the result (the reference's
    masking property, test_kernels.py::test_decode_attention_ignores_stale_cache_tail)."""
    _, (q, k, v), _ = _inputs(7, 1, 128, 2, 2, 64, "float32")
    lens = torch.tensor([40], dtype=torch.int32)
    a = ref.decode_attention_plain(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 1e4
    v2[:, 40:] = -1e4
    b_ = ref.decode_attention_plain(q, k2, v2, lens)
    np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    _, (q, k, v), lens = _inputs(3, 2, 256, 4, 2, 64, "float32")
    before = dict(kernel.LAUNCHES)
    a = ops.decode_attention(q, k, v, lens)          # lengths as numpy
    b_ = ref.decode_attention_plain(q, k, v, torch.from_numpy(lens))
    assert torch.equal(a, b_)
    assert kernel.LAUNCHES == before
