"""Port flash attention (``repro_torch.kernels.flash_attention``) against
the reference: the plain version against the JAX oracle
(``attention_ref``) and against the Pallas kernel called directly in
interpret mode, on the cases of ``tests/test_kernels.py`` (GQA, head_dim
64/80/128, sq < sk, non-causal) plus ragged lengths.  Tolerances are the
reference's own: float32 2e-5, bfloat16 2e-2.  The CUDA kernel against
its plain version on the card is in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

CASES = [
    # (b, sq, sk, h, kv, d, causal, dtype) — test_kernels.py FLASH_CASES
    (2, 128, 128, 4, 2, 64, True, "float32"),
    (1, 256, 256, 8, 8, 128, True, "float32"),
    (2, 128, 256, 2, 1, 64, False, "float32"),
    (1, 128, 128, 4, 4, 128, True, "bfloat16"),
    (1, 384, 384, 6, 6, 64, True, "float32"),
    (2, 128, 128, 4, 1, 80, True, "float32"),
    # sq < sk causal (bottom-right), the shared block's width, bf16
    (1, 128, 384, 4, 2, 80, True, "bfloat16"),
]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, sq, sk, h, kv, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    # bf16 rounds the same float32 values in both frameworks
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle_and_pallas(case):
    b, sq, sk, h, kv, d, causal, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(sum(case[:6]), b, sq, sk, h, kv, d, dtype)
    got = ref.attention_plain(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (b, sq, h, d)
    want = attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pallas = pallas_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                          interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("sq,sk,causal", [(77, 77, True), (50, 130, True), (90, 33, False)])
def test_plain_ragged_lengths_match_jax_oracle(sq, sk, causal):
    """Lengths the Pallas kernel cannot tile: the port (and its kernel) has
    no divisibility limit, so it is held to the oracle alone."""
    (jq, jk, jv), (q, k, v) = _inputs(sq + sk, 2, sq, sk, 4, 2, 64, "float32")
    got = ref.attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(attention_ref(jq, jk, jv, causal=causal)),
                               atol=2e-5, rtol=2e-5)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    _, (q, k, v) = _inputs(3, 1, 128, 128, 4, 2, 64, "float32")
    before = dict(kernel.LAUNCHES)
    a = ops.flash_attention(q, k, v, causal=True)
    b_ = ref.attention_plain(q, k, v, causal=True)
    assert torch.equal(a, b_)
    assert kernel.LAUNCHES == before
