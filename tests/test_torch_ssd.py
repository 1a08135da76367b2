"""Port Mamba2 SSD (``repro_torch.kernels.ssd``) against the reference:
the plain version (the sequential recurrence) against the JAX oracles
(``ssd_preweighted_ref``, and ``ssd_ref`` on the raw inputs) and against
the Pallas kernel called directly in interpret mode, on the cases of
``tests/test_kernels.py``, plus chunk invariance of the port's op.
Tolerances are the reference's own: atol 5e-4, rtol 5e-3.  The CUDA
kernel against its plain version on the card is in
``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd as pallas_ssd
from repro.kernels.ssd.ref import ssd_preweighted_ref, ssd_ref
from repro_torch.kernels.ssd import kernel, ops, ref

CASES = [
    # (b, L, nh, hd, n, chunk) — test_kernels.py SSD_CASES
    (2, 64, 4, 64, 32, 32),
    (1, 128, 2, 64, 64, 64),
    (1, 128, 8, 128, 64, 32),
    # zamba2's head_dim and state, reduced length
    (2, 128, 4, 64, 64, 128),
]
TOL = dict(atol=5e-4, rtol=5e-3)


def _inputs(seed, b, L, nh, hd, n):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, L, nh, hd)).astype(np.float32)
    dt = (rng.standard_normal((b, L, nh)) * 0.5).astype(np.float32)
    A_log = (rng.standard_normal(nh) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, L, n)).astype(np.float32)
    C = rng.standard_normal((b, L, n)).astype(np.float32)
    return xh, dt, A_log, B, C


def _preweighted(xh, dt, A_log):
    dtf = np.asarray(jax.nn.softplus(jnp.asarray(dt)))
    return xh * dtf[..., None], dtf * -np.exp(A_log)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracles_and_pallas(case):
    b, L, nh, hd, n, ch = case
    xh, dt, A_log, B, C = _inputs(sum(case), b, L, nh, hd, n)
    xdt, loga = _preweighted(xh, dt, A_log)
    y, S = ref.ssd_plain(*(torch.from_numpy(a) for a in (xdt, loga, B, C)))
    assert y.shape == (b, L, nh, hd) and S.shape == (b, nh, n, hd)
    yr, Sr = ssd_preweighted_ref(*(jnp.asarray(a) for a in (xdt, loga, B, C)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sr), **TOL)
    yr2, Sr2 = ssd_ref(*(jnp.asarray(a) for a in (xh, dt, A_log, B, C)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr2), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sr2), **TOL)
    yp, Sp = pallas_ssd(*(jnp.asarray(a) for a in (xdt, loga, B, C)), chunk=ch,
                        interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sp), **TOL)


def test_op_is_chunk_invariant_and_counts_nothing_on_cpu():
    """The chunk size does not change the op's result (on the CPU the
    wrapper runs the recurrence, which has no chunks at all), and the
    Pallas kernel at two chunk sizes agrees with it."""
    xh, dt, A_log, B, C = _inputs(11, 1, 128, 4, 32, 16)
    xdt, loga = _preweighted(xh, dt, A_log)
    before = dict(kernel.LAUNCHES)
    outs = [ops.ssd_op(*(torch.from_numpy(a) for a in (xdt, loga, B, C)), chunk=ch)
            for ch in (32, 128)]
    assert kernel.LAUNCHES == before
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for ch in (32, 64):
        yp, Sp = pallas_ssd(*(jnp.asarray(a) for a in (xdt, loga, B, C)), chunk=ch,
                            interpret=True)
        np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(yp), **TOL)
        np.testing.assert_allclose(outs[0][1].numpy(), np.asarray(Sp), **TOL)
