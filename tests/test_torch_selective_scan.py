"""Port Mamba1 selective scan (``repro_torch.kernels.selective_scan``)
against the reference: the plain version (the sequential recurrence)
against the JAX oracle ``selective_scan_ref`` and against the Pallas kernel
called directly in interpret mode, on the cases of ``tests/test_kernels.py``
(``SCAN_CASES``), plus chunk and length invariance, the final state, and
the wrapper's refusals.  The tolerance is the reference's own: atol and
rtol 1e-4.  The reference's XLA path returns its final state only from the
Mamba1 block, so the state is held against it in
``test_torch_falcon_mamba.py``; here it is held against the recurrence run
in two pieces.  The CUDA kernel against its plain version on the card is
in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.kernel import selective_scan as pallas_scan
from repro.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan import kernel, ops, ref

CASES = [
    # (b, L, d, n, block_d, chunk) — test_kernels.py SCAN_CASES
    (2, 64, 128, 16, 64, 32),
    (1, 128, 64, 8, 64, 64),
    (1, 64, 256, 16, 128, 32),
]
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, L, d, n):
    """As the reference's kernel tests draw them: dt = softplus(0.5 g - 1),
    A = -exp(0.3 g)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    g = rng.standard_normal((b, L, d)) * 0.5 - 1
    dt = np.logaddexp(g, 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal((d, n)) * 0.3)).astype(np.float32)
    B = rng.standard_normal((b, L, n)).astype(np.float32)
    C = rng.standard_normal((b, L, n)).astype(np.float32)
    D = rng.standard_normal(d).astype(np.float32)
    return x, dt, A, B, C, D


def _t(arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle_and_pallas(case):
    b, L, d, n, bd, ch = case
    args = _inputs(sum(case), b, L, d, n)
    y = ref.selective_scan_plain(*_t(args))
    assert y.shape == (b, L, d) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(selective_scan_ref(*_j(args))), **TOL)
    yp = pallas_scan(*_j(args), block_d=bd, chunk=ch, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **TOL)


def test_op_is_chunk_and_length_invariant_and_counts_nothing_on_cpu():
    """The port has one route for every length: on the CPU the op runs the
    recurrence, which has no chunks.  It agrees with the Pallas kernel at
    two chunk sizes, and on a ragged length (which the Pallas kernel does
    not take) with the oracle; a prefix of the sequence gives the prefix
    of the output."""
    args = _inputs(7, 1, 128, 64, 8)
    before = dict(kernel.LAUNCHES)
    y = ops.selective_scan_op(*_t(args))
    assert kernel.LAUNCHES == before
    for ch in (32, 128):
        yp = pallas_scan(*_j(args), block_d=64, chunk=ch, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(yp), **TOL)
    cut = 100
    short = tuple(a[:, :cut] if a.ndim == 3 else a for a in args)
    ys = ops.selective_scan_op(*_t(short))
    np.testing.assert_allclose(ys.numpy(), np.asarray(selective_scan_ref(*_j(short))),
                               **TOL)
    np.testing.assert_allclose(ys.numpy(), y[:, :cut].numpy(), atol=1e-6, rtol=1e-6)


def _continue(args, h, start):
    """The recurrence from state ``h`` over tokens ``start:`` (test-side)."""
    x, dt, A, B, C, D = (torch.from_numpy(a).double() for a in args)
    for t in range(start, x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + \
            (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
    return h


def test_final_state_carries_the_sequence():
    """The final state of the whole sequence equals the state of its first
    part carried over the rest (float64 on the test side), and asking for
    it leaves y unchanged."""
    args = _inputs(3, 2, 96, 64, 16)
    y, h = ops.selective_scan_op(*_t(args), return_state=True)
    assert h.shape == (2, 64, 16) and h.dtype == torch.float32
    assert torch.equal(y, ops.selective_scan_op(*_t(args)))
    head = tuple(a[:, :40] if a.ndim == 3 else a for a in args)
    _, h40 = ops.selective_scan_op(*_t(head), return_state=True)
    want = _continue(args, h40.double(), 40)
    np.testing.assert_allclose(h.numpy(), want.numpy(), **TOL)


def test_refuses_gradients_and_bad_devices():
    args = _t(_inputs(5, 1, 8, 16, 4))
    x = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        kernel.selective_scan(x, *args[1:])
    with torch.no_grad():   # without autograd the forward runs
        kernel.selective_scan(x, *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.selective_scan(*(a.to("meta") for a in args))
