"""Port Mamba1 selective scan (``repro_torch.kernels.selective_scan``)
against the reference: the plain version (the sequential recurrence)
against the JAX oracle ``selective_scan_ref`` and against the Pallas kernel
called directly in interpret mode, on the cases of ``tests/test_kernels.py``
(``SCAN_CASES``), plus chunk and length invariance, the final state, the
wrapper's refusals and the fused op's float64 ``gradcheck``.  The tolerance is the reference's own: atol and
rtol 1e-4.  The reference's XLA path returns its final state only from the
Mamba1 block, so the state is held against it in
``test_torch_falcon_mamba.py``; here it is held against the recurrence run
in two pieces.  The fused op (``mamba1_scan_fused``: the Mamba1 block from
the dt_w product to out_proj) is held bitwise to the composition the block
ran before it existed, and to the reference's composition (softplus,
``selective_scan_ref``, silu) within the scan's 1e-4 before the bf16 cast
and one bf16 ulp after it.  The CUDA kernel against its plain versions on
the card is in ``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.selective_scan.kernel import selective_scan as pallas_scan
from repro.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan import kernel, ops, ref
from repro_torch.models import ssm

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


def _gradcheck_fused(seed, b, L, d, n, r):
    """``torch.autograd.gradcheck`` of the fused op in float64 on the CPU:
    its backward (the plain reverse recurrence) against finite
    differences of its forward, every input at once (z, B and C the
    strided views the block gives)."""
    args = [a.detach().double().requires_grad_() for a in _fused_inputs(seed, b, L, d, n, r)]
    xz = torch.cat([args[0], args[7]], dim=-1).detach().requires_grad_()
    bc = torch.cat([args[4], args[5]], dim=-1).detach().requires_grad_()

    def fn(xz, dt_raw, dt_b, A, bc, D):
        xc, z = xz.chunk(2, dim=-1)
        B, C = bc.split([n, n], dim=-1)
        return kernel.mamba1_scan_fused(xc, dt_raw, dt_b, A, B, C, D, z)

    assert torch.autograd.gradcheck(fn, (xz, args[1], args[2], args[3], bc, args[6]),
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_refuses_gradients_and_bad_devices():
    """The f32 form (the reference's interface, off the model's path) has
    no backward and says that the model trains through the fused form,
    whose gradient passes ``gradcheck``."""
    args = _t(_inputs(5, 1, 8, 16, 4))
    x = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="trains through mamba1_scan_fused"):
        kernel.selective_scan(x, *args[1:])
    with torch.no_grad():   # without autograd the forward runs
        kernel.selective_scan(x, *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.selective_scan(*(a.to("meta") for a in args))
    _gradcheck_fused(5, 1, 6, 8, 4, 2)


# ---------------------------------------------------------------------------
# the fused op: the Mamba1 block from the dt_w product to out_proj
# ---------------------------------------------------------------------------

#: (b, L, d, n, r): the reduced falcon-mamba widths, a ragged length, a
#: wider state, a one-token sequence
FUSED_CASES = [(2, 40, 128, 8, 8), (1, 37, 64, 16, 4), (2, 16, 32, 4, 8),
               (1, 1, 16, 8, 2)]


def _fused_inputs(seed, b, L, d, n, r):
    """Seeded numpy inputs laid out as the block leaves them: xc and
    dt_raw contiguous, z the second half of the in_proj product (rows of
    2d), B and C views of the x_proj product (rows of r + 2n); bf16
    tensors from float32 draws, A = -exp(A_log), dt_b and D float32."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    xz = bf(rng.standard_normal((b, L, 2 * d)))
    xc = bf(rng.standard_normal((b, L, d)))
    dbc = bf(rng.standard_normal((b, L, r + 2 * n)))
    dt_raw = bf(rng.standard_normal((b, L, d)) * 0.7 - 1.0)
    dt_b = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32))
    A = -torch.exp(torch.from_numpy((rng.standard_normal((d, n)) * 0.3)
                                    .astype(np.float32)))
    D = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    _, z = xz.chunk(2, dim=-1)
    _, B, C = torch.split(dbc, [r, n, n], dim=-1)
    return xc, dt_raw, dt_b, A, B, C, D, z


def _unfused_before(xc, dt_raw, dt_b, A, B, C, D, z, return_state=False):
    """What ``models.ssm.mamba1_apply`` ran between the dt_w product and
    out_proj before the fused op: softplus, the scan op, the gate, the
    cast, each its own op."""
    dtv = F.softplus(dt_raw.float() + dt_b)
    res = ops.selective_scan_op(xc.float(), dtv, A, B.float(), C.float(), D,
                                return_state=return_state)
    y, h = res if return_state else (res, None)
    y = (y * F.silu(z.float())).to(xc.dtype)
    return (y, h) if return_state else y


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_plain_is_bitwise_the_unfused_composition(case):
    args = _fused_inputs(sum(case), *case)
    b, L, d, n, r = case
    assert args[7].stride(1) == 2 * d and args[4].stride(1) == r + 2 * n
    y, h = ref.mamba1_scan_fused_plain(*args, return_state=True)
    y0, h0 = _unfused_before(*args, return_state=True)
    assert y.dtype == torch.bfloat16 and y.shape == (b, L, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert torch.equal(ref.mamba1_scan_fused_plain(*args), y0)


def _bf16_ulp(v):
    """Spacing of bf16 at |v| (8 significant bits)."""
    v = np.abs(v.astype(np.float64))
    e = np.floor(np.log2(np.where(v > 0, v, 1.0)))
    return np.where(v > 0, 2.0 ** (e - 7), 2.0 ** -133)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_plain_matches_reference_composition(case):
    """Against the reference block's kernel-branch ops on the same inputs:
    ``jax.nn.softplus``, ``selective_scan_ref`` and ``jax.nn.silu`` in
    float32 (the reference's ``mamba1_apply``, ``models/ssm.py:89-97``):
    within the scan's 1e-4 before the bf16 cast, within one bf16 ulp
    after it."""
    xc, dt_raw, dt_b, A, B, C, D, z = _fused_inputs(sum(case) + 1, *case)
    j = lambda t: jnp.asarray(t.float().numpy())
    dtv = jax.nn.softplus(j(dt_raw) + j(dt_b))
    yr = selective_scan_ref(j(xc), dtv, j(A), j(B), j(C), j(D))
    want = np.array(yr * jax.nn.silu(j(z)))
    # the port's plain op before its cast: the same op on float32 xc (its
    # values are xc's), whose dtype the result takes
    pre = ref.mamba1_scan_fused_plain(xc.float(), dt_raw, dt_b, A, B, C, D, z)
    assert pre.dtype == torch.float32
    np.testing.assert_allclose(pre.numpy(), want, **TOL)
    got = ref.mamba1_scan_fused_plain(xc, dt_raw, dt_b, A, B, C, D, z).float().numpy()
    want16 = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    assert np.all(np.abs(got - want16) <= _bf16_ulp(np.maximum(np.abs(got),
                                                              np.abs(want16))))


def test_fused_wrapper_on_cpu_runs_plain_and_launches_nothing():
    args = _fused_inputs(11, 2, 24, 64, 8, 8)
    before = dict(kernel.LAUNCHES)
    y, h = kernel.mamba1_scan_fused(*args, return_state=True)
    assert kernel.LAUNCHES == before
    y0, h0 = ref.mamba1_scan_fused_plain(*args, return_state=True)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert ssm.mamba1_scan_fused is kernel.mamba1_scan_fused   # the block's op


def test_fused_refuses_gradients_and_bad_devices():
    """The fused op takes a gradient (float64 ``gradcheck`` on a ragged
    length with a wider state); it refuses the final state under one (the
    trainer drops it, and it has no backward) and a device it has no
    route for."""
    args = _fused_inputs(12, 1, 8, 16, 4, 2)
    dt_b = args[2].clone().requires_grad_()
    y = kernel.mamba1_scan_fused(*args[:2], dt_b, *args[3:])
    assert y.grad_fn is not None
    with pytest.raises(ValueError, match="final state"):
        kernel.mamba1_scan_fused(*args[:2], dt_b, *args[3:], return_state=True)
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.mamba1_scan_fused(*(a.to("meta") for a in args))
    _gradcheck_fused(12, 2, 7, 8, 16, 3)
