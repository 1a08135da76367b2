"""Port Mamba2 SSD (``repro_torch.kernels.ssd``) against the reference:
the plain version (the sequential recurrence) against the JAX oracles
(``ssd_preweighted_ref``, and ``ssd_ref`` on the raw inputs) and against
the Pallas kernel called directly in interpret mode, on the cases of
``tests/test_kernels.py``, plus chunk invariance of the port's op.
Tolerances are the reference's own: atol 5e-4, rtol 5e-3.  The CUDA
kernel's arithmetic (3xTF32 products in its chunked form) is emulated
here and held to the same oracles; the kernel itself against its plain
version on the card is in ``test_torch_gpu.py``."""
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


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated on the CPU: the chunked form with
# only the lower triangle entering M (exp taken only where t >= s), every
# product on TF32 parts as mma.sync tf32 takes them.  The kernel splits
# each f32 operand as CUTLASS's 3xTF32 does: hi rounds to nearest with ties
# away from zero (the rounding of ``cvt.rna.tf32.f32``: on the raw bits,
# add half of the 13 dropped bits' range to the magnitude and clear them);
# lo = a - hi is exact in f32, and the MMA reads only its top 19 bits
# (rounding toward zero).  A product of two TF32 values is exact in f32.
# ---------------------------------------------------------------------------


def _tf32(x):
    """Round to TF32, to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """What the MMA reads of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """lo*hi + hi*lo + hi*hi, with hi = rna(a) and lo = a - hi truncated."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _ssd_tensor_core_emulated(xdt, loga, B, C, chunk, mm):
    """ssd.cu's steps per chunk, with ``mm`` for every product: G = C B^T;
    M = G exp(cum_t - cum_s) on t >= s; y = M @ xdt + exp(cum) (C @ S);
    S = exp(total) S + B^T (xdt exp(total - cum))."""
    b, L, nh, hd = xdt.shape
    S = torch.zeros((b, nh, B.shape[-1], hd), dtype=torch.float32)
    ys = []
    for c0 in range(0, L, chunk):
        q = min(chunk, L - c0)
        x = xdt[:, c0:c0 + q].permute(0, 2, 1, 3)            # (b, nh, q, hd)
        cum = torch.cumsum(loga[:, c0:c0 + q].permute(0, 2, 1), -1)   # (b, nh, q)
        total = cum[..., -1:]
        Bc, Cc = B[:, c0:c0 + q], C[:, c0:c0 + q]            # (b, q, n)
        G = mm(Cc, Bc.transpose(-1, -2))[:, None]            # (b, 1, q, q)
        tri = torch.ones((q, q), dtype=torch.bool).tril()
        diff = cum[..., :, None] - cum[..., None, :]
        M = torch.where(tri, G * torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        y = mm(M, x)
        if c0 > 0:
            y = y + torch.exp(cum)[..., None] * mm(Cc[:, None], S)
        S = torch.exp(total)[..., None] * S + mm(
            Bc.transpose(-1, -2)[:, None], x * torch.exp(total - cum)[..., None])
        ys.append(y.permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1), S


def _worst_over_tolerance(got, want):
    """Largest |got - want| / (atol + rtol |want|): at most 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


@pytest.mark.parametrize("case", CASES + [
    (1, 200, 2, 64, 32, 128),    # a ragged last chunk
    (2, 50, 3, 32, 16, 128),     # L < chunk
    (1, 130, 4, 16, 8, 64),      # the reduced config's widths, ragged
])
def test_tensor_core_arithmetic_matches_oracle_and_pallas(case):
    """3xTF32 products in the kernel's chunked form hold the reference's
    atol 5e-4, rtol 5e-3 against the JAX oracle and the Pallas kernel in
    interpret mode (which needs whole chunks: at a ragged length it runs
    the sequence as one chunk)."""
    b, L, nh, hd, n, ch = case
    xh, dt, A_log, B, C = _inputs(sum(case), b, L, nh, hd, n)
    xdt, loga = _preweighted(xh, dt, A_log)
    y, S = _ssd_tensor_core_emulated(*(torch.from_numpy(a) for a in (xdt, loga, B, C)),
                                     ch, _mm_3xtf32)
    assert y.shape == (b, L, nh, hd) and S.shape == (b, nh, n, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    yr, Sr = ssd_preweighted_ref(*(jnp.asarray(a) for a in (xdt, loga, B, C)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sr), **TOL)
    yp, Sp = pallas_ssd(*(jnp.asarray(a) for a in (xdt, loga, B, C)),
                        chunk=ch if L % ch == 0 else L, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sp), **TOL)


def test_tensor_core_split_is_needed_at_zamba2_proportions():
    """Why the kernel splits: at zamba2's head_dim, state and chunk (b=1,
    L=1024, 8 heads of 64, state 64, chunk 128, seed 0), 3xTF32 stays
    inside the reference's tolerance against the port's f32 recurrence,
    and a single TF32 product does not."""
    b, L, nh, hd, n, ch = 1, 1024, 8, 64, 64, 128
    xh, dt, A_log, B, C = _inputs(0, b, L, nh, hd, n)
    xdt, loga = _preweighted(xh, dt, A_log)
    args = [torch.from_numpy(a) for a in (xdt, loga, B, C)]
    yp, Sp = ref.ssd_plain(*args)
    y3, S3 = _ssd_tensor_core_emulated(*args, ch, _mm_3xtf32)
    y1, S1 = _ssd_tensor_core_emulated(*args, ch, _mm_1xtf32)
    assert _worst_over_tolerance(y3, yp) <= 1.0
    assert _worst_over_tolerance(S3, Sp) <= 1.0
    assert max(_worst_over_tolerance(y1, yp), _worst_over_tolerance(S1, Sp)) > 1.0
