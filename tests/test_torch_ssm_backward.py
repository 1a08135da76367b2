"""The gradients of the port's two scans on the CPU: the plain backwards
(``kernels/ssd/ref.py::ssd_plain_bwd``, ``kernels/selective_scan/ref.py::
mamba1_scan_fused_plain_bwd``, explicit reverse recurrences that recompute
the states chunk by chunk) against ``jax.vjp`` of the reference's oracles,
and the autograd ops that the models call (``ssd_op``, ``mamba1_scan_fused``)
against the plain backwards.

The SSD's oracle is ``ssd_preweighted_ref`` (the sequential recurrence on
the pre-weighted inputs), with a nonzero dy and a nonzero final-state
gradient dS (and dS zero, the trainer's case).  The fused scan's is the
reference's composition in float32: ``softplus(dt_raw + dt_b)``,
``selective_scan_ref`` and the SiLU gate, its cotangent dy standard
normal.  Inputs come from numpy seeds; the cases take L not a multiple of
the chunk and d not a multiple of 128.  Both sides are float32 sequential
recurrences that add in different orders, so each gradient is held
elementwise within ``atol + rtol * |want|``:

  SSD:  dxdt, dB, dC  atol 1e-4, rtol 1e-4;  dloga  atol 1e-3, rtol 1e-4
        (a sum over n * hd products a token, up to ~2e3 in size)
  scan: every gradient atol 1e-4, rtol 1e-4, but dA and ddt_b (sums over
        b * L tokens) atol 1e-3, rtol 1e-4

Measured on the CPU (jax 0.9.0), the largest error over the cases as a
share of its bound: SSD dxdt 2.6%, dloga 6.7%, dB 4.3%, dC 4.8%; scan dxc
1.7%, ddt_raw 1.8%, ddt_b 0.8%, dA 0.8%, dB 3.9%, dC 3.0%, dD 2.2%, dz
5.1%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import selective_scan_ref
from repro.kernels.ssd.ref import ssd_preweighted_ref
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import costs

#: (b, L, nh, hd, n, chunk of the plain backward): the reduced zamba2
#: widths, a ragged L against the chunk, zamba2's head_dim and state, a
#: one-token sequence
SSD_CASES = [(2, 128, 8, 16, 8, 128), (1, 100, 3, 16, 8, 32), (1, 70, 2, 64, 64, 64),
             (2, 1, 4, 16, 8, 128)]
SSD_TOL = {"dxdt": (1e-4, 1e-4), "dloga": (1e-3, 1e-4), "dB": (1e-4, 1e-4),
           "dC": (1e-4, 1e-4)}
#: (b, L, d, n, chunk): the reduced falcon-mamba widths, d not a multiple
#: of 128 with a ragged L, a wider state, one token
SCAN_CASES = [(2, 128, 128, 8, 128), (1, 77, 100, 16, 32), (2, 40, 24, 32, 16),
              (1, 1, 8, 4, 128)]
SCAN_NAMES = ("dxc", "ddt_raw", "ddt_b", "dA", "dB", "dC", "dD", "dz")
SCAN_TOL = {k: (1e-3, 1e-4) if k in ("dA", "ddt_b") else (1e-4, 1e-4) for k in SCAN_NAMES}


def _ssd_inputs(seed, b, L, nh, hd, n):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, L, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, nh)) * 0.5)).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    return {"xdt": xh * dt[..., None], "loga": (dt * A).astype(np.float32),
            "B": rng.standard_normal((b, L, n)).astype(np.float32),
            "C": rng.standard_normal((b, L, n)).astype(np.float32),
            "dy": rng.standard_normal((b, L, nh, hd)).astype(np.float32),
            "dS": rng.standard_normal((b, nh, n, hd)).astype(np.float32)}


def _ssd_vjp(a, with_dS):
    args = tuple(jnp.asarray(a[k]) for k in ("xdt", "loga", "B", "C"))
    _, vjp = jax.vjp(ssd_preweighted_ref, *args)
    dS = a["dS"] if with_dS else np.zeros_like(a["dS"])
    return dict(zip(("dxdt", "dloga", "dB", "dC"),
                    (np.asarray(g) for g in vjp((jnp.asarray(a["dy"]), jnp.asarray(dS))))))


def _hold(got, want, tol):
    for k, w in want.items():
        atol, rtol = tol[k]
        g = got[k].detach().numpy().astype(np.float64)
        err = np.abs(g - w) - (atol + rtol * np.abs(w))
        assert g.shape == w.shape, k
        assert err.max() <= 0, (k, float(np.abs(g - w).max()))


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("with_dS", [True, False])
def test_ssd_plain_bwd_matches_jax_vjp_of_the_oracle(case, with_dS):
    b, L, nh, hd, n, chunk = case
    a = _ssd_inputs(sum(case), b, L, nh, hd, n)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = ssd_ref.ssd_plain_bwd(t["xdt"], t["loga"], t["B"], t["C"], t["dy"],
                                t["dS"] if with_dS else None, chunk=chunk)
    _hold(dict(zip(("dxdt", "dloga", "dB", "dC"), got)), _ssd_vjp(a, with_dS), SSD_TOL)


def test_ssd_plain_bwd_does_not_depend_on_its_chunk():
    a = _ssd_inputs(3, 1, 50, 2, 16, 8)
    t = [torch.from_numpy(a[k]) for k in ("xdt", "loga", "B", "C", "dy", "dS")]
    outs = [ssd_ref.ssd_plain_bwd(*t, chunk=c) for c in (7, 16, 50, 128)]
    for o in outs[1:]:
        for g, w in zip(o, outs[0]):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dS_used", [True, False])
def test_ssd_op_gradient_is_the_plain_backward(dS_used):
    """``ssd_op`` differentiates through its autograd function: the
    gradients of (y, S) are the plain backward's bitwise, and with S unused
    (the trainer) dS is absent, not a zero tensor."""
    a = _ssd_inputs(4, 2, 40, 3, 16, 8)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    leaves = [t[k].clone().requires_grad_() for k in ("xdt", "loga", "B", "C")]
    y, S = ssd_ops.ssd_op(*leaves, chunk=16)
    assert y.grad_fn is not None and S.grad_fn is not None
    loss = (y * t["dy"]).sum() + ((S * t["dS"]).sum() if dS_used else 0)
    loss.backward()
    want = ssd_ref.ssd_plain_bwd(*(t[k] for k in ("xdt", "loga", "B", "C", "dy")),
                                 t["dS"] if dS_used else None)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_ssd_kernel_wrapper_refuses_gradients_and_counts_nothing_on_cpu():
    """The kernel wrapper takes no part in autograd: inputs that require a
    gradient raise (on the card it would return tensors without one); the
    CPU runs the plain versions and counts no launch."""
    a = _ssd_inputs(5, 1, 16, 2, 16, 8)
    t = [torch.from_numpy(a[k]) for k in ("xdt", "loga", "B", "C")]
    with pytest.raises(ValueError, match="ssd_op"):
        ssd_kernel.ssd(t[0].clone().requires_grad_(), *t[1:])
    before = dict(ssd_kernel.LAUNCHES)
    ssd_kernel.ssd_bwd(*t, torch.from_numpy(a["dy"]))
    with torch.no_grad():
        ssd_kernel.ssd(t[0].clone().requires_grad_(), *t[1:])
    assert ssd_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_kernel.ssd_bwd(*(x.to("meta") for x in t), torch.zeros(1, device="meta"))


def _scan_inputs(seed, b, L, d, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"xc": rng.standard_normal((b, L, d)).astype(f),
            "dt_raw": (rng.standard_normal((b, L, d)) * 2 - 1).astype(f),
            "dt_b": (rng.standard_normal(d) * 0.5).astype(f),
            "A": -np.exp(rng.standard_normal((d, n)) * 0.5).astype(f),
            "B": rng.standard_normal((b, L, n)).astype(f),
            "C": rng.standard_normal((b, L, n)).astype(f),
            "D": rng.standard_normal(d).astype(f),
            "z": rng.standard_normal((b, L, d)).astype(f),
            "dy": rng.standard_normal((b, L, d)).astype(f)}


def _scan_args(a):
    return [a[k] for k in ("xc", "dt_raw", "dt_b", "A", "B", "C", "D", "z")]


def _jax_fused(xc, dt_raw, dt_b, A, B, C, D, z):
    """The reference's Mamba1 composition around its scan oracle (its
    ``mamba1_apply`` kernel branch), in float32."""
    dt = jax.nn.softplus(dt_raw + dt_b)
    y = selective_scan_ref(xc, dt, A, B, C, D)
    return y * jax.nn.silu(z)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_fused_scan_plain_bwd_matches_jax_vjp_of_the_composition(case):
    b, L, d, n, chunk = case
    a = _scan_inputs(sum(case), b, L, d, n)
    _, vjp = jax.vjp(_jax_fused, *(jnp.asarray(x) for x in _scan_args(a)))
    want = dict(zip(SCAN_NAMES, (np.asarray(g) for g in vjp(jnp.asarray(a["dy"])))))
    got = scan_ref.mamba1_scan_fused_plain_bwd(
        *(torch.from_numpy(x) for x in _scan_args(a)), torch.from_numpy(a["dy"]),
        chunk=chunk)
    _hold(dict(zip(SCAN_NAMES, got)), want, SCAN_TOL)


def test_fused_scan_plain_bwd_takes_the_softplus_threshold():
    """Above PyTorch's softplus threshold (20) the softplus is the identity
    and its derivative 1: the plain backward's ddt_raw there is the
    gradient of delta itself, as autograd's of the plain forward."""
    a = _scan_inputs(9, 1, 12, 8, 4)
    a["dt_raw"][0, 3] = 25.0
    t = [torch.from_numpy(x).double().requires_grad_() for x in _scan_args(a)]
    y = scan_ref.mamba1_scan_fused_plain(*t)
    dy = torch.from_numpy(a["dy"]).double()
    want = torch.autograd.grad((y * dy).sum(), t)
    got = scan_ref.mamba1_scan_fused_plain_bwd(*(x.detach() for x in t), dy, chunk=5)
    for name, g, w in zip(SCAN_NAMES, got, want):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-10, msg=name)


def test_fused_scan_op_gradient_is_the_plain_backward():
    """The model's op in bf16, as the Mamba1 block calls it (B, C and z
    strided views): its gradient is the plain backward's bitwise, in the
    inputs' dtypes, and nothing is launched on the CPU."""
    b, L, d, n = 2, 24, 16, 8
    a = _scan_inputs(6, b, L, d, n)
    bf = torch.bfloat16
    proj = torch.from_numpy(np.concatenate([a["B"], a["C"]], -1)).to(bf)
    xz = torch.from_numpy(np.concatenate([a["xc"], a["z"]], -1)).to(bf)
    leaves = {"proj": proj.requires_grad_(), "xz": xz.requires_grad_(),
              "dt_raw": torch.from_numpy(a["dt_raw"]).to(bf).requires_grad_(),
              "dt_b": torch.from_numpy(a["dt_b"]).requires_grad_(),
              "A": torch.from_numpy(a["A"]).requires_grad_(),
              "D": torch.from_numpy(a["D"]).requires_grad_()}
    B, C = leaves["proj"].split([n, n], dim=-1)
    xc, z = leaves["xz"].chunk(2, dim=-1)
    args = (xc, leaves["dt_raw"], leaves["dt_b"], leaves["A"], B, C, leaves["D"], z)
    before = dict(scan_kernel.LAUNCHES)
    y = scan_kernel.mamba1_scan_fused(*args)
    assert y.dtype == bf and y.grad_fn is not None
    dy = torch.from_numpy(a["dy"]).to(bf)
    (y.float() * dy.float()).sum().backward()
    assert scan_kernel.LAUNCHES == before
    want = scan_ref.mamba1_scan_fused_plain_bwd(*(x.detach() for x in args), dy)
    dxc, ddt, ddtb, dA, dB, dC, dD, dz = want
    assert torch.equal(leaves["proj"].grad, torch.cat([dB, dC], -1))
    assert torch.equal(leaves["xz"].grad, torch.cat([dxc, dz], -1))
    assert leaves["proj"].grad.dtype == bf
    for name, w in (("dt_raw", ddt), ("dt_b", ddtb), ("A", dA), ("D", dD)):
        assert torch.equal(leaves[name].grad, w), name
    with pytest.raises(ValueError, match="final state"):
        scan_kernel.mamba1_scan_fused(*args, return_state=True)


# ---------------------------------------------------------------------------
# the smoke run's helpers for these kernels (chip_smoke.py phase 33)
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ssd_bwd_flops_by_pairs(b, L, nh, hd, n, chunk):
    """The chunked form's products with each chunk's causal pairs listed:
    G over the pairs once a row; a head's dy xdt^T and M^T dy over them at
    hd, dM B and dM^T C at n; five (q, n, hd) products."""
    chunked = 0
    for c0 in range(0, L, chunk):
        ts = range(c0, min(c0 + chunk, L))
        pairs = sum(1 for t in ts for s in ts if s <= t)
        chunked += b * (2 * pairs * n + nh * (2 * 2 * pairs * hd + 2 * 2 * pairs * n
                                              + 5 * 2 * len(ts) * n * hd))
    return chunked


@pytest.mark.parametrize("b,L,nh,hd,n,chunk", [
    (2, 4096, 80, 64, 64, 64),   # zamba2's microbatch, the timed shape
    (1, 100, 3, 16, 8, 64),      # a ragged last chunk
])
def test_ssd_bwd_bound_counts_the_function(b, L, nh, hd, n, chunk):
    """Bytes of the gradient's inputs (xdt, dy, loga, B, C) and outputs
    (dxdt, dloga, dB, dC) in f32, counted from the tensors such a call
    takes; the operations the lesser of the chunked form as 3xTF32 and the
    recurrence on the f32 cores; the larger time."""
    r = costs.ssd_bwd_bound_ms(b, L, nh, hd, n, chunk)
    a = _ssd_inputs(0, b, min(L, 8), nh, hd, n)   # the shapes, at a short L
    per_token = sum(v[0].size if k != "dS" else 0 for k, v in a.items()) // min(L, 8)
    per_token += sum(a[k][0].size for k in ("xdt", "loga", "B", "C")) // min(L, 8)
    assert r["nbytes"] == 4 * b * L * per_token
    chunked = _ssd_bwd_flops_by_pairs(b, L, nh, hd, n, chunk)
    assert r["chunked_flops"] == chunked
    assert r["recurrence_flops"] == b * L * nh * 14 * n * hd
    t_ops = min(r["recurrence_flops"] / costs.FP32_FLOPS, 3 * chunked / costs.TF32_FLOPS) * 1e3
    assert r["bound_ms"] == pytest.approx(max(r["nbytes"] / costs.HBM_BYTES_PER_S * 1e3, t_ops),
                                          rel=1e-12)
    if (b, L) == (2, 4096):
        assert r["bound_by"] == "operations" and r["nbytes"] == 516_947_968
        assert round(r["bound_ms"], 4) == 0.2290


def test_fused_scan_bwd_bound_counts_the_call():
    """Bytes of what the gradient reads (xc, dt_raw, z, dy, B, C in bf16;
    A, dt_b, D in f32) and writes (their gradients, dy's aside), each once;
    n + 3 special-function operations and 18 n + 20 f32 operations a
    (token, channel); the larger time, set by the operations at
    falcon-mamba's widths."""
    b, L, d, n = 2, 4096, 8192, 16
    r = costs.fused_scan_bwd_bound(b, L, d, n)
    reads = {"xc": (b * L * d, 2), "dt_raw": (b * L * d, 2), "z": (b * L * d, 2),
             "dy": (b * L * d, 2), "B": (b * L * n, 2), "C": (b * L * n, 2),
             "A": (d * n, 4), "dt_b": (d, 4), "D": (d, 4)}
    writes = {k: v for k, v in reads.items() if k != "dy"}
    assert r["nbytes"] == sum(c * s for c, s in (*reads.values(), *writes.values()))
    assert r["sfu"] == b * L * d * (n + 3) and r["flops"] == b * L * d * (18 * n + 20)
    assert r["bound_by"] == "operations"
    assert r["bound_ms"] == max(r["t_bytes"], r["flops"] / costs.FP32_FLOPS * 1e3,
                                r["sfu"] / costs.SFU_PER_S * 1e3)
    assert round(r["bound_ms"], 4) == 0.3085


def test_smoke_gradient_check_takes_one_bf16_ulp_and_catches_a_planted_error():
    """``ssm_grad_errors``: a bf16 gradient one ulp from the plain one
    passes, two ulps fail; an f32 gradient 1e-3 of (|want| + RMS) off sits
    at the bound; and ``ssm_bwd_check`` rejects a 1% error planted in the
    later half of a gradient, and two calls that differ."""
    cs = _chip_smoke()
    want = torch.tensor([1.0, 1.5, 3.0, -7.0], dtype=torch.bfloat16)
    bits = want.view(torch.int16)
    one, two = ((bits + k).view(torch.bfloat16) for k in (1, 2))   # ulps away
    assert (one != want).all()
    assert cs.ssm_grad_errors({"g": one}, {"g": want})["g"]["ratio"] <= 1.0
    assert cs.ssm_grad_errors({"g": two}, {"g": want})["g"]["ratio"] > 1.0
    w32 = torch.tensor([1.0, -2.0, 0.0, 4.0])
    rms = float(w32.pow(2).mean().sqrt())
    at = w32 + 0.999 * cs.SSM_BWD_RTOL * (w32.abs() + rms)
    assert cs.ssm_grad_errors({"g": at}, {"g": w32})["g"]["ratio"] <= 1.0
    a = _ssd_inputs(7, 1, 40, 2, 16, 8)
    t = [torch.from_numpy(a[k]) for k in ("xdt", "loga", "B", "C", "dy")]
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda: None
    try:
        assert cs.ssm_bwd_check("plain", lambda: ssd_ref.ssd_plain_bwd(*t),
                                lambda: ssd_ref.ssd_plain_bwd(*t, chunk=16), cs.SSD_GRADS,
                                "cpu", plant="dxdt")[0] <= 1.0
        calls = []

        def drifting():
            calls.append(1)
            out = list(ssd_ref.ssd_plain_bwd(*t))
            out[2] = out[2] + len(calls) * 1e-7
            return out

        with pytest.raises(AssertionError, match="two calls differ"):
            cs.ssm_bwd_check("drift", drifting, lambda: ssd_ref.ssd_plain_bwd(*t),
                             cs.SSD_GRADS, "cpu")
    finally:
        torch.cuda.synchronize = sync
