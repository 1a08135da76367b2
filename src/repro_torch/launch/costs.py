"""The work of each hand-written kernel of the model path, counted from its
shapes: the bytes it must move (each input read once, each output written
once) and the operations it must do, and from them the least time it can
take on an H100 SXM (the larger of the bytes at the memory rate and the
operations at their unit's peak rate).

``chip_smoke.py`` bounds every kernel it times by these functions, and
the kernels' ``meta`` forms add the same bytes and operations to the
dry-run's count (``launch/dryrun.py``), so the two count the same work.
A kernel call's (bytes, FLOP) are ``attention_bound``'s and
``flash_bwd_bound``'s pair (the products' multiply-adds as two
operations), ``ssd_work``'s and ``ssd_bwd_work``'s (the lesser of the
SSD's two forms), and a scan bound's ``nbytes`` and ``flops`` (its f32
operations on the FMA lanes; its special-function operations, exp and
log, are not FLOP, as XLA counts transcendentals apart from its flops).
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12   # device memory rate
FP64_FLOPS = 34e12          # FP64 outside the tensor cores (the kernels' DADD/DMUL)
BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
FP32_FLOPS = 67e12          # f32 outside the tensor cores
# exp on the special-function units: 16 results a clock on each SM (CUDA
# C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), against 256 f32 FLOP a clock in the FMA lanes behind
# FP32_FLOPS: a sixteenth of that rate
SFU_PER_S = FP32_FLOPS / 16


# ---------------------------------------------------------------------------
# flash attention (forward and decode) and its backward
# ---------------------------------------------------------------------------


def attention_bound(b, sq, live, h, kv, d, esize, causal, lse=False) -> tuple[int, int]:
    """(bytes, FLOP) of one attention call: q and the output of (b, sq, h,
    d), k and v of (b, live, kv, d) read once (decode: the live entries
    and ``cache_len``); QK^T and PV over the pairs it attends (causal:
    aligned bottom-right, query i sees keys <= i + live - sq).  With
    ``lse`` the rows' f32 log-sum-exp (b, h, sq) is written too (the
    trainer's forward)."""
    pairs = sq * (live - sq) + sq * (sq + 1) // 2 if causal else sq * live
    nbytes = 2 * b * sq * h * d * esize + 2 * b * live * kv * d * esize
    if sq == 1:
        nbytes += 4 * b
    if lse:
        nbytes += 4 * b * h * sq
    return nbytes, 4 * b * h * d * pairs


def flash_bwd_bound(b, sq, sk, h, kv, d, esize, causal) -> tuple[int, int]:
    """(bytes, FLOP) of one backward call: q, o, dO, dQ (b, sq, h, d), k, v,
    dK, dV (b, sk, kv, d) moved once and the f32 lse read; the products
    are 2.5 times the forward's (S and dP recomputed, dV, dK and dQ)."""
    _, fwd_flops = attention_bound(b, sq, sk, h, kv, d, esize, causal)
    nbytes = (4 * b * sq * h * d + 4 * b * sk * kv * d) * esize + 4 * b * h * sq
    return nbytes, int(2.5 * fwd_flops)


# ---------------------------------------------------------------------------
# the Mamba2 SSD and its gradient
# ---------------------------------------------------------------------------


def ssd_forms(b, L, nh, hd, n, chunk) -> tuple[int, int]:
    """f32 operations of the SSD function's two forms, (chunked, recurrence).
    The chunked form at ``chunk``: per (row, chunk of q tokens) the lower
    triangle of G = C B^T, shared by the heads (q(q+1) n); per head the
    triangular M @ xdt (q(q+1) hd), C @ S and the state update (2 q n hd
    each).  The recurrence: per (row, token, head) the decayed state plus
    B xdt^T (3 n hd) and its read-out by C (2 n hd)."""
    chunked = 0
    for c0 in range(0, L, chunk):
        q = min(chunk, L - c0)
        chunked += b * (q * (q + 1) * n + nh * (q * (q + 1) * hd + 4 * q * n * hd))
    return chunked, b * L * nh * 5 * n * hd


def ssd_flops(b, L, nh, hd, n, chunk) -> int:
    """f32 operations the SSD function needs: the lesser of its two forms."""
    return min(ssd_forms(b, L, nh, hd, n, chunk))


def ssd_work(b, L, nh, hd, n, chunk) -> tuple[int, int]:
    """(bytes, FLOP) of one SSD call: xdt, loga, B, C read once, y and the
    final state written once, f32; ``ssd_flops``."""
    nbytes = 4 * (2 * b * L * nh * hd + b * L * nh + 2 * b * L * n + b * nh * n * hd)
    return nbytes, ssd_flops(b, L, nh, hd, n, chunk)


def ssd_bound_ms(b, L, nh, hd, n, chunk) -> dict:
    """The least time the SSD's function takes on the card: the larger of
    its bytes (``ssd_work``) at the memory rate and its operations, which
    take the lesser of two times: the recurrence on the f32 CUDA cores, or
    the chunked form as 3xTF32 products (three TF32 products a product) on
    the tensor cores."""
    chunked, recurrence = ssd_forms(b, L, nh, hd, n, chunk)
    nbytes, _ = ssd_work(b, L, nh, hd, n, chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_rec = recurrence / FP32_FLOPS * 1e3
    t_chunked = 3 * chunked / TF32_FLOPS * 1e3
    t_ops = min(t_rec, t_chunked)
    form = ("the recurrence on the f32 CUDA cores at 67 TFLOP/s" if t_rec <= t_chunked
            else "the chunked form as 3xTF32 on the tensor cores at 495 TFLOP/s")
    return dict(nbytes=nbytes, chunked_flops=chunked, recurrence_flops=recurrence,
                t_bytes=t_bytes, t_ops=t_ops, ops_form=form,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def ssd_bwd_forms(b, L, nh, hd, n, chunk) -> tuple[int, int]:
    """f32 operations of the SSD gradient's two forms, (chunked,
    recurrence).  The chunked form at ``chunk``: per (row, chunk of q
    tokens) the triangle of G = C B^T, shared by the heads (q(q+1) n); per
    head the triangles of dy xdt^T and M^T dy (q(q+1) hd each) and of dM B
    and dM^T C (q(q+1) n each), and five (q, n, hd) products: B dS,
    dy S^T, xdt dS^T, the chunk's state and its gradient (2 q n hd each).
    The recurrence: per (row, token, head) the recomputed state (3 n hd),
    its gradient (3 n hd), dxdt, dB, dC and dloga (2 n hd each)."""
    chunked = 0
    for c0 in range(0, L, chunk):
        q = min(chunk, L - c0)
        chunked += b * (q * (q + 1) * n
                        + nh * (2 * q * (q + 1) * (hd + n) + 10 * q * n * hd))
    return chunked, b * L * nh * 14 * n * hd


def ssd_bwd_work(b, L, nh, hd, n, chunk=64, dS=False) -> tuple[int, int]:
    """(bytes, FLOP) of one SSD gradient call: xdt, dy, loga, B, C and dS
    where given read once, dxdt, dloga, dB, dC written once, f32; the
    lesser of its two forms' operations."""
    nbytes = 4 * (3 * b * L * nh * hd + 2 * b * L * nh + 4 * b * L * n
                  + (b * nh * n * hd if dS else 0))
    return nbytes, min(ssd_bwd_forms(b, L, nh, hd, n, chunk))


def ssd_bwd_bound_ms(b, L, nh, hd, n, chunk=64, dS=False) -> dict:
    """The least time the SSD's gradient takes on the card: the larger of
    its bytes (``ssd_bwd_work``) at the memory rate and its operations,
    the lesser of the recurrence on the f32 CUDA cores and the chunked
    form (at the kernel's chunk) as 3xTF32 on the tensor cores."""
    chunked, recurrence = ssd_bwd_forms(b, L, nh, hd, n, chunk)
    nbytes, _ = ssd_bwd_work(b, L, nh, hd, n, chunk, dS)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_rec = recurrence / FP32_FLOPS * 1e3
    t_chunked = 3 * chunked / TF32_FLOPS * 1e3
    t_ops = min(t_rec, t_chunked)
    form = ("the recurrence on the f32 CUDA cores at 67 TFLOP/s" if t_rec <= t_chunked
            else "the chunked form as 3xTF32 on the tensor cores at 495 TFLOP/s")
    return dict(nbytes=nbytes, chunked_flops=chunked, recurrence_flops=recurrence,
                t_bytes=t_bytes, t_ops=t_ops, ops_form=form,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the Mamba1 selective scan: the f32 form, the fused form and its gradient
# ---------------------------------------------------------------------------


def scan_bound(b, L, d, n, state=False) -> dict:
    """The least time the selective scan's function takes on the card at
    (b, L, d, n): x, dt, A, B, C, D read once and y written once, in f32
    (and the final state, f32, when asked for); one exp per (token,
    channel, state) on the special-function units, and 6 f32 operations
    (dt*A, the state's FMA, dt*x*B, the read-out FMA) beside it, plus 3
    per (token, channel) (dt*x, D*x + sum).  The FMA lanes and the
    special-function units run side by side, so the operations take the
    longer of their two times."""
    nbytes = 4 * (3 * b * L * d + 2 * b * L * n + d * n + d)
    if state:
        nbytes += 4 * b * d * n
    exps = b * L * d * n
    flops = b * L * d * (6 * n + 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, exps / SFU_PER_S) * 1e3
    return dict(nbytes=nbytes, exps=exps, flops=flops, t_bytes=t_bytes, t_ops=t_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def fused_scan_bound(b, L, d, n, state=False) -> dict:
    """The least time the fused Mamba1 scan's function takes on the card at
    (b, L, d, n): xc, dt_raw and z read once and y written once, in bf16;
    B and C (bf16), A, dt_b and D (f32) read once; the final state (f32)
    written once when asked for.  On the special-function units, what the
    function needs: one exp per (token, channel, state) and, per (token,
    channel), the softplus's exp and log and one operation for the gate
    (silu(z) = z/2 (1 + tanh(z/2)) takes a single tanh; the kernel takes
    two); beside them 6 f32 operations per (token, channel, state) and 8
    per (token, channel) (the dt_b add, the softplus's series or scale,
    dt*x, D*x, the sum, the gate's add and two products).  The FMA lanes
    and the special-function units run side by side."""
    nbytes = 2 * (4 * b * L * d + 2 * b * L * n) + 4 * (d * n + 2 * d)
    if state:
        nbytes += 4 * b * d * n
    sfu = b * L * d * (n + 3)
    flops = b * L * d * (6 * n + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, sfu / SFU_PER_S) * 1e3
    return dict(nbytes=nbytes, sfu=sfu, flops=flops, t_bytes=t_bytes, t_ops=t_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def fused_scan_bwd_bound(b, L, d, n) -> dict:
    """The least time the fused Mamba1 scan's gradient takes on the card:
    xc, dt_raw, z and dy read and dxc, ddt_raw and dz written once (bf16),
    B and C read and dB and dC written once (bf16), A, dt_b, D read and
    dA, dD, ddt_b written once (f32).  On the special-function units what
    the function needs, as the forward's bound counts it: the state's exp
    once a (token, channel, state), and the softplus's exp and log and one
    operation for the gate a (token, channel) (the softplus's derivative
    is e / (1 + e) of the same exp); on the FMA lanes 18 f32 operations a
    (token, channel, state) (the recomputed state 3, its read-out 2, the
    state's gradient 2, dh.B 2, dA's and ddelta's terms 6, dB's part 2, the
    decay 1) and 20 a (token, channel).  The two run side by side."""
    nbytes = 2 * (7 * b * L * d + 4 * b * L * n) + 4 * 2 * (d * n + 2 * d)
    sfu = b * L * d * (n + 3)
    flops = b * L * d * (18 * n + 20)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, sfu / SFU_PER_S) * 1e3
    return dict(nbytes=nbytes, sfu=sfu, flops=flops, t_bytes=t_bytes, t_ops=t_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
