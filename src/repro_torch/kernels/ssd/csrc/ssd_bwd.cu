// The gradient of the Mamba2 chunked SSD for Hopper (sm_90a): products on
// the tensor cores as 3xTF32, float32 in and out, no atomics.
//
// Replaces: none.  The reference has no backward kernel: its trainer
//   differentiates the XLA route (src/repro/models/ssm.py:210-264,
//   ssd_chunked), and its Pallas forward is kernels/ssd/kernel.py:26
//   (_ssd_kernel, pallas_call at :91), which csrc/ssd.cu ports.  This is
//   the gradient of that function on the pre-weighted inputs:
//     h_t = exp(loga_t) h_{t-1} + B_t (x) xdt_t,   y_t = C_t . h_t,
//   from dy (b, L, nh, hd) and the final state's gradient dS (b, nh, n, hd),
//   which may be absent (zero: the trainer drops the final state) ->
//   dxdt (b, L, nh, hd), dloga (b, L, nh), dB, dC (b, L, n), all float32.
// Yardstick: no single PyTorch call computes it (library_ms is null).
// Bound on an H100 (chip_smoke.py::ssd_bwd_bound_ms): at zamba2's
//   microbatch (b=2, L=4,096, 80 heads of 64, state 64) the function reads
//   xdt, dy, loga, B, C and writes dxdt, dloga, dB, dC: 517 MB, 0.154 ms at
//   3.35 TB/s; its chunked form's products at chunk 64 (the triangle
//   skipped, G shared by the heads: 3.78e10 FLOP) take 0.229 ms as 3xTF32
//   at 495 TFLOP/s: the operations bound it.
// In chunks of Q tokens (Q = 64, or 32 / 16 where the widths need it; the
//   function has no chunks), cum the chunk's inclusive cumsum of loga, total
//   its last entry, w = exp(total - cum), four launches:
//   1. ssd_bwd_local_kernel, one CTA per (chunk, group of HG heads, batch
//      row), every chunk at once: each head's local contributions to the
//      state and to its gradient,
//        B_c^T (xdt_c * w)   and   C_c^T (dy_c * exp(cum)),
//      and the chunk's total.
//   2. ssd_bwd_carry_kernel, one thread per (batch row, head, state entry)
//      and direction: S_{c+1} = exp(total_c) S_c + local_c forward and
//      dS_{c-1} = exp(total_c) dS_c + dlocal_c in reverse, in place, so the
//      buffers end holding the state entering each chunk and the gradient
//      of the state leaving it.
//   3. ssd_bwd_chunk_kernel, one CTA per (chunk, head group, batch row):
//      with G = C B^T (formed once for the group), E = exp(cum_t - cum_s)
//      [t >= s], M = G E, dM = (dy xdt^T) E and P = M (dy xdt^T), per head
//        dxdt = M^T dy + w (B dS),
//        dC  += dM B + exp(cum) (dy S^T),  dB += dM^T C + w (xdt dS^T),
//        dcum = rowsum P - colsum P + (exp(cum) C . dy S^T) - (w B . xdt dS^T),
//        dcum_{Q-1} += exp(total) <S, dS> + sum (w B . xdt dS^T),
//      and dloga is dcum's reverse cumsum inside the chunk.  dB and dC are
//      summed over the group's heads in registers, in head order.
//   4. ssd_bwd_group_sum_kernel, where there is more than one group: dB
//      and dC summed over the groups in group order.
//   So a call gives the same bits every time.
// Design, against what held this kernel's first version (6.1 ms at
//   zamba2's microbatch) back:
//   1. Products on the tensor cores: every product is mma.sync m16n8k8 tf32
//      as 3xTF32 (ssd_tc.cuh, shared with the forward): one TF32 product
//      misses the SSD's 5e-4 / 5e-3 by 20x.  A warp computes 16 x 32 blocks
//      (4 n8 tiles), its A fragment split once for the 4 and the tiles'
//      products interleaved; Q x Q products run on the tiles on or above
//      the diagonal only, and the products with M or dM over the k steps
//      where they are not zero.  At zamba2's widths (Q = n = hd = 64) the
//      widths are compile-time constants and a k step has no branch.
//   2. G once a group: a CTA takes HG = 8 heads of a chunk and keeps G^T's
//      tiles in registers across them.  dB and dC stay in registers across
//      the heads (each warp owns fixed 16 x 32 blocks), so the per-head
//      partials (335.5 MB written and read again before) are gone; the
//      groups' partials are 21 MB each at zamba2's widths.
//   3. No serial states pass: the states come from per-chunk products (1)
//      and an elementwise carry over the chunks (2): 655,360 entries at
//      zamba2's widths, four a thread as 16-byte vectors, each thread with
//      8 chunks' loads in flight.
//   4. Two CTAs an SM: the chunk pass stages B, C, xdt, dy and one region
//      that holds the state and its gradient, then M^T and dM^T (111,648 B
//      at Q = 64, n = hd = 64; the first version took 184,320 B), and keeps
//      at most 128 registers a thread.  Rows are padded for the fragment
//      reads (B and C to 8 words mod 32: read across rows by the products
//      with dM; the others to 4).
//   The exponent is taken only where t >= s: a masked entry would give
//   inf * 0 = NaN.  Any L: the last chunk's tail is zero-filled (its decay
//   zero, so its cum stays the chunk's total).  hd and n from 1 to 128.
// Left for later: wgmma (tf32 wants both operands K-major, and several of
//   these products read an operand across its rows), a cp.async ring for
//   the next head's inputs, the local pass fused into the forward.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_tc.cuh"

namespace {

using namespace ssd_tc;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int HG = 8;               // heads a CTA; the last group may hold fewer
constexpr int MAXT = 3;             // Q x Q tiles a warp (20 at Q = 64)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
// the least row pitch >= w that is r words past a multiple of 32 (the
// banks the fragment reads of a row-major or a transposed operand spread on)
__host__ __device__ inline int pitch(int w, int r) { return w + ((r - w) % 32 + 32) % 32; }

// the local pass: B, C (Q, PB); xdt, dy (Q, PX); cum, cum * log2(e),
// exp(cum), w (Q)
struct LocalLayout {
  int NP, HP, PB, PX, oC, oX, oDy, oCum, oCum2, oEc, oW, total;
};

__host__ __device__ inline LocalLayout local_layout(int Q, int n, int hd) {
  LocalLayout l;
  l.NP = round_up(n, 16);
  l.HP = round_up(hd, 8);
  l.PB = pitch(l.NP, 8);
  l.PX = pitch(l.HP, 8);
  l.oC = Q * l.PB;
  l.oX = l.oC + Q * l.PB;
  l.oDy = l.oX + Q * l.PX;
  l.oCum = l.oDy + Q * l.PX;
  l.oCum2 = l.oCum + Q;
  l.oEc = l.oCum2 + Q;
  l.oW = l.oEc + Q;
  l.total = l.oW + Q;
  return l;
}

// the chunk pass: B, C (Q, PB); xdt, dy (Q, PX); one region of S, dS
// (NP, PS) each, then M^T, dM^T (Q, PQ) each; cum, cum * log2(e), exp(cum),
// w (Q); P's partial sums over each tile's columns (Q/8, Q) and rows
// (Q/16, Q); the two dcum terms' partial sums over each 32 states (NP/32,
// Q) each; <S, dS> a warp
struct ChunkLayout {
  int NP, HP, PB, PX, PQ, PS, oC, oX, oDy, oR, oMd, oSd, oCum, oCum2, oEc, oW, oRow, oCol,
      oT1, oT2, oRed, total;
};

__host__ __device__ inline ChunkLayout chunk_layout(int Q, int n, int hd) {
  ChunkLayout l;
  l.NP = round_up(n, 16);
  l.HP = round_up(hd, 8);
  l.PB = pitch(l.NP, 8);
  l.PX = pitch(l.HP, 4);
  l.PQ = pitch(Q, 4);
  l.PS = pitch(l.HP, 4);
  l.oC = Q * l.PB;
  l.oX = l.oC + Q * l.PB;
  l.oDy = l.oX + Q * l.PX;
  l.oR = l.oDy + Q * l.PX;
  l.oSd = l.oR + l.NP * l.PS;
  l.oMd = l.oR + Q * l.PQ;
  const int region = 2 * l.NP * l.PS > 2 * Q * l.PQ ? 2 * l.NP * l.PS : 2 * Q * l.PQ;
  const int cbn = (l.NP + 31) / 32;
  l.oCum = l.oR + region;
  l.oCum2 = l.oCum + Q;
  l.oEc = l.oCum2 + Q;
  l.oW = l.oEc + Q;
  l.oRow = l.oW + Q;
  l.oCol = l.oRow + (Q / 8) * Q;
  l.oT1 = l.oCol + (Q / 16) * Q;
  l.oT2 = l.oT1 + cbn * Q;
  l.oRed = l.oT2 + cbn * Q;
  l.total = l.oRed + WARPS;
  return l;
}

size_t smem_bytes(int Q, int n, int hd) {
  const int a = local_layout(Q, n, hd).total, b = chunk_layout(Q, n, hd).total;
  return sizeof(float) * (size_t)(a > b ? a : b);
}

// 16 x 32 output blocks a warp keeps in the chunk pass (dB, dC and dxdt
// each): the blocks of a (Q, max(NP, HP)) output over the 8 warps
int blocks_a_warp(int Q, int n, int hd) {
  const ChunkLayout l = chunk_layout(Q, n, hd);
  const int w = l.NP > l.HP ? l.NP : l.HP;
  return ((Q / 16) * ((w + 31) / 32) + WARPS - 1) / WARPS;
}

// rows [0, rows) of a (rows, w) slice at src with row stride `stride`
// into dst (rows, pitch) by cp.async: rows past q and columns w..wpad
// zero.  16-byte copies where every row starts on 16 bytes.
__device__ void stage(float* dst, int pitch, int wpad, const float* src, long stride, int q,
                      int rows, int w) {
  const bool vec = w % 4 == 0 && stride % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int per = w / 4;
    for (int i = threadIdx.x; i < rows * per; i += THREADS) {
      const int t = i / per, k = (i % per) * 4;
      const bool in = t < q;
      cp_async16(smem_u32(dst + t * pitch + k), in ? src + t * stride + k : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += THREADS) {
      const int t = i / w, k = i % w;
      const bool in = t < q;
      cp_async4(smem_u32(dst + t * pitch + k), in ? src + t * stride + k : src, in);
    }
  }
  const int pad = wpad - w;
  if (pad > 0)
    for (int i = threadIdx.x; i < rows * pad; i += THREADS)
      dst[(i / pad) * pitch + w + i % pad] = 0.f;
}

// warp 0: cum, the inclusive cumsum of the chunk's log-decays (zero past q,
// so its last entry is the chunk's total), then cum * log2(e), exp(cum) and
// w = exp(total - cum)
__device__ void chunk_decays(const float* lb, long stride, int c0, int q, int Q, float* cum,
                             float* cum2, float* ec, float* w) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;   // consecutive entries a lane, at most 4
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * per + e;
    v[e] = (e < per && t < q) ? lb[(long)(c0 + t) * stride] : 0.f;
    run += v[e];
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += up;
  }
  const float excl = incl - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * per + e;
    if (e < per && t < Q) cum[t] = excl + v[e];
  }
  __syncwarp();
  const float total = cum[Q - 1];
  for (int t = lane; t < Q; t += 32) {
    const float c = cum[t];
    cum2[t] = c * LOG2E;
    ec[t] = expf(c);
    w[t] = expf(total - c);
  }
}

// acc[j] (16 rows x 8 columns, n8 tile j < nt) += sum over k in [k0, k1)
// (a multiple of 8 apart) of (a(i, k) * scale of row i) b(k, 8 j + col):
// a(i, k) for the block's rows i < 16, b(k, j) for its columns j < 8 NT;
// rows g take scale sa, rows g + 8 sb.  Each A fragment is split once for
// the nt products, and each accumulator takes mma3's three products in
// mma3's order, the tiles interleaved so that no product waits on the one
// before it.  FULL: all NT tiles (nt is not read), no branch in the step.
template <int NT, bool FULL, class FA, class FB>
__device__ __forceinline__ void mma_block(float (&acc)[NT][4], int nt, int k0, int k1, FA a,
                                          FB b, float sa = 1.f, float sb = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    const FragA fa(a(g, k + c) * sa, a(g + 8, k + c) * sb, a(g, k + c + 4) * sa,
                   a(g + 8, k + c + 4) * sb);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (FULL || j < nt) {
        split(b(k + c, 8 * j + g), bh[j][0], bl[j][0]);
        split(b(k + c + 4, 8 * j + g), bh[j][1], bl[j][1]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (FULL || j < nt) mma_tf32(acc[j], fa.lo, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (FULL || j < nt) mma_tf32(acc[j], fa.hi, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (FULL || j < nt) mma_tf32(acc[j], fa.hi, bh[j][0], bh[j][1]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// a block's D fragments, rows r0 + g (+ 8) below `rows` and columns
// col0 + 8 j + 2c (+ 1) below `cols`, into dst (row stride ld); float2
// stores where the pairs fall on 8 bytes
template <int NT>
__device__ __forceinline__ void store_block(float* dst, long ld, const float (&acc)[NT][4],
                                            int r0, int rows, int col0, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bool pair = cols % 2 == 0 && ld % 2 == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = col0 + 8 * j + 2 * c;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
      if (r >= rows || col >= cols) continue;
      float* p = dst + r * ld + col;
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
      } else {
        p[0] = acc[j][2 * hf];
        if (col + 1 < cols) p[1] = acc[j][2 * hf + 1];
      }
    }
  }
}

// n8 tiles of column block cb (32 columns) inside a width of w (w % 8 == 0)
__device__ __forceinline__ int tiles_in(int w, int cb) { return min(4, w / 8 - 4 * cb); }

// tile idx of the Q x Q tiles on or above the diagonal, row tiles of 16
// (r) by column tiles of 8 (ct >= 2r), in row order
__device__ __forceinline__ void tri_tile(int idx, int CT, int& r, int& ct) {
  r = 0;
  while (idx >= CT - 2 * r) {
    idx -= CT - 2 * r;
    ++r;
  }
  ct = 2 * r + idx;
}

// W: where not 0, the chunk and the padded widths are all W (zamba2's 64),
// fixed at compile time
template <int W>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_local_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ dy, float* __restrict__ Sbuf,
                     float* __restrict__ dSbuf, float* __restrict__ totals, int L, int nh,
                     int hd, int n, int Q_arg) {
  constexpr bool FULL = W != 0;
  const int Q = W ? W : Q_arg;
  const LocalLayout lay = local_layout(Q, W ? W : n, W ? W : hd);
  const int NP = lay.NP, HP = lay.HP, PB = lay.PB, PX = lay.PX;
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                 // (Q, PB)
  float* sC = smem + lay.oC;        // (Q, PB)
  float* sX = smem + lay.oX;        // (Q, PX)  xdt
  float* sDy = smem + lay.oDy;      // (Q, PX)
  float* sCum = smem + lay.oCum;    // (Q)
  float* sCum2 = smem + lay.oCum2;  // (Q)  cum * log2(e), unused here
  float* sEc = smem + lay.oEc;      // (Q)  exp(cum)
  float* sW = smem + lay.oW;        // (Q)  exp(total - cum)
  const int c = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, nc = gridDim.x, nn = n * hd;
  const int c0 = c * Q, q = min(Q, L - c0), kq = round_up(q, 8);
  const int h0 = grp * HG, h1 = min(nh, h0 + HG);
  const long xrow = (long)nh * hd;
  const int KT = NP / 16, CB = (HP + 31) / 32;

  stage(sB, PB, NP, Bm + ((long)bi * L + c0) * n, n, q, Q, n);
  stage(sC, PB, NP, Cm + ((long)bi * L + c0) * n, n, q, Q, n);
  for (int h = h0; h < h1; ++h) {
    __syncthreads();   // the last head's readers are done
    const long xo = ((long)bi * L + c0) * xrow + (long)h * hd;
    stage(sX, PX, HP, xdt + xo, xrow, q, Q, hd);
    stage(sDy, PX, HP, dy + xo, xrow, q, Q, hd);
    if (warp == 0) {
      chunk_decays(loga + (long)bi * L * nh + h, nh, c0, q, Q, sCum, sCum2, sEc, sW);
      if (tid == 0) totals[((long)bi * nc + c) * nh + h] = sCum[Q - 1];
    }
    cp_async_commit_wait_all();
    __syncthreads();
    const long slot = (((long)bi * nc + c) * nh + h) * nn;
    // local = B^T (xdt w), dlocal = C^T (dy exp(cum)): rows are states, the
    // k steps tokens, columns the head's channels
    for (int u = warp; u < KT * CB; u += WARPS) {
      const int kt = u % KT, cb = u / KT, nt = tiles_in(HP, cb);
      float acc[4][4];
      zero(acc);
      mma_block<4, FULL>(acc, nt, 0, kq,
                         [&](int i, int k) { return sB[k * PB + 16 * kt + i]; },
                         [&](int k, int j) { return sX[k * PX + 32 * cb + j] * sW[k]; });
      store_block<4>(Sbuf + slot, hd, acc, 16 * kt, n, 32 * cb, hd);
      zero(acc);
      mma_block<4, FULL>(acc, nt, 0, kq,
                         [&](int i, int k) { return sC[k * PB + 16 * kt + i]; },
                         [&](int k, int j) { return sDy[k * PX + 32 * cb + j] * sEc[k]; });
      store_block<4>(dSbuf + slot, hd, acc, 16 * kt, n, 32 * cb, hd);
    }
  }
}

// S_{c+1} = exp(total_c) S_c + local_c over the chunks (blockIdx.y = 0) and
// dS_{c-1} = exp(total_c) dS_c + dlocal_c in reverse (1), each lane one
// entry (V = 4: four neighbouring entries, moved as 16-byte vectors) of one
// head of one batch row; the buffers' local terms are replaced by the state
// entering each chunk and the gradient of the state leaving it
template <int V>
__device__ __forceinline__ void carry_lane(float* buf, const float* tot, const float* s0,
                                           long long per, int nc, int nh, bool rev) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = s0 ? s0[e] : 0.f;
  constexpr int U = 8;   // chunks whose loads are in flight together
  for (int k0 = 0; k0 < nc; k0 += U) {
    Vec v[U];
    float ex[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u, cc = rev ? nc - 1 - k : k;
      if (k < nc) {
        v[u] = *reinterpret_cast<const Vec*>(buf + cc * per);
        ex[u] = expf(tot[(long long)cc * nh]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u, cc = rev ? nc - 1 - k : k;
      if (k >= nc) break;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(buf + cc * per) = make_float4(s[0], s[1], s[2], s[3]);
        s[0] = fmaf(ex[u], s[0], v[u].x);
        s[1] = fmaf(ex[u], s[1], v[u].y);
        s[2] = fmaf(ex[u], s[2], v[u].z);
        s[3] = fmaf(ex[u], s[3], v[u].w);
      } else {
        buf[cc * per] = s[0];
        s[0] = fmaf(ex[u], s[0], v[u]);
      }
    }
  }
}

__global__ void __launch_bounds__(256)
ssd_bwd_carry_kernel(float* __restrict__ Sbuf, float* __restrict__ dSbuf,
                     const float* __restrict__ totals, const float* __restrict__ dS_final,
                     long long lanes, int nc, int nh, int nn, bool vec) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * (vec ? 4 : 1);
  if (i >= lanes) return;
  const long long per = (long long)nh * nn;   // floats between two chunks
  const long long bi = i / per, r = i % per;
  const int h = (int)(r / nn);
  const bool rev = blockIdx.y == 1;
  float* buf = (rev ? dSbuf : Sbuf) + bi * nc * per + r;
  const float* tot = totals + bi * nc * nh + h;
  const float* s0 = rev && dS_final ? dS_final + i : nullptr;
  if (vec)
    carry_lane<4>(buf, tot, s0, per, nc, nh, rev);
  else
    carry_lane<1>(buf, tot, s0, per, nc, nh, rev);
}

// NB: 16 x 32 blocks of dB, dC and dxdt a warp keeps (blocks_a_warp); W
// as the local pass's
template <int NB, int W>
__global__ void __launch_bounds__(THREADS, NB == 1 ? 2 : 1)
ssd_bwd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ dy, const float* __restrict__ Sbuf,
                     const float* __restrict__ dSbuf, float* __restrict__ dxdt,
                     float* __restrict__ dloga, float* __restrict__ dBo,
                     float* __restrict__ dCo, int L, int nh, int hd, int n, int Q_arg) {
  constexpr bool FULL = W != 0;
  const int Q = W ? W : Q_arg;
  const ChunkLayout lay = chunk_layout(Q, W ? W : n, W ? W : hd);
  const int NP = lay.NP, HP = lay.HP, PB = lay.PB, PX = lay.PX, PQ = lay.PQ, PS = lay.PS;
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                 // (Q, PB)
  float* sC = smem + lay.oC;        // (Q, PB)
  float* sX = smem + lay.oX;        // (Q, PX)  xdt
  float* sDy = smem + lay.oDy;      // (Q, PX)
  float* sS = smem + lay.oR;        // (NP, PS) the state entering the chunk
  float* sdS = smem + lay.oSd;      // (NP, PS) the gradient of the state leaving it
  float* sMT = smem + lay.oR;       // (Q, PQ)  M^T[s][t], in S's place later
  float* sdMT = smem + lay.oMd;     // (Q, PQ)  dM^T[s][t]
  float* sCum = smem + lay.oCum;    // (Q)
  float* sCum2 = smem + lay.oCum2;  // (Q)  cum * log2(e)
  float* sEc = smem + lay.oEc;      // (Q)  exp(cum)
  float* sW = smem + lay.oW;        // (Q)  exp(total - cum)
  float* sRow = smem + lay.oRow;    // (Q/8, Q)  P^T's row sums over column tile ct
  float* sCol = smem + lay.oCol;    // (Q/16, Q) P^T's column sums over row tile r
  float* sT1 = smem + lay.oT1;      // (NP/32, Q) exp(cum_t) C_t . (dy_t S^T), in parts
  float* sT2 = smem + lay.oT2;      // (NP/32, Q) w_s B_s . (xdt_s dS^T), in parts
  float* sRed = smem + lay.oRed;    // (WARPS)   <S, dS> in parts

  const int c = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, cq = lane & 3;
  const int nc = gridDim.x, ng = gridDim.y, nn = n * hd;
  const int c0 = c * Q, q = min(Q, L - c0), kq = round_up(q, 8);
  const int h0 = grp * HG, h1 = min(nh, h0 + HG);
  const long xrow = (long)nh * hd;
  const int RT = Q / 16, CT = Q / 8, NTT = RT * CT - RT * (RT - 1);
  const int CBN = (NP + 31) / 32, CBH = (HP + 31) / 32;
  const int nbn = RT * CBN, nbh = RT * CBH;

  stage(sB, PB, NP, Bm + ((long)bi * L + c0) * n, n, q, Q, n);
  stage(sC, PB, NP, Cm + ((long)bi * L + c0) * n, n, q, Q, n);
  // tiles below the diagonal leave their partial sums at zero
  for (int i = tid; i < (CT + RT) * Q; i += THREADS) sRow[i] = 0.f;
  cp_async_commit_wait_all();
  __syncthreads();

  // G^T[s][t] = B_s . C_t on this warp's tiles, for every head
  float gT[MAXT][4];
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    float acc[1][4];
    zero(acc);
    const int idx = warp + WARPS * i;
    if (idx < NTT) {
      int r, ct;
      tri_tile(idx, CT, r, ct);
      mma_block<1, true>(acc, 1, 0, NP,
                         [&](int ii, int k) { return sB[(16 * r + ii) * PB + k]; },
                         [&](int k, int j) { return sC[(8 * ct + j) * PB + k]; });
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) gT[i][e] = acc[0][e];
  }

  float dB[NB][4][4], dC[NB][4][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    zero(dB[i]);
    zero(dC[i]);
  }

  for (int h = h0; h < h1; ++h) {
    __syncthreads();   // (a) the last head's readers are done
    const long xo = ((long)bi * L + c0) * xrow + (long)h * hd;
    const long slot = (((long)bi * nc + c) * nh + h) * nn;
    stage(sX, PX, HP, xdt + xo, xrow, q, Q, hd);
    stage(sDy, PX, HP, dy + xo, xrow, q, Q, hd);
    stage(sS, PS, HP, Sbuf + slot, hd, n, NP, hd);
    stage(sdS, PS, HP, dSbuf + slot, hd, n, NP, hd);
    if (warp == 0) chunk_decays(loga + (long)bi * L * nh + h, nh, c0, q, Q, sCum, sCum2, sEc, sW);
    cp_async_commit_wait_all();
    __syncthreads();   // (b)

    // ---- the state's terms ----
    float dx[NB][4][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      zero(dx[i]);
      const int u = warp + WARPS * i;
      if (u >= nbh) continue;
      const int rt = u % RT, cb = u / RT;
      // w_s (B_s dS)
      mma_block<4, FULL>(dx[i], tiles_in(HP, cb), 0, NP,
                         [&](int ii, int k) { return sB[(16 * rt + ii) * PB + k]; },
                         [&](int k, int j) { return sdS[k * PS + 32 * cb + j]; },
                         sW[16 * rt + g], sW[16 * rt + g + 8]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = warp + WARPS * i;
      if (u >= nbn) continue;
      const int rt = u % RT, cb = u / RT, nt = tiles_in(NP, cb);
      const int ra = 16 * rt + g, rb = ra + 8;
      float tmp[4][4];
      // exp(cum_t) (dy_t S^T) into dC, and its dot with C_t
      zero(tmp);
      mma_block<4, FULL>(tmp, nt, 0, HP,
                         [&](int ii, int k) { return sDy[(16 * rt + ii) * PX + k]; },
                         [&](int k, int j) { return sS[(32 * cb + j) * PS + k]; }, sEc[ra],
                         sEc[rb]);
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 32 * cb + 8 * j + 2 * cq;
        if (j < nt) {
          pa += sC[ra * PB + k] * tmp[j][0] + sC[ra * PB + k + 1] * tmp[j][1];
          pb += sC[rb * PB + k] * tmp[j][2] + sC[rb * PB + k + 1] * tmp[j][3];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dC[i][j][e] += tmp[j][e];
      }
      pa += __shfl_xor_sync(FULL, pa, 1);
      pa += __shfl_xor_sync(FULL, pa, 2);
      pb += __shfl_xor_sync(FULL, pb, 1);
      pb += __shfl_xor_sync(FULL, pb, 2);
      if (cq == 0) {
        sT1[cb * Q + ra] = pa;
        sT1[cb * Q + rb] = pb;
      }
      // w_s (xdt_s dS^T) into dB, and its dot with B_s
      zero(tmp);
      mma_block<4, FULL>(tmp, nt, 0, HP,
                         [&](int ii, int k) { return sX[(16 * rt + ii) * PX + k]; },
                         [&](int k, int j) { return sdS[(32 * cb + j) * PS + k]; }, sW[ra],
                         sW[rb]);
      pa = pb = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 32 * cb + 8 * j + 2 * cq;
        if (j < nt) {
          pa += sB[ra * PB + k] * tmp[j][0] + sB[ra * PB + k + 1] * tmp[j][1];
          pb += sB[rb * PB + k] * tmp[j][2] + sB[rb * PB + k + 1] * tmp[j][3];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dB[i][j][e] += tmp[j][e];
      }
      pa += __shfl_xor_sync(FULL, pa, 1);
      pa += __shfl_xor_sync(FULL, pa, 2);
      pb += __shfl_xor_sync(FULL, pb, 1);
      pb += __shfl_xor_sync(FULL, pb, 2);
      if (cq == 0) {
        sT2[cb * Q + ra] = pa;
        sT2[cb * Q + rb] = pb;
      }
    }
    {   // <S, dS>: a thread's part, then the warp's in a fixed tree
      float part = 0.f;
      for (int i = tid; i < nn; i += THREADS) {
        const int k = i / hd, j = i % hd;
        part = fmaf(sS[k * PS + j], sdS[k * PS + j], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
      if (lane == 0) sRed[warp] = part;
    }
    __syncthreads();   // (c) the state's readers are done: M^T, dM^T take its place

    // ---- M^T, dM^T and P^T's sums on this warp's tiles ----
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      const int idx = warp + WARPS * i;
      if (idx >= NTT) break;
      int r, ct;
      tri_tile(idx, CT, r, ct);
      float dd[1][4];
      zero(dd);
      mma_block<1, true>(dd, 1, 0, HP,
                         [&](int ii, int k) { return sX[(16 * r + ii) * PX + k]; },
                         [&](int k, int j) { return sDy[(8 * ct + j) * PX + k]; });
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * r + g + 8 * (e >> 1), t = 8 * ct + 2 * cq + (e & 1);
        float m = 0.f, dm = 0.f;
        if (t >= s) {
          const float ex = ex2(sCum2[t] - sCum2[s]);
          m = gT[i][e] * ex;
          dm = dd[0][e] * ex;
        }
        p[e] = m * dd[0][e];
        sMT[s * PQ + t] = m;
        sdMT[s * PQ + t] = dm;
      }
      float ra = p[0] + p[1], rb = p[2] + p[3];   // over the tile's columns
      ra += __shfl_xor_sync(FULL, ra, 1);
      ra += __shfl_xor_sync(FULL, ra, 2);
      rb += __shfl_xor_sync(FULL, rb, 1);
      rb += __shfl_xor_sync(FULL, rb, 2);
      float ca = p[0] + p[2], cbv = p[1] + p[3];   // over the tile's rows
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ca += __shfl_xor_sync(FULL, ca, off);
        cbv += __shfl_xor_sync(FULL, cbv, off);
      }
      if (cq == 0) {
        sRow[ct * Q + 16 * r + g] = ra;
        sRow[ct * Q + 16 * r + g + 8] = rb;
      }
      if (g == 0) {
        sCol[r * Q + 8 * ct + 2 * cq] = ca;
        sCol[r * Q + 8 * ct + 2 * cq + 1] = cbv;
      }
    }
    __syncthreads();   // (d)

    // ---- the products with M and dM ----
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = warp + WARPS * i;
      if (u >= nbh) continue;
      const int rt = u % RT, cb = u / RT;
      // dxdt_s += sum_{t >= s} M[t][s] dy_t
      mma_block<4, FULL>(dx[i], tiles_in(HP, cb), 16 * rt, kq,
                         [&](int ii, int k) { return sMT[(16 * rt + ii) * PQ + k]; },
                         [&](int k, int j) { return sDy[k * PX + 32 * cb + j]; });
      store_block<4>(dxdt + xo, xrow, dx[i], 16 * rt, q, 32 * cb, hd);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = warp + WARPS * i;
      if (u >= nbn) continue;
      const int rt = u % RT, cb = u / RT, nt = tiles_in(NP, cb);
      // dC_t += sum_{s <= t} dM[t][s] B_s;  dB_s += sum_{t >= s} dM[t][s] C_t
      mma_block<4, FULL>(dC[i], nt, 0, min(16 * rt + 16, kq),
                         [&](int ii, int k) { return sdMT[k * PQ + 16 * rt + ii]; },
                         [&](int k, int j) { return sB[k * PB + 32 * cb + j]; });
      mma_block<4, FULL>(dB[i], nt, 16 * rt, kq,
                         [&](int ii, int k) { return sdMT[(16 * rt + ii) * PQ + k]; },
                         [&](int k, int j) { return sC[k * PB + 32 * cb + j]; });
    }
    if (warp == 0) {
      // dcum per token (two consecutive a lane at Q = 64), its reverse
      // cumsum by a suffix scan over the lanes; fixed orders throughout
      const int per = Q > 32 ? Q / 32 : 1;
      float sd = 0.f;
      for (int w = 0; w < WARPS; ++w) sd += sRed[w];
      float v[2] = {0.f, 0.f}, t2 = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = lane * per + e;
        if (e < per && t < Q) {
          float rowp = 0.f, colp = 0.f, a = 0.f, bsum = 0.f;
          for (int r = 0; r < RT; ++r) rowp += sCol[r * Q + t];    // sum_s P[t][s]
          for (int ct = 0; ct < CT; ++ct) colp += sRow[ct * Q + t];  // sum_u P[u][t]
          for (int cb = 0; cb < CBN; ++cb) {
            a += sT1[cb * Q + t];
            bsum += sT2[cb * Q + t];
          }
          v[e] = rowp - colp + a - bsum;
          t2 += bsum;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t2 += __shfl_xor_sync(FULL, t2, off);
      const int last = Q - 1;
      if (lane == last / per) v[last % per] += expf(sCum[last]) * sd + t2;
      const float mine = per == 2 ? v[0] + v[1] : v[0];
      float incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float dn = __shfl_down_sync(FULL, incl, off);
        if (lane + off < 32) incl += dn;
      }
      float above = __shfl_down_sync(FULL, incl, 1);
      if (lane == 31) above = 0.f;
      float* dl = dloga + (long)bi * L * nh + h;
      const float d1 = v[1] + above, d0 = mine + above;
      const int t0 = lane * per;
      if (t0 < q) dl[(long)(c0 + t0) * nh] = d0;
      if (per == 2 && t0 + 1 < q) dl[(long)(c0 + t0 + 1) * nh] = d1;
    }
  }

  // dB, dC: the group's sums, into the group's slice (b, ng, L, n)
  const long ob = ((long)bi * ng + grp) * L + c0;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int u = warp + WARPS * i;
    if (u >= nbn) continue;
    const int rt = u % RT, cb = u / RT;
    store_block<4>(dCo + ob * n, n, dC[i], 16 * rt, q, 32 * cb, n);
    store_block<4>(dBo + ob * n, n, dB[i], 16 * rt, q, 32 * cb, n);
  }
}

// dB[b, t, k] = sum over the groups of dBp[b, g, t, k], groups in order; dC alike
__global__ void ssd_bwd_group_sum_kernel(const float* __restrict__ dBp,
                                         const float* __restrict__ dCp,
                                         float* __restrict__ dB, float* __restrict__ dC,
                                         int b, int L, int ng, int n) {
  const long per = (long)L * n;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)b * per) return;
  const long bi = i / per, r = i % per;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < ng; ++k) {
    sb += dBp[(bi * ng + k) * per + r];
    sc += dCp[(bi * ng + k) * per + r];
  }
  dB[i] = sb;
  dC[i] = sc;
}

long long floats4(long long v) { return (v + 3) / 4 * 4; }

// the local pass, then the carry, then the chunk pass (W as the kernels')
template <int NB, int W>
cudaError_t launch_passes(dim3 grid, cudaStream_t st, const float* x, const float* lg,
                          const float* Bp, const float* Cp, const float* gy, const float* dS,
                          float* Sbuf, float* dSbuf, float* totals, float* dxdt, float* dloga,
                          float* dBo, float* dCo, int b, int L, int nh, int hd, int n, int Q) {
  const size_t s1 = sizeof(float) * (size_t)local_layout(Q, n, hd).total;
  auto* k1 = ssd_bwd_local_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)s1);
  if (err != cudaSuccess) return err;
  k1<<<grid, THREADS, s1, st>>>(x, lg, Bp, Cp, gy, Sbuf, dSbuf, totals, L, nh, hd, n, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long lanes = (long long)b * nh * n * hd;
  const bool vec = (n * hd) % 4 == 0;
  const long long threads = vec ? lanes / 4 : lanes;
  ssd_bwd_carry_kernel<<<dim3((unsigned)((threads + 255) / 256), 2), 256, 0, st>>>(
      Sbuf, dSbuf, totals, dS, lanes, grid.x, nh, n * hd, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t s3 = sizeof(float) * (size_t)chunk_layout(Q, n, hd).total;
  auto* k3 = ssd_bwd_chunk_kernel<NB, W>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k3, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  k3<<<grid, THREADS, s3, st>>>(x, lg, Bp, Cp, gy, Sbuf, dSbuf, dxdt, dloga, dBo, dCo, L, nh,
                                hd, n, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t gf_ssd_bwd_smem(int Q, int n, int hd) { return smem_bytes(Q, n, hd); }

// Floats of scratch gf_ssd_bwd needs: the chunks' local terms, then the
// entering states, and the local gradient terms, then the leaving states'
// gradients (b, nc, nh, n, hd) each, the chunks' totals (b, nc, nh), and
// where the heads make more than one group of 8 the groups' dB and dC
// (b, groups, L, n) each; each part starts on 16 bytes.
extern "C" long long gf_ssd_bwd_scratch(int b, int L, int nh, int hd, int n, int Q) {
  const long long nc = (L + Q - 1) / Q, ng = (nh + HG - 1) / HG;
  return 2 * floats4((long long)b * nc * nh * n * hd) + floats4((long long)b * nc * nh) +
         (ng > 1 ? 2 * floats4((long long)b * ng * L * n) : 0);
}

// xdt, dy (b, L, nh, hd), loga (b, L, nh), B/C (b, L, n), dS (b, nh, n, hd)
// or null (zero), all float32 contiguous; dxdt, dloga, dB, dC likewise;
// scratch of gf_ssd_bwd_scratch floats.  Q is 16, 32 or 64 and its shared
// memory (gf_ssd_bwd_smem) fits a block; hd and n from 1 to 128.  Returns
// cudaGetLastError() after the launches.
extern "C" int gf_ssd_bwd(const void* xdt, const void* loga, const void* B,
                          const void* C, const void* dy, const void* dS, void* dxdt,
                          void* dloga, void* dB, void* dC, void* scratch, int b, int L,
                          int nh, int hd, int n, int Q, void* stream) {
  if (b < 1 || L < 1 || nh < 1 || hd < 1 || hd > 128 || n < 1 || n > 128 ||
      (Q != 16 && Q != 32 && Q != 64) || b > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int nc = (L + Q - 1) / Q, ng = (nh + HG - 1) / HG;
  const long long nstate = floats4((long long)b * nc * nh * n * hd);
  float* Sbuf = static_cast<float*>(scratch);
  float* dSbuf = Sbuf + nstate;
  float* totals = dSbuf + nstate;
  float* dBp = totals + floats4((long long)b * nc * nh);
  float* dCp = dBp + floats4((long long)b * ng * L * n);
  const auto* x = static_cast<const float*>(xdt);
  const auto* lg = static_cast<const float*>(loga);
  const auto* Bp = static_cast<const float*>(B);
  const auto* Cp = static_cast<const float*>(C);
  const auto* gy = static_cast<const float*>(dy);
  const dim3 grid(nc, ng, b);
  const auto* gS = static_cast<const float*>(dS);
  auto* gx = static_cast<float*>(dxdt);
  auto* gl = static_cast<float*>(dloga);
  float* dBo = ng > 1 ? dBp : static_cast<float*>(dB);
  float* dCo = ng > 1 ? dCp : static_cast<float*>(dC);
  cudaError_t err;
  if (Q == 64 && round_up(n, 16) == 64 && round_up(hd, 8) == 64)   // zamba2's widths
    err = launch_passes<1, 64>(grid, st, x, lg, Bp, Cp, gy, gS, Sbuf, dSbuf, totals, gx, gl,
                               dBo, dCo, b, L, nh, hd, n, Q);
  else if (blocks_a_warp(Q, n, hd) == 1)
    err = launch_passes<1, 0>(grid, st, x, lg, Bp, Cp, gy, gS, Sbuf, dSbuf, totals, gx, gl,
                              dBo, dCo, b, L, nh, hd, n, Q);
  else
    err = launch_passes<2, 0>(grid, st, x, lg, Bp, Cp, gy, gS, Sbuf, dSbuf, totals, gx, gl,
                              dBo, dCo, b, L, nh, hd, n, Q);
  if (err != cudaSuccess || ng == 1) return (int)err;
  const long long total = (long long)b * L * n;
  ssd_bwd_group_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      dBp, dCp, static_cast<float*>(dB), static_cast<float*>(dC), b, L, ng, n);
  return (int)cudaGetLastError();
}
