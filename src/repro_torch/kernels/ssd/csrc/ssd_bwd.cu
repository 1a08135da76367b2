// The gradient of the Mamba2 chunked SSD for Hopper (sm_90a): float32 on
// the CUDA cores, no atomics.
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
// Three launches, in chunks of Q tokens (Q from 16 to 64, chosen by the
//   wrapper to fit shared memory; the function has no chunks):
//   1. ssd_bwd_states_kernel, one CTA per (head, batch row): walking the
//      chunks forward, it writes the state entering each chunk,
//        S_{c+1} = exp(total_c) S_c + B_c^T (xdt_c * exp(total_c - cum)),
//      then walking them in reverse the gradient of the state leaving each,
//        dS_c = exp(total_c) dS_{c+1} + C_c^T (dy_c * exp(cum)).
//   2. ssd_bwd_chunk_kernel, one CTA per (chunk, head, batch row), every
//      chunk at once: with G = C B^T, E = exp(cum_t - cum_s) [t >= s],
//      M = G E, dM = (dy xdt^T) E and P = M (dy xdt^T),
//        dxdt = M^T dy + exp(total - cum) (B dS),
//        dC   = dM B + exp(cum) (dy S^T),  dB = dM^T C + exp(total - cum) (xdt dS^T),
//        dcum = rowsum P - colsum P + (exp(cum) C . dy S^T) - (w B . xdt dS^T),
//        dcum_{Q-1} += exp(total) <S, dS> + sum (w B . xdt dS^T),
//      and dloga is dcum's reverse cumsum inside the chunk.  dB and dC are
//      this head's part, written to a per-head buffer.
//   3. ssd_bwd_head_sum_kernel: dB and dC summed over the heads in head
//      order, so a call gives the same bits every time.
// The exponent is taken only where t >= s: a masked entry would give
//   inf * 0 = NaN.  Any L: the last chunk's tail is zero-filled (its decay
//   zero, so its cum stays the chunk's total).  Products are f32 FMA: one
//   TF32 product misses the SSD's 5e-4 / 5e-3 by 20x (csrc/ssd.cu).  Every
//   product runs on register tiles (gemm2: 4 x 4 outputs a thread, 8
//   shared-memory loads for 16 FMAs), which halved the first version's
//   time, whose threads each loaded both operands of every FMA.
// Left for later: the products on the tensor cores (3xTF32 mma.sync as in
//   the forward, or wgmma), G shared by the heads of a CTA, the states
//   pass fused into the forward, more than one CTA an SM (the chunk pass
//   takes 217,600 B of shared memory at Q = 64, n = hd = 64).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// a row stride of w floats with an odd word count: column walks by
// consecutive threads hit distinct banks
__host__ __device__ inline int odd(int w) { return w | 1; }

struct ChunkLayout {
  int PN, PH, PQ, oC, oX, oDy, oS, odS, oM, odM, oP, oT1, oT2, oCum, oRed, total;
};

__host__ __device__ inline ChunkLayout chunk_layout(int Q, int n, int hd) {
  ChunkLayout l;
  l.PN = odd(n);
  l.PH = odd(hd);
  l.PQ = odd(Q);
  l.oC = Q * l.PN;              // B at 0
  l.oX = l.oC + Q * l.PN;
  l.oDy = l.oX + Q * l.PH;
  l.oS = l.oDy + Q * l.PH;
  l.odS = l.oS + n * l.PH;
  l.oM = l.odS + n * l.PH;
  l.odM = l.oM + Q * l.PQ;
  l.oP = l.odM + Q * l.PQ;
  l.oT1 = l.oP + Q * l.PQ;
  l.oT2 = l.oT1 + Q * l.PN;
  l.oCum = l.oT2 + Q * l.PN;
  l.oRed = l.oCum + Q;
  l.total = l.oRed + THREADS;
  return l;
}

struct StatesLayout {
  int PN, PH, oP, oQ, oCum, total;
};

__host__ __device__ inline StatesLayout states_layout(int Q, int n, int hd) {
  StatesLayout l;
  l.PN = odd(n);
  l.PH = odd(hd);
  l.oP = n * hd;                // the carried state at 0
  l.oQ = l.oP + Q * l.PN;
  l.oCum = l.oQ + Q * l.PH;
  l.total = l.oCum + Q;
  return l;
}

size_t smem_bytes(int Q, int n, int hd) {
  const int a = chunk_layout(Q, n, hd).total, b = states_layout(Q, n, hd).total;
  return sizeof(float) * (size_t)(a > b ? a : b);
}

// warp 0: the inclusive cumsum of the chunk's log-decays (zero past q, so
// the last entry is the chunk's total) into cum[0..Q)
__device__ void chunk_cumsum(const float* lb, long stride, int c0, int q, int Q,
                             float* cum) {
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
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float excl = incl - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * per + e;
    if (e < per && t < Q) cum[t] = excl + v[e];
  }
}

// rows [c0, c0 + q) of a (rows, w) slice with row stride `stride` into
// dst (Q, pitch), zero past q
__device__ void stage(float* dst, int pitch, const float* src, long stride, int c0,
                      int q, int Q, int w) {
  for (int i = threadIdx.x; i < Q * w; i += THREADS) {
    const int t = i / w, k = i % w;
    dst[t * pitch + k] = t < q ? src[(long)(c0 + t) * stride + k] : 0.f;
  }
}

// Two products side by side on register tiles: for i < M, j < N,
//   epi(i, j, sum_{k < K1} a1(i, k) b1(k, j), sum_{k < K2} a2(i, k) b2(k, j)).
// The CTA's 256 threads are a 16 x 16 grid; a thread owns rows tr + 16u
// and columns tc + 16v (u, v < 4) of each 64 x 64 block, so a k step loads
// 4 + 4 operands for 16 FMAs, and consecutive threads read consecutive
// columns.  Rows and columns past M and N read row M - 1 and column N - 1
// and are not passed to epi.
template <class A1, class B1, class A2, class B2, class Epi>
__device__ __forceinline__ void gemm2(int M, int N, int K1, int K2, A1 a1, B1 b1, A2 a2,
                                      B2 b2, Epi epi) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  for (int i0 = 0; i0 < M; i0 += 64)
    for (int j0 = 0; j0 < N; j0 += 64) {
      int ri[4], cj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ri[u] = min(i0 + tr + 16 * u, M - 1);
        cj[u] = min(j0 + tc + 16 * u, N - 1);
      }
      float c1[4][4], c2[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) c1[u][v] = c2[u][v] = 0.f;
      for (int k = 0; k < K1; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          av[u] = a1(ri[u], k);
          bv[u] = b1(k, cj[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) c1[u][v] = fmaf(av[u], bv[v], c1[u][v]);
      }
      for (int k = 0; k < K2; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          av[u] = a2(ri[u], k);
          bv[u] = b2(k, cj[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) c2[u][v] = fmaf(av[u], bv[v], c2[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + tr + 16 * u, j = j0 + tc + 16 * v;
          if (i < M && j < N) epi(i, j, c1[u][v], c2[u][v]);
        }
    }
}

__device__ __forceinline__ float zero2(int, int) { return 0.f; }

__global__ void __launch_bounds__(THREADS)
ssd_bwd_states_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ dy, const float* __restrict__ dS_final,
                      float* __restrict__ Sbuf, float* __restrict__ dSbuf, int L, int nh,
                      int hd, int n, int Q) {
  const StatesLayout lay = states_layout(Q, n, hd);
  extern __shared__ float smem[];
  float* sS = smem;               // (n, hd)   the carried state or its gradient
  float* sP = smem + lay.oP;      // (Q, PN)   B or C of the chunk
  float* sQ = smem + lay.oQ;      // (Q, PH)   xdt * w or dy * exp(cum)
  float* sCum = smem + lay.oCum;  // (Q)
  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int nc = (L + Q - 1) / Q, nn = n * hd;
  const long xrow = (long)nh * hd;
  const float* xb = xdt + (long)bi * L * xrow + (long)h * hd;
  const float* gb = dy + (long)bi * L * xrow + (long)h * hd;
  const float* lb = loga + (long)bi * L * nh + h;
  const float* Bb = Bm + (long)bi * L * n;
  const float* Cb = Cm + (long)bi * L * n;
  // (b, nc, nh, n, hd)
  auto slot = [&](float* buf, int c) { return buf + (((long)bi * nc + c) * nh + h) * nn; };

  for (int i = tid; i < nn; i += THREADS) sS[i] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q, q = min(Q, L - c0);
    __syncthreads();   // the last chunk's readers are done
    if (tid < 32) chunk_cumsum(lb, nh, c0, q, Q, sCum);
    stage(sP, lay.PN, Bb, n, c0, q, Q, n);
    stage(sQ, lay.PH, xb, xrow, c0, q, Q, hd);
    float* out = slot(Sbuf, c);
    for (int i = tid; i < nn; i += THREADS) out[i] = sS[i];
    __syncthreads();
    const float total = sCum[Q - 1];
    for (int i = tid; i < Q * hd; i += THREADS) {
      const int t = i / hd;
      sQ[t * lay.PH + i % hd] *= expf(total - sCum[t]);
    }
    __syncthreads();
    const float et = expf(total);
    gemm2(n, hd, q, 0,
          [&](int k, int t) { return sP[t * lay.PN + k]; },
          [&](int t, int j) { return sQ[t * lay.PH + j]; }, zero2, zero2,
          [&](int k, int j, float acc, float) {
            sS[k * hd + j] = fmaf(et, sS[k * hd + j], acc);
          });
  }

  __syncthreads();
  const float* dSf = dS_final ? dS_final + ((long)bi * nh + h) * nn : nullptr;
  for (int i = tid; i < nn; i += THREADS) sS[i] = dSf ? dSf[i] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, q = min(Q, L - c0);
    __syncthreads();
    if (tid < 32) chunk_cumsum(lb, nh, c0, q, Q, sCum);
    stage(sP, lay.PN, Cb, n, c0, q, Q, n);
    stage(sQ, lay.PH, gb, xrow, c0, q, Q, hd);
    float* out = slot(dSbuf, c);
    for (int i = tid; i < nn; i += THREADS) out[i] = sS[i];
    __syncthreads();
    for (int i = tid; i < Q * hd; i += THREADS) {
      const int t = i / hd;
      sQ[t * lay.PH + i % hd] *= expf(sCum[t]);
    }
    __syncthreads();
    const float et = expf(sCum[Q - 1]);
    gemm2(n, hd, q, 0,
          [&](int k, int t) { return sP[t * lay.PN + k]; },
          [&](int t, int j) { return sQ[t * lay.PH + j]; }, zero2, zero2,
          [&](int k, int j, float acc, float) {
            sS[k * hd + j] = fmaf(et, sS[k * hd + j], acc);
          });
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ dy, const float* __restrict__ Sbuf,
                     const float* __restrict__ dSbuf, float* __restrict__ dxdt,
                     float* __restrict__ dloga, float* __restrict__ dBp,
                     float* __restrict__ dCp, int L, int nh, int hd, int n, int Q) {
  const ChunkLayout lay = chunk_layout(Q, n, hd);
  const int PN = lay.PN, PH = lay.PH, PQ = lay.PQ;
  extern __shared__ float smem[];
  float* sB = smem;                 // (Q, PN)
  float* sC = smem + lay.oC;        // (Q, PN)
  float* sX = smem + lay.oX;        // (Q, PH)  xdt
  float* sDy = smem + lay.oDy;      // (Q, PH)
  float* sS = smem + lay.oS;        // (n, PH)  the state entering the chunk
  float* sdS = smem + lay.odS;      // (n, PH)  the gradient of the state leaving it
  float* sM = smem + lay.oM;        // (Q, PQ)  M[t][s]
  float* sdM = smem + lay.odM;      // (Q, PQ)  dM[t][s]
  float* sP = smem + lay.oP;        // (Q, PQ)  P[t][s]
  float* sT1 = smem + lay.oT1;      // (Q, PN)  exp(cum_t) C[t][k] (dy_t S^T)[k]
  float* sT2 = smem + lay.oT2;      // (Q, PN)  w_s B[s][k] (xdt_s dS^T)[k]
  float* sCum = smem + lay.oCum;    // (Q)
  float* sRed = smem + lay.oRed;    // (THREADS)
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int nc = gridDim.x, nn = n * hd;
  const int c0 = c * Q, q = min(Q, L - c0);
  const long xrow = (long)nh * hd;
  const float* xb = xdt + (long)bi * L * xrow + (long)h * hd;
  const float* gb = dy + (long)bi * L * xrow + (long)h * hd;
  const float* lb = loga + (long)bi * L * nh + h;
  const long sl = (((long)bi * nc + c) * nh + h) * nn;

  if (tid < 32) chunk_cumsum(lb, nh, c0, q, Q, sCum);
  stage(sB, PN, Bm + (long)bi * L * n, n, c0, q, Q, n);
  stage(sC, PN, Cm + (long)bi * L * n, n, c0, q, Q, n);
  stage(sX, PH, xb, xrow, c0, q, Q, hd);
  stage(sDy, PH, gb, xrow, c0, q, Q, hd);
  for (int i = tid; i < nn; i += THREADS) {
    const int k = i / hd, j = i % hd;
    sS[k * PH + j] = Sbuf[sl + i];
    sdS[k * PH + j] = dSbuf[sl + i];
  }
  __syncthreads();

  // M, dM and P on the triangle t >= s (zero above it and past q), from
  // G = C B^T and dy xdt^T
  gemm2(Q, Q, n, hd,
        [&](int t, int k) { return sC[t * PN + k]; },
        [&](int k, int s) { return sB[s * PN + k]; },
        [&](int t, int j) { return sDy[t * PH + j]; },
        [&](int j, int s) { return sX[s * PH + j]; },
        [&](int t, int s, float g, float dd) {
          float m = 0.f, dm = 0.f, p = 0.f;
          if (s <= t && t < q) {
            const float e = expf(sCum[t] - sCum[s]);
            m = g * e;
            dm = dd * e;
            p = m * dd;
          }
          sM[t * PQ + s] = m;
          sdM[t * PQ + s] = dm;
          sP[t * PQ + s] = p;
        });
  __syncthreads();

  const float total = sCum[Q - 1];
  float* dxb = dxdt + (long)bi * L * xrow + (long)h * hd;
  // dxdt_s = sum_{t >= s} M[t][s] dy_t + w_s (B_s dS)
  gemm2(Q, hd, Q, n,
        [&](int s, int t) { return sM[t * PQ + s]; },
        [&](int t, int j) { return sDy[t * PH + j]; },
        [&](int s, int k) { return sB[s * PN + k]; },
        [&](int k, int j) { return sdS[k * PH + j]; },
        [&](int s, int j, float acc, float st) {
          if (s < q) dxb[(long)(c0 + s) * xrow + j] = fmaf(expf(total - sCum[s]), st, acc);
        });
  // this head's dC_t = sum_{s <= t} dM[t][s] B_s + exp(cum_t) (dy_t S^T) and
  // dB_s = sum_{t >= s} dM[t][s] C_t + w_s (xdt_s dS^T), in (b, nh, L, n);
  // rows past q are zero (their C, B, dy and xdt are)
  float* dCb = dCp + ((long)bi * nh + h) * L * n;
  float* dBb = dBp + ((long)bi * nh + h) * L * n;
  gemm2(Q, n, Q, hd,
        [&](int t, int s) { return sdM[t * PQ + s]; },
        [&](int s, int k) { return sB[s * PN + k]; },
        [&](int t, int j) { return sDy[t * PH + j]; },
        [&](int j, int k) { return sS[k * PH + j]; },
        [&](int t, int k, float acc, float r) {
          const float ec = expf(sCum[t]);
          if (t < q) dCb[(long)(c0 + t) * n + k] = fmaf(ec, r, acc);
          sT1[t * PN + k] = ec * sC[t * PN + k] * r;
        });
  gemm2(Q, n, Q, hd,
        [&](int s, int t) { return sdM[t * PQ + s]; },
        [&](int t, int k) { return sC[t * PN + k]; },
        [&](int s, int j) { return sX[s * PH + j]; },
        [&](int j, int k) { return sdS[k * PH + j]; },
        [&](int s, int k, float acc, float rb) {
          const float w = expf(total - sCum[s]);
          if (s < q) dBb[(long)(c0 + s) * n + k] = fmaf(w, rb, acc);
          sT2[s * PN + k] = w * sB[s * PN + k] * rb;
        });
  // exp(total) <S, dS>: per-thread parts, summed in thread order below
  float part = 0.f;
  for (int i = tid; i < nn; i += THREADS) {
    const int k = i / hd, j = i % hd;
    part = fmaf(sS[k * PH + j], sdS[k * PH + j], part);
  }
  sRed[tid] = part;
  __syncthreads();

  // dcum per token, then its reverse cumsum; one warp, fixed order
  if (tid < 32) {
    float* dcum = sRed;   // its first Q entries are free once summed
    float sd = 0.f;
    if (tid == 0)
      for (int i = 0; i < THREADS; ++i) sd += sRed[i];
    sd = __shfl_sync(0xffffffffu, sd, 0);
    __syncwarp();
    float t2sum_part = 0.f;
    float vals[4];
    const int per = (Q + 31) / 32;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tid * per + e;
      vals[e] = 0.f;
      if (e < per && t < Q) {
        float row = 0.f, col = 0.f, a = 0.f, b = 0.f;
        for (int s = 0; s < Q; ++s) row += sP[t * PQ + s];
        for (int u = 0; u < Q; ++u) col += sP[u * PQ + t];
        for (int k = 0; k < n; ++k) {
          a += sT1[t * PN + k];
          b += sT2[t * PN + k];
        }
        vals[e] = row - col + a - b;
        t2sum_part += b;
      }
    }
    // sum of the t2 terms in lane order
    float t2sum = 0.f;
    for (int l = 0; l < 32; ++l) t2sum += __shfl_sync(0xffffffffu, t2sum_part, l);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tid * per + e;
      if (e < per && t < Q) dcum[t] = vals[e];
    }
    __syncwarp();
    if (tid == 0) {
      dcum[Q - 1] += expf(total) * sd + t2sum;
      float run = 0.f;
      float* dl = dloga + (long)bi * L * nh + h;
      for (int t = Q - 1; t >= 0; --t) {
        run += dcum[t];
        if (t < q) dl[(long)(c0 + t) * nh] = run;
      }
    }
  }
}

// dB[b, t, k] = sum over heads of dBp[b, h, t, k], heads in order; dC alike
__global__ void ssd_bwd_head_sum_kernel(const float* __restrict__ dBp,
                                        const float* __restrict__ dCp,
                                        float* __restrict__ dB, float* __restrict__ dC,
                                        int b, int L, int nh, int n) {
  const long per = (long)L * n;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)b * per) return;
  const long bi = i / per, r = i % per;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < nh; ++h) {
    sb += dBp[(bi * nh + h) * per + r];
    sc += dCp[(bi * nh + h) * per + r];
  }
  dB[i] = sb;
  dC[i] = sc;
}

}  // namespace

extern "C" size_t gf_ssd_bwd_smem(int Q, int n, int hd) { return smem_bytes(Q, n, hd); }

// Floats of scratch gf_ssd_bwd needs: the entering states and the leaving
// states' gradients (b, nc, nh, n, hd) each, the per-head dB and dC
// (b, nh, L, n) each.
extern "C" long long gf_ssd_bwd_scratch(int b, int L, int nh, int hd, int n, int Q) {
  const long long nc = (L + Q - 1) / Q;
  return 2 * (long long)b * nc * nh * n * hd + 2 * (long long)b * nh * L * n;
}

// xdt, dy (b, L, nh, hd), loga (b, L, nh), B/C (b, L, n), dS (b, nh, n, hd)
// or null (zero), all float32 contiguous; dxdt, dloga, dB, dC likewise;
// scratch of gf_ssd_bwd_scratch floats.  Q is 16, 32 or 64 and its shared
// memory (gf_ssd_bwd_smem) fits a block; hd and n from 1 to 128.  Returns
// cudaGetLastError() after the three launches.
extern "C" int gf_ssd_bwd(const void* xdt, const void* loga, const void* B,
                          const void* C, const void* dy, const void* dS, void* dxdt,
                          void* dloga, void* dB, void* dC, void* scratch, int b, int L,
                          int nh, int hd, int n, int Q, void* stream) {
  if (b < 1 || L < 1 || nh < 1 || hd < 1 || hd > 128 || n < 1 || n > 128 ||
      (Q != 16 && Q != 32 && Q != 64) || b > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int nc = (L + Q - 1) / Q;
  const long long nstate = (long long)b * nc * nh * n * hd;
  float* Sbuf = static_cast<float*>(scratch);
  float* dSbuf = Sbuf + nstate;
  float* dBp = dSbuf + nstate;
  float* dCp = dBp + (long long)b * nh * L * n;
  const auto* x = static_cast<const float*>(xdt);
  const auto* lg = static_cast<const float*>(loga);
  const auto* Bp = static_cast<const float*>(B);
  const auto* Cp = static_cast<const float*>(C);
  const auto* gy = static_cast<const float*>(dy);

  const size_t s1 = sizeof(float) * (size_t)states_layout(Q, n, hd).total;
  const size_t s2 = sizeof(float) * (size_t)chunk_layout(Q, n, hd).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_states_kernel<<<dim3(nh, b), THREADS, s1, st>>>(
      x, lg, Bp, Cp, gy, static_cast<const float*>(dS), Sbuf, dSbuf, L, nh, hd, n, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<<<dim3(nc, nh, b), THREADS, s2, st>>>(
      x, lg, Bp, Cp, gy, Sbuf, dSbuf, static_cast<float*>(dxdt),
      static_cast<float*>(dloga), dBp, dCp, L, nh, hd, n, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * L * n;
  ssd_bwd_head_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      dBp, dCp, static_cast<float*>(dB), static_cast<float*>(dC), b, L, nh, n);
  return (int)cudaGetLastError();
}
