// Mamba2 chunked SSD (state-space dual) for Hopper (sm_90a): CUDA cores and
// shared memory, float32 throughout.
//
// Replaces: src/repro/kernels/ssd/kernel.py::_ssd_kernel (the Pallas TPU
//   kernel behind ssd, kernel.py:76).  Same function, on the pre-weighted
//   inputs xdt = x*dt (b, L, nh, hd) and loga = dt*A (b, L, nh), with B and C
//   (b, L, n) shared by all heads.  Per chunk of Q tokens:
//     cum = cumsum(loga),  G = C B^T,  M = G * exp(cum_t - cum_s) * [t >= s],
//     y   = M @ xdt + (C * exp(cum)) @ S,
//     S   = exp(total) S + B^T (xdt * exp(total - cum)),
//   returning y (without the D term, which mamba2_apply adds) and the final
//   state (b, nh, n, hd).  The exponent is taken only where t >= s: the
//   Pallas kernel takes exp on the upper triangle and selects afterwards
//   (kernel.py:53), which here would give inf * 0 = NaN.  Any L: the last
//   chunk's tail is masked.
// Yardstick: no single PyTorch call computes it (library_ms is null).
// Bound on an H100: at b=8, L=2048, 80 heads of 64, state 64, it moves
//   ~0.69 GB (xdt and y in f32, loga, B, C, the state), ~0.21 ms at
//   3.35 TB/s.  The function needs ~2.7e10 f32 FLOP in its recurrence form
//   (5 n hd per token and head), ~0.40 ms at 67 TFLOP/s on the CUDA cores;
//   the chunked form at Q=128 needs ~3.2e10 with G shared by the heads and
//   M @ xdt triangular.  So it is bound by operations.  This design computes
//   G per head and M @ xdt over the full square, ~6.4e10 FLOP.
// This first design: one CTA of 256 threads per (head, batch row) walks the
//   chunks in order with the (n, hd) state in shared memory; per chunk it
//   stages C and B transposed, xdt and the (Q, Q) matrix M in shared memory
//   (~180 KB at Q=128, n=hd=64), takes cum by a warp-shuffle scan, and each
//   thread owns an 8 x 8 register block of M, y and the state.  G = C B^T is
//   recomputed by every head of a batch row.  Left for later: tf32/bf16
//   tensor-core products (mma.sync, wgmma), sharing G across the heads of a
//   row, a chunk-parallel first pass with a short sequential state pass, and
//   a smaller footprint for two CTAs per SM.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int MAXR = 8;        // register rows / cols per thread: 8 x 16 = 128

size_t smem_floats(int Q, int n, int hd) {
  const size_t QP = (size_t)Q + 1;
  return 2 * (size_t)n * QP        // C^T, B^T
         + (size_t)Q * hd          // xdt chunk
         + (size_t)Q * QP          // M
         + (size_t)n * hd          // state
         + 3 * (size_t)Q;          // cum, exp(cum), exp(total - cum)
}

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           float* __restrict__ y, float* __restrict__ state, int L, int nh,
           int hd, int n, int Q) {
  const int hi = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int QP = Q + 1;
  extern __shared__ float smem[];
  float* sCt = smem;                 // (n, QP)  C transposed
  float* sBt = sCt + n * QP;         // (n, QP)  B transposed
  float* sX = sBt + n * QP;          // (Q, hd)
  float* sM = sX + Q * hd;           // (Q, QP)
  float* sS = sM + Q * QP;           // (n, hd)  the carried state
  float* sCum = sS + n * hd;         // (Q)
  float* sEc = sCum + Q;             // (Q)      exp(cum_t)
  float* sW = sEc + Q;               // (Q)      exp(total - cum_s)

  for (int idx = tid; idx < n * hd; idx += THREADS) sS[idx] = 0.f;

  const long xrow = (long)nh * hd;   // elements between consecutive tokens
  const float* xb = xdt + (long)bi * L * xrow + (long)hi * hd;
  float* yb = y + (long)bi * L * xrow + (long)hi * hd;
  const float* lb = loga + (long)bi * L * nh + hi;
  const float* Bb = Bm + (long)bi * L * n;
  const float* Cb = Cm + (long)bi * L * n;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int q = min(Q, L - t0);    // live tokens of this chunk
    __syncthreads();                 // the previous chunk's readers are done
    for (int idx = tid; idx < Q * hd; idx += THREADS) {
      const int t = idx / hd, c = idx % hd;
      sX[idx] = t < q ? xb[(long)(t0 + t) * xrow + c] : 0.f;
    }
    for (int idx = tid; idx < Q * n; idx += THREADS) {
      const int t = idx / n, k = idx % n;
      const bool in = t < q;
      sBt[k * QP + t] = in ? Bb[(long)(t0 + t) * n + k] : 0.f;
      sCt[k * QP + t] = in ? Cb[(long)(t0 + t) * n + k] : 0.f;
    }
    if (warp == 0) {
      // inclusive scan of the chunk's log-decays (zero past q, so the last
      // entry is the chunk total): 4 consecutive values a lane, then a
      // shuffle scan of the lane totals
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        v[e] = (t < q) ? lb[(long)(t0 + t) * nh] : 0.f;
      }
      v[1] += v[0]; v[2] += v[1]; v[3] += v[2];
      float run = v[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += up;
      }
      const float excl = run - v[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        if (t < Q) sCum[t] = excl + v[e];
      }
    }
    __syncthreads();
    const float total = sCum[Q - 1];
    for (int t = tid; t < Q; t += THREADS) {
      sEc[t] = expf(sCum[t]);
      sW[t] = expf(total - sCum[t]);
    }

    // M[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t < q, else 0;
    // rows t = ty + 16i, cols s = tx + 16j
    {
      float g[MAXR][MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int j = 0; j < MAXR; ++j) g[i][j] = 0.f;
      for (int k = 0; k < n; ++k) {
        float cv[MAXR], bv[MAXR];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
          cv[i] = (16 * i < Q) ? sCt[k * QP + ty + 16 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < MAXR; ++j)
          bv[j] = (16 * j < Q) ? sBt[k * QP + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
#pragma unroll
          for (int j = 0; j < MAXR; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int t = ty + 16 * i;
        if (16 * i >= Q) break;
#pragma unroll
        for (int j = 0; j < MAXR; ++j) {
          const int s = tx + 16 * j;
          if (16 * j >= Q) break;
          sM[t * QP + s] = (s <= t && t < q) ? g[i][j] * expf(sCum[t] - sCum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][c] = exp(cum_t) sum_k C[t][k] S[k][c] + sum_s M[t][s] x[s][c]
    // with the entering state; rows t = ty + 16i, dims c = tx + 16j
    {
      float a[MAXR][MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int j = 0; j < MAXR; ++j) a[i][j] = 0.f;
      if (t0 > 0) {   // the entering state is zero on the first chunk
        for (int k = 0; k < n; ++k) {
          float cv[MAXR], sv[MAXR];
#pragma unroll
          for (int i = 0; i < MAXR; ++i)
            cv[i] = (16 * i < Q) ? sCt[k * QP + ty + 16 * i] : 0.f;
#pragma unroll
          for (int j = 0; j < MAXR; ++j)
            sv[j] = (16 * j < hd) ? sS[k * hd + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < MAXR; ++i)
#pragma unroll
            for (int j = 0; j < MAXR; ++j) a[i][j] = fmaf(cv[i], sv[j], a[i][j]);
        }
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          const float ec = (16 * i < Q) ? sEc[ty + 16 * i] : 0.f;
#pragma unroll
          for (int j = 0; j < MAXR; ++j) a[i][j] *= ec;
        }
      }
      for (int s = 0; s < q; ++s) {
        float mv[MAXR], xv[MAXR];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
          mv[i] = (16 * i < Q) ? sM[(ty + 16 * i) * QP + s] : 0.f;
#pragma unroll
        for (int j = 0; j < MAXR; ++j)
          xv[j] = (16 * j < hd) ? sX[s * hd + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
#pragma unroll
          for (int j = 0; j < MAXR; ++j) a[i][j] = fmaf(mv[i], xv[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int t = ty + 16 * i;
        if (16 * i >= Q) break;
        if (t >= q) continue;
#pragma unroll
        for (int j = 0; j < MAXR; ++j) {
          if (16 * j >= hd) break;
          yb[(long)(t0 + t) * xrow + tx + 16 * j] = a[i][j];
        }
      }
    }
    __syncthreads();   // every reader of the entering state is done

    // S[k][c] = exp(total) S[k][c] + sum_s B[s][k] exp(total - cum_s) x[s][c];
    // rows k = ty + 16i, dims c = tx + 16j
    {
      const float et = expf(total);
      float a[MAXR][MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int j = 0; j < MAXR; ++j) a[i][j] = 0.f;
      for (int s = 0; s < q; ++s) {
        const float w = sW[s];
        float bv[MAXR], xv[MAXR];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
          bv[i] = (ty + 16 * i < n) ? sBt[(ty + 16 * i) * QP + s] * w : 0.f;
#pragma unroll
        for (int j = 0; j < MAXR; ++j)
          xv[j] = (16 * j < hd) ? sX[s * hd + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
#pragma unroll
          for (int j = 0; j < MAXR; ++j) a[i][j] = fmaf(bv[i], xv[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int k = ty + 16 * i;
        if (k >= n) break;
#pragma unroll
        for (int j = 0; j < MAXR; ++j) {
          if (16 * j >= hd) break;
          float* sp = sS + k * hd + tx + 16 * j;
          *sp = fmaf(et, *sp, a[i][j]);
        }
      }
    }
  }
  __syncthreads();
  float* st = state + ((long)bi * nh + hi) * n * hd;
  for (int idx = tid; idx < n * hd; idx += THREADS) st[idx] = sS[idx];
}

}  // namespace

extern "C" size_t gf_ssd_smem(int chunk, int n, int hd) {
  return sizeof(float) * smem_floats(chunk, n, hd);
}

// xdt (b, L, nh, hd), loga (b, L, nh), B/C (b, L, n), all float32 and
// contiguous; y (b, L, nh, hd), state (b, nh, n, hd) float32.  chunk is a
// multiple of 16 up to 128, hd a multiple of 16 up to 128, n up to 128.
// Returns cudaGetLastError().
extern "C" int gf_ssd(const void* xdt, const void* loga, const void* B,
                      const void* C, void* y, void* state, int b, int L, int nh,
                      int hd, int n, int chunk, void* stream) {
  const size_t smem = gf_ssd_smem(chunk, n, hd);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<dim3(nh, b), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(state), L, nh, hd, n, chunk);
  return (int)cudaGetLastError();
}
