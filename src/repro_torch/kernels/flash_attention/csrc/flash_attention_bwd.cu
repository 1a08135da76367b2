// Flash attention backward for Hopper (sm_90a): dq, dk and dv of the
// forward in flash_attention.cu.
//
// Replaces: nothing of the reference's kernels.  The reference has no
//   backward kernel (no custom_vjp under src/repro/kernels/): its trainer
//   takes jax.grad through the chunked XLA attention
//   (src/repro/models/attention.py::chunked_attention), and the Pallas
//   forward (src/repro/kernels/flash_attention/kernel.py::_flash_kernel)
//   is never differentiated.  The port sends attention to its forward
//   kernel at every length, so the trainer needs this kernel.  Same
//   function as autograd through the forward: GQA (query head h reads kv
//   head h / (H / KV), so each kv head's dk and dv sum over its group),
//   causal masking aligned bottom-right (query i sees keys <= i + sk - sq),
//   any sq <= sk under the mask and any sq, sk without it, ragged tiles
//   masked here.  The gradients come back in the inputs' dtype.
// Yardstick (timed beside it, never on the path): torch.autograd.grad
//   through scaled_dot_product_attention(..., is_causal=True, enable_gqa=True).
// Bound on an H100: the backward does 2.5 times the forward's products
//   (S and dP = dO V^T recomputed, then dV, dK and dQ: five matmuls against
//   the forward's two); at granite's microbatch (b=2, s=4096, 32 heads of
//   64 over 8, causal) that is ~3.4e11 FLOP, ~0.35 ms at the 989 TFLOP/s
//   bf16 tensor-core rate, against ~0.03 ms for its bytes.  So it is bound
//   by the tensor cores' operations.
//
// FlashAttention-2's backward in three kernels, no atomics (so the result
// does not change from run to run):
//   1. flash_bwd_dot_kernel: D = rowsum(dO * O) in f32, (b, h, sq).
//   2. flash_bwd_dkdv_*: one CTA per (kv head, batch, 64-key tile).  It
//      keeps its keys' K and V in shared memory and walks the h/kv query
//      heads of its group and, for each, the query tiles that can see its
//      keys; per tile it recomputes S^T = K Q^T, P^T = exp(S^T scale - lse)
//      and dP^T = V dO^T, forms dS^T = P^T * (dP^T - D), and accumulates
//      dV += P^T dO and dK += dS^T Q in f32 registers; dK is scaled once at
//      the end.
//   3. flash_bwd_dq_*: one CTA per (head, batch, 64-query tile), walking
//      the key tiles its rows can see: S, P and dP as above, then
//      dQ += dS K, scaled once at the end.
// Two routes, picked by the wrapper from the dtype:
// bf16: tensor cores, mma.sync.m16n8k16 bf16 -> f32 (HMMA) for all five
//   products, 4 warps of 16 rows (keys in kernel 2, queries in kernel 3).
//   The streamed operands (Q and dO in kernel 2, K and V in kernel 3) pass
//   through a 2-stage shared-memory ring filled by 16-byte cp.async, the
//   next tile's copy issued before this tile's math; the resident ones are
//   loaded once.  P^T and dS^T (and dS) are rounded to bf16 for their
//   products as the forward rounds P, directly from the accumulator
//   fragments (their layout maps pairwise onto the A operand).  At
//   head_dim 128 kernel 2 walks 32-query tiles, so that the S^T and dP^T
//   fragments fit beside the dK and dV accumulators.  Left for later: wgmma
//   with TMA, dQ in the same pass (it needs atomics or a second
//   accumulation), a persistent grid.
// f32: CUDA cores, 256 threads (16 x 16) over 64 x 64 tiles staged in
//   shared memory as f32, the forward f32 route's scheme; no main path
//   trains in f32, the route exists for the f32 tolerance of 2e-5.
#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO * O)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// one warp a row of (b, sq, h); the row's d values are contiguous
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dsum, long rows, int sq, int h, int d) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* po = o + row * d;
  const T* pd = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(po[c]), to_f32(pd[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hi = (int)(row % h);
    const long bs = row / h;   // bi * sq + i
    const int i = (int)(bs % sq);
    const long bi = bs / sq;
    dsum[(bi * h + hi) * sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FB = 64;        // rows of a tile (queries or keys)
constexpr int F_THREADS = 256;

template <int D>
constexpr size_t f32_dq_smem() {
  return sizeof(float) * (size_t)(4 * FB * (D + 1) + FB * (FB + 1));
}
template <int D>
constexpr size_t f32_dkdv_smem() {
  return sizeof(float) * (size_t)(4 * FB * (D + 1) + 2 * FB * (FB + 1) + 2 * FB);
}

// rows r0.. of a (.., pitch) f32 array into a shared tile of pitch D + 1;
// rows at or past rmax are zero
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long pitch, int r0,
                                         int rmax, int tid) {
  for (int idx = tid; idx < FB * D; idx += F_THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < rmax ? src[(long)(r0 + r) * pitch + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        float* __restrict__ dq, int sq, int sk, int h, int kvh, float scale,
                        int causal) {
  constexpr int DP = D + 1, PP = FB + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + FB * DP;
  float* sK = sdO + FB * DP;
  float* sV = sK + FB * DP;
  float* sS = sV + FB * DP;   // dS of the tile

  const int q0 = blockIdx.x * FB, hi = blockIdx.y, bi = blockIdx.z;
  const int kvi = hi / (h / kvh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_row = (long)h * D, kv_row = (long)kvh * D;
  const long qoff = (long)bi * sq * q_row + (long)hi * D;
  const float* kb = k + (long)bi * sk * kv_row + (long)kvi * D;
  const float* vb = v + (long)bi * sk * kv_row + (long)kvi * D;
  const float* lb = lse + ((long)bi * h + hi) * sq;
  const float* db = dsum + ((long)bi * h + hi) * sq;
  const int q_offset = sk - sq;

  load_f32<D>(sQ, q + qoff, q_row, q0, sq, tid);
  load_f32<D>(sdO, dout + qoff, q_row, q0, sq, tid);
  float lr[4], dr[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lr[i] = qi < sq ? lb[qi] : 0.f;
    dr[i] = qi < sq ? db[qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + FB, sq) - 1 + q_offset + 1);

  for (int k0 = 0; k0 < k_end; k0 += FB) {
    __syncthreads();   // the previous tile's readers are done
    load_f32<D>(sK, kb, kv_row, k0, sk, tid);
    load_f32<D>(sV, vb, kv_row, k0, sk, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * DP + kk];
        gv[i] = sdO[(ty + 16 * i) * DP + kk];
        kv[i] = sK[(tx + 16 * i) * DP + kk];
        vv[i] = sV[(tx + 16 * i) * DP + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < sq && kj < sk && (!causal || kj <= qi + q_offset);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        sS[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
    const int nk = min(FB, sk - k0);
    for (int j = 0; j < nk; ++j) {
      float ds[4], kv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = sK[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      dq[qoff + (long)qi * q_row + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                          int h, int kvh, float scale, int causal) {
  constexpr int DP = D + 1, PP = FB + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + FB * DP;
  float* sQ = sV + FB * DP;
  float* sdO = sQ + FB * DP;
  float* sP = sdO + FB * DP;    // P^T of the tile, [key][query]
  float* sdS = sP + FB * PP;    // dS^T
  float* sL = sdS + FB * PP;    // the tile's lse
  float* sD = sL + FB;          // the tile's D

  const int k0 = blockIdx.x * FB, kvi = blockIdx.y, bi = blockIdx.z;
  const int grp = h / kvh;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long q_row = (long)h * D, kv_row = (long)kvh * D;
  const long kvoff = (long)bi * sk * kv_row + (long)kvi * D;
  const int q_offset = sk - sq;
  // query rows before q_first see none of these keys
  const int q_first = causal ? max(0, k0 - q_offset) : 0;

  load_f32<D>(sK, k + kvoff, kv_row, k0, sk, tid);
  load_f32<D>(sV, v + kvoff, kv_row, k0, sk, tid);
  float ak[4][DPT], av[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int g = 0; g < grp; ++g) {
    const int hi = kvi * grp + g;
    const long qoff = (long)bi * sq * q_row + (long)hi * D;
    const float* lb = lse + ((long)bi * h + hi) * sq;
    const float* db = dsum + ((long)bi * h + hi) * sq;
    for (int q0 = (q_first / FB) * FB; q0 < sq; q0 += FB) {
      __syncthreads();   // the previous tile's readers are done
      load_f32<D>(sQ, q + qoff, q_row, q0, sq, tid);
      load_f32<D>(sdO, dout + qoff, q_row, q0, sq, tid);
      if (tid < FB) {
        sL[tid] = q0 + tid < sq ? lb[q0 + tid] : 0.f;
        sD[tid] = q0 + tid < sq ? db[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty + 16 * i) * DP + kk];
          vv[i] = sV[(ty + 16 * i) * DP + kk];
          qv[i] = sQ[(tx + 16 * i) * DP + kk];
          gv[i] = sdO[(tx + 16 * i) * DP + kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j, qi = q0 + qc;
          const bool ok = qi < sq && kj < sk && (!causal || kj <= qi + q_offset);
          const float p = ok ? expf(s[i][j] * scale - sL[qc]) : 0.f;
          sP[(ty + 16 * i) * PP + qc] = p;
          sdS[(ty + 16 * i) * PP + qc] = p * (dp[i][j] - sD[qc]);
        }
      }
      __syncthreads();
      const int nq = min(FB, sq - q0);
      for (int j = 0; j < nq; ++j) {
        float pv[4], dsv[4], gv[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty + 16 * i) * PP + j];
          dsv[i] = sdS[(ty + 16 * i) * PP + j];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          gv[c] = sdO[j * DP + tx + 16 * c];
          qv[c] = sQ[j * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            av[i][c] = fmaf(pv[i], gv[c], av[i][c]);
            ak[i][c] = fmaf(dsv[i], qv[c], ak[i][c]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= sk) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[kvoff + (long)kj * kv_row + tx + 16 * c] = ak[i][c] * scale;
      dv[kvoff + (long)kj * kv_row + tx + 16 * c] = av[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), cp.async ring
// ---------------------------------------------------------------------------

constexpr int T_THREADS = 128;   // 4 warps of 16 rows
constexpr int T_ROWS = 64;       // resident rows a CTA: keys (dK/dV) or queries (dQ)
constexpr int T_BK = 64;         // streamed keys a tile in dQ

// query rows a streamed tile in dK/dV: 32 at head_dim 128, where the S^T
// and dP^T fragments of 64 would not fit beside the dK and dV accumulators
template <int D>
__host__ __device__ constexpr int dkdv_bq() { return D <= 80 ? 64 : 32; }

template <int D>
constexpr size_t dkdv_bf16_smem() {
  return sizeof(bf16) * (size_t)(D + 8) * (2 * T_ROWS + 4 * dkdv_bq<D>()) +
         sizeof(float) * 4 * dkdv_bq<D>();
}
template <int D>
constexpr size_t dq_bf16_smem() {
  return sizeof(bf16) * (size_t)(D + 8) * (2 * T_ROWS + 4 * T_BK);
}

template <int D>
__global__ void __launch_bounds__(T_THREADS)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dsum,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                           int h, int kvh, float scale_log2, float scale, int causal) {
  constexpr int BQ = dkdv_bq<D>();
  constexpr int DP = D + 8;       // row pitch in shared memory, elements
  constexpr int KS = D / 16;      // k-steps over head_dim
  constexpr int NB = D / 8;       // n-blocks over head_dim
  constexpr int QN = BQ / 8;      // n-blocks over the tile's queries
  constexpr int QK = BQ / 16;     // k-steps over the tile's queries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [T_ROWS][DP]
  bf16* sV = sK + T_ROWS * DP;                     // [T_ROWS][DP]
  bf16* sQ = sV + T_ROWS * DP;                     // [2][BQ][DP]
  bf16* sdO = sQ + 2 * BQ * DP;                    // [2][BQ][DP]
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * DP);   // [2][BQ], lse * log2(e)
  float* sD = sL + 2 * BQ;                                   // [2][BQ]

  const int k0 = blockIdx.z * T_ROWS;   // causal: the first key tiles see the most queries
  const int kvi = blockIdx.x, bi = blockIdx.y;
  const int grp = h / kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const long q_row = (long)h * D, kv_row = (long)kvh * D;
  const long kvoff = (long)bi * sk * kv_row + (long)kvi * D;
  const int q_offset = sk - sq;
  // query rows before q_first see none of these keys (k0 <= sk - 1, so
  // q_first <= sq - 1 and every CTA has a tile)
  const int q_first = causal ? max(0, k0 - q_offset) : 0;
  const int t_first = q_first / BQ;
  const int n_t = (sq + BQ - 1) / BQ - t_first;   // query tiles a head
  const int n_it = grp * n_t;
  const int kw0 = k0 + warp * 16;                  // the warp's first key

  // the it-th (head, query tile) of the walk into ring stage st
  auto issue = [&](int it, int st) {
    const int hi = kvi * grp + it / n_t;
    const int qt0 = (t_first + it % n_t) * BQ;
    const long qoff = (long)bi * sq * q_row + (long)hi * D;
    load_tile<D, BQ, T_THREADS>(sQ + st * BQ * DP, q + qoff, q_row, qt0, sq, tid);
    load_tile<D, BQ, T_THREADS>(sdO + st * BQ * DP, dout + qoff, q_row, qt0, sq, tid);
    if (tid < BQ) {
      const long r = ((long)bi * h + hi) * sq + qt0 + tid;
      const bool in = qt0 + tid < sq;
      sL[st * BQ + tid] = in ? lse[r] * LOG2E : 0.f;
      sD[st * BQ + tid] = in ? dsum[r] : 0.f;
    }
  };

  load_tile<D, T_ROWS, T_THREADS>(sK, k + kvoff, kv_row, k0, sk, tid);
  load_tile<D, T_ROWS, T_THREADS>(sV, v + kvoff, kv_row, k0, sk, tid);
  issue(0, 0);
  cp_async_commit();

  float ak[NB][4], av[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[nb][e] = av[nb][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();   // stage it & 1 (and K, V) has landed for this thread
    __syncthreads();      // ... for every thread; the other stage is free
    if (it + 1 < n_it) issue(it + 1, (it + 1) & 1);
    cp_async_commit();

    const int st = it & 1;
    const int qt0 = (t_first + it % n_t) * BQ;
    // this warp's keys are padding, or past the diagonal of every query here
    if (kw0 >= sk || (causal && qt0 + BQ - 1 + q_offset < kw0)) continue;
    const bf16* cQ = sQ + st * BQ * DP;
    const bf16* cdO = sdO + st * BQ * DP;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp
    float s[QN][4], dp[QN][4];
#pragma unroll
    for (int nb = 0; nb < QN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<DP>(ka, sK, warp * 16, kk, lane);
      load_a<DP>(va, sV, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < QN / 2; ++np) {
        uint32_t b[4];
        load_b<DP>(b, cQ, np * 16, kk, lane);
        mma_bf16(s[2 * np], ka, b[0], b[1]);
        mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
        load_b<DP>(b, cdO, np * 16, kk, lane);
        mma_bf16(dp[2 * np], va, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P^T into s, dS^T = P^T (dP^T - D) into dp; masked entries are 0
#pragma unroll
    for (int nb = 0; nb < QN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nb * 8 + 2 * tq + (e & 1);
        const int row = qt0 + qc;
        const int key = kw0 + gr + (e < 2 ? 0 : 8);
        const bool ok = row < sq && key < sk && (!causal || key <= row + q_offset);
        const float p = ok ? ex2(fmaf(s[nb][e], scale_log2, -cL[qc])) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - cD[qc]);
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t b[4];
        load_b_trans<DP>(b, cdO, np * 16, kk, lane);
        mma_bf16(av[2 * np], pa, b[0], b[1]);
        mma_bf16(av[2 * np + 1], pa, b[2], b[3]);
        load_b_trans<DP>(b, cQ, np * 16, kk, lane);
        mma_bf16(ak[2 * np], da, b[0], b[1]);
        mma_bf16(ak[2 * np + 1], da, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int key0 = kw0 + gr, key1 = key0 + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * tq;
    if (key0 < sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + kvoff + (long)key0 * kv_row + c) =
          __floats2bfloat162_rn(ak[nb][0] * scale, ak[nb][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + kvoff + (long)key0 * kv_row + c) =
          __floats2bfloat162_rn(av[nb][0], av[nb][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + kvoff + (long)key1 * kv_row + c) =
          __floats2bfloat162_rn(ak[nb][2] * scale, ak[nb][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + kvoff + (long)key1 * kv_row + c) =
          __floats2bfloat162_rn(av[nb][2], av[nb][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(T_THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         bf16* __restrict__ dq, int sq, int sk, int h, int kvh,
                         float scale_log2, float scale, int causal) {
  constexpr int DP = D + 8, KS = D / 16, NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [T_ROWS][DP]
  bf16* sdO = sQ + T_ROWS * DP;                    // [T_ROWS][DP]
  bf16* sK = sdO + T_ROWS * DP;                    // [2][T_BK][DP]
  bf16* sV = sK + 2 * T_BK * DP;                   // [2][T_BK][DP]

  // heaviest first: under the causal mask the last q tile sees the most keys
  const int qt = causal ? (int)gridDim.z - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * T_ROWS;
  const int hi = blockIdx.x, bi = blockIdx.y;
  const int kvi = hi / (h / kvh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const long q_row = (long)h * D, kv_row = (long)kvh * D;
  const long qoff = (long)bi * sq * q_row + (long)hi * D;
  const bf16* kb = k + (long)bi * sk * kv_row + (long)kvi * D;
  const bf16* vb = v + (long)bi * sk * kv_row + (long)kvi * D;
  const int q_offset = sk - sq;

  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + T_ROWS, sq) + q_offset);
  const int ntile = (k_end + T_BK - 1) / T_BK;
  const int wq0 = q0 + warp * 16;
  const bool warp_live = wq0 < sq;
  // the lane's two rows: their lse (base 2) and D
  const int row0 = wq0 + gr, row1 = row0 + 8;
  const long lrow = ((long)bi * h + hi) * sq;
  const float l0 = row0 < sq ? lse[lrow + row0] * LOG2E : 0.f;
  const float l1 = row1 < sq ? lse[lrow + row1] * LOG2E : 0.f;
  const float d0 = row0 < sq ? dsum[lrow + row0] : 0.f;
  const float d1 = row1 < sq ? dsum[lrow + row1] : 0.f;

  load_tile<D, T_ROWS, T_THREADS>(sQ, q + qoff, q_row, q0, sq, tid);
  load_tile<D, T_ROWS, T_THREADS>(sdO, dout + qoff, q_row, q0, sq, tid);
  load_tile<D, T_BK, T_THREADS>(sK, kb, kv_row, 0, sk, tid);
  load_tile<D, T_BK, T_THREADS>(sV, vb, kv_row, 0, sk, tid);
  cp_async_commit();

  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int j = 0; j < ntile; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < ntile) {
      const int nxt = (j + 1) & 1;
      load_tile<D, T_BK, T_THREADS>(sK + nxt * T_BK * DP, kb, kv_row, (j + 1) * T_BK, sk, tid);
      load_tile<D, T_BK, T_THREADS>(sV + nxt * T_BK * DP, vb, kv_row, (j + 1) * T_BK, sk, tid);
    }
    cp_async_commit();

    const int k0 = j * T_BK;
    if (!warp_live || (causal && k0 > wq0 + 15 + q_offset)) continue;
    const bf16* cK = sK + (j & 1) * T_BK * DP;
    const bf16* cV = sV + (j & 1) * T_BK * DP;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      load_a<DP>(qa, sQ, warp * 16, kk, lane);
      load_a<DP>(ga, sdO, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_b<DP>(b, cK, np * 16, kk, lane);
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        load_b<DP>(b, cV, np * 16, kk, lane);
        mma_bf16(dp[2 * np], ga, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ga, b[2], b[3]);
      }
    }

    // dS = P (dP - D) into s; masked entries are 0
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * tq + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = row < sq && key < sk && (!causal || key <= row + q_offset);
        const float p = ok ? ex2(fmaf(s[nb][e], scale_log2, e < 2 ? -l0 : -l1)) : 0.f;
        s[nb][e] = p * (dp[nb][e] - (e < 2 ? d0 : d1));
      }

    // dQ += dS K, dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t b[4];
        load_b_trans<DP>(b, cK, np * 16, kk, lane);
        mma_bf16(acc[2 * np], da, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], da, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * tq;
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + (long)row0 * q_row + c) =
          __floats2bfloat162_rn(acc[nb][0] * scale, acc[nb][1] * scale);
    if (row1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + (long)row1 * q_row + c) =
          __floats2bfloat162_rn(acc[nb][2] * scale, acc[nb][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
int launch_dot(const void* o, const void* dout, float* dsum, int b, int sq, int h, int d,
               cudaStream_t s) {
  const long rows = (long)b * sq * h;
  const int blocks = (int)((rows * 32 + 255) / 256);
  flash_bwd_dot_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, rows, sq, h, d);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* dsum, void* dq, void* dk, void* dv, int b, int sq,
               int sk, int h, int kvh, float scale, int causal, cudaStream_t s) {
  int rc = launch_dot<float>(o, dout, dsum, b, sq, h, D, s);
  if (rc) return rc;
  const size_t kv_smem = f32_dkdv_smem<D>(), q_smem = f32_dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  flash_bwd_dkdv_f32_kernel<D><<<dim3((sk + FB - 1) / FB, kvh, b), F_THREADS, kv_smem, s>>>(
      fq, fk, fv, fdo, lse, dsum, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, h,
      kvh, scale, causal);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  flash_bwd_dq_f32_kernel<D><<<dim3((sq + FB - 1) / FB, h, b), F_THREADS, q_smem, s>>>(
      fq, fk, fv, fdo, lse, dsum, static_cast<float*>(dq), sq, sk, h, kvh, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* dsum, void* dq, void* dk, void* dv, int b, int sq,
                int sk, int h, int kvh, float scale, int causal, cudaStream_t s) {
  int rc = launch_dot<bf16>(o, dout, dsum, b, sq, h, D, s);
  if (rc) return rc;
  const size_t kv_smem = dkdv_bf16_smem<D>(), q_smem = dq_bf16_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bdo = static_cast<const bf16*>(dout);
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dkdv_bf16_kernel<D>
      <<<dim3(kvh, b, (sk + T_ROWS - 1) / T_ROWS), T_THREADS, kv_smem, s>>>(
          bq, bk, bv, bdo, lse, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
          h, kvh, scale_log2, scale, causal);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  flash_bwd_dq_bf16_kernel<D>
      <<<dim3(h, b, (sq + T_ROWS - 1) / T_ROWS), T_THREADS, q_smem, s>>>(
          bq, bk, bv, bdo, lse, dsum, static_cast<bf16*>(dq), sq, sk, h, kvh, scale_log2,
          scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq, void* dk, void* dv,
           int b, int sq, int sk, int h, int kvh, float scale, int causal, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, sk, h, kvh,
                                  scale, causal, s)
                 : launch_f32<D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, sk, h, kvh,
                                 scale, causal, s);
}

}  // namespace

// q, o, dout, dq (b, sq, h, d); k, v, dk, dv (b, sk, kvh, d), all contiguous,
// of one dtype: bf16 when is_bf16 (the tensor-core route; 16-byte aligned),
// else f32; lse f32 (b, h, sq), the forward's; dsum f32 (b, h, sq) scratch,
// written here.  Three launches (D, dK/dV, dQ) on the stream; returns
// cudaGetLastError().
extern "C" int gf_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dsum, void* dq, void* dk, void* dv, int b,
                                      int sq, int sk, int h, int kvh, int d, int is_bf16,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  switch (d) {
    case 16: return launch<16>(is_bf16, q, k, v, o, dout, l, ds, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    case 64: return launch<64>(is_bf16, q, k, v, o, dout, l, ds, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    case 80: return launch<80>(is_bf16, q, k, v, o, dout, l, ds, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    case 128: return launch<128>(is_bf16, q, k, v, o, dout, l, ds, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
