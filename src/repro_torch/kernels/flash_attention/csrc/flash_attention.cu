// Flash attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_flash_kernel (the
//   Pallas TPU kernel behind flash_attention, kernel.py:77).  Same function:
//   blocked online softmax in float32 over bf16 or f32 inputs, GQA (query
//   head h reads kv head h / (H / KV)), causal masking aligned bottom-right
//   (query i sees keys <= i + sk - sq), key tiles wholly above that diagonal
//   skipped, masked scores set to -1e30 (not -inf), output acc / max(l, 1e-30)
//   cast to the input dtype.  Any sq and sk: ragged tiles are masked here, so
//   the reference's divisibility limits do not apply.
// Yardstick (timed beside it, never on the path): one call of
//   torch.nn.functional.scaled_dot_product_attention(..., is_causal=True).
// Bound on an H100: at the shared block's shape (b=8, s=2048, 32 heads of
//   80) a causal call does ~1.7e11 FLOP, ~0.17 ms at the 989 TFLOP/s bf16
//   tensor-core rate; its bytes (q, k, v, o: 4 x 84 MB) take ~0.1 ms.  So
//   it is bound by the tensor cores' operations.
//
// Two routes, picked by the wrapper from the dtype before the launch:
//
// bf16 (every main path): tensor cores.  A CTA owns 128 query rows of one
//   (batch, head) and walks 64-key tiles.  Up to D = 80 it is 4 warps of two
//   m16 tiles (32 rows) each, so that each K and V fragment read from
//   shared memory feeds twice the products, with registers capped for two
//   CTAs an SM; at D = 128 the accumulators of two tiles would spill, so 8
//   warps of one tile and one CTA an SM.  Both products are
//   mma.sync.m16n8k16 bf16 -> f32 (HMMA): a bf16 product is exact in f32,
//   so S = Q K^T is the reference's f32 dot of the upcast inputs up to the
//   order of summation.  Q, K and V stay bf16 in shared memory, K and V in a
//   2-stage ring filled by 16-byte cp.async (LDGSTS); the next tile's copy
//   is issued before this tile's math, and one barrier a tile guards the
//   ring.  Q's fragments are reloaded by ldmatrix at each k-step, which
//   leaves the registers to S and O (Q held in registers as well spilled).
//   Rows are padded to D + 8 elements, so the 8 row addresses of an
//   ldmatrix fall on distinct banks.  The online softmax runs on the
//   accumulator fragments: a row's max over the 4 lanes of a quad by two
//   shuffles, ex2.approx (one MUFU.EX2) with scale * log2(e) folded into one
//   FMA, the row sums kept per lane and reduced once at the end.  P stays
//   in registers: the m16n8k16 accumulator layout maps pairwise onto the A
//   operand, so P is rounded to bf16 and fed to P V directly, V read by
//   ldmatrix.trans.  That rounding is the route's one change of precision
//   against the reference (each term off by at most 2^-9 relative; the
//   output is bf16 anyway).  Only tiles that cross the diagonal or the
//   ragged edge are masked, a warp whose rows see none of a tile skips it,
//   and under the causal mask the q tiles with the most key tiles launch
//   first.  Left for later: wgmma with TMA and a producer warp, the softmax
//   overlapped with the next tile's products, a persistent grid.
// f32: the CUDA-core kernel of the port's first design, one CTA of 256
//   threads per 64-query tile, K and V staged as f32; bf16 or TF32 products
//   cannot meet the f32 tolerance of 2e-5, and no main path runs attention
//   in f32.
// Both routes take an optional lse buffer, f32 (b, h, sq): when the wrapper
//   passes one (a gradient will be taken), each row's log-sum-exp of the
//   scaled scores is written there in natural log, (m + log2 l) ln 2 on the
//   bf16 route; the backward kernels (flash_attention_bwd.cu) recompute P
//   from it.  With a null pointer nothing more is written.  The device
//   helpers the two files share are in flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int h, int kvh, float scale,
                     int causal) {
  constexpr int DP = D + 1;       // padded row pitch: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int DPT = D / 16;     // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * DP;

  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvi = hi / (h / kvh);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long q_row = (long)h * D;     // elements between consecutive positions
  const long kv_row = (long)kvh * D;
  const float* qb = q + (long)bi * sq * q_row + (long)hi * D;
  const float* kb = k + (long)bi * sk * kv_row + (long)kvi * D;
  const float* vb = v + (long)bi * sk * kv_row + (long)kvi * D;
  float* ob = o + (long)bi * sq * q_row + (long)hi * D;
  const int q_offset = sk - sq;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    sQ[r * DP + c] = qi < sq ? qb[(long)qi * q_row + c] : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // keys this q tile can see: all of them, or (causal) up to the last
  // row's diagonal; tiles past it are skipped
  int k_end = sk;
  if (causal) {
    const int q_last = min(q0 + BQ, sq) - 1;
    k_end = min(sk, q_last + q_offset + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < sk;
      sK[r * DP + c] = in ? kb[(long)kj * kv_row + c] : 0.f;
      sV[r * DP + c] = in ? vb[(long)kj * kv_row + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < sk && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: xor offsets < 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int nk = min(BK, sk - k0);
    for (int j = 0; j < nk; ++j) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = sV[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) ob[(long)qi * q_row + tx + 16 * c] = acc[i][c] / den;
    // the row's log-sum-exp of the scaled scores, natural log
    if (lse != nullptr && tx == 0) lse[((long)bi * h + hi) * sq + qi] = m[i] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), cp.async ring, P in registers
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64;        // keys per tile

// The CTA's shape at head_dim D: MT m16 tiles (16 query rows each) a warp,
// WARPS warps, MIN_BLOCKS CTAs an SM for the register budget.  Two tiles
// a warp let each K and V fragment feed twice the products; at D = 128
// their accumulators would spill, so one tile and 8 warps.  Either way a
// CTA holds 128 query rows.
template <int D>
struct TcShape {
  static constexpr int MT = D <= 80 ? 2 : 1;
  static constexpr int WARPS = D <= 80 ? 4 : 8;
  static constexpr int MIN_BLOCKS = D <= 80 ? 2 : 1;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;   // query rows a CTA
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (size_t)(D + 8) * (TcShape<D>::BQ + 4 * TC_BK);   // Q, 2 x (K, V)
}

template <int D>
__global__ void __launch_bounds__(TcShape<D>::THREADS, TcShape<D>::MIN_BLOCKS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int h, int kvh,
                      float scale_log2, int causal) {
  using Shape = TcShape<D>;
  constexpr int MT = Shape::MT, THREADS = Shape::THREADS, BQ = Shape::BQ;
  constexpr int DP = D + 8;    // row pitch in shared memory, elements
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NB = D / 8;    // n-blocks of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * DP;             // [2][TC_BK][DP]
  bf16* sV = sK + 2 * TC_BK * DP;      // [2][TC_BK][DP]

  // heaviest first: under the causal mask the last q tile sees the most keys
  const int qt = causal ? (int)gridDim.z - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int hi = blockIdx.x, bi = blockIdx.y;
  const int kvi = hi / (h / kvh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;   // fragment row and column pair
  const long q_row = (long)h * D, kv_row = (long)kvh * D;
  const bf16* qb = q + (long)bi * sq * q_row + (long)hi * D;
  const bf16* kb = k + (long)bi * sk * kv_row + (long)kvi * D;
  const bf16* vb = v + (long)bi * sk * kv_row + (long)kvi * D;
  bf16* ob = o + (long)bi * sq * q_row + (long)hi * D;
  const int q_offset = sk - sq;

  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + BQ, sq) + q_offset);
  const int ntile = (k_end + TC_BK - 1) / TC_BK;

  const int wq0 = q0 + warp * 16 * MT;       // the warp's first row
  const bool warp_live = wq0 < sq;

  load_tile<D, BQ, THREADS>(sQ, qb, q_row, q0, sq, tid);
  load_tile<D, TC_BK, THREADS>(sK, kb, kv_row, 0, sk, tid);
  load_tile<D, TC_BK, THREADS>(sV, vb, kv_row, 0, sk, tid);
  cp_async_commit();

  // per m16 tile mt: rows wq0 + 16 mt + gr (the lane's first row) and + 8
  float acc[MT][NB][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;
  }

  for (int j = 0; j < ntile; ++j) {
    cp_async_wait<0>();   // tile j (and Q) has landed for this thread
    __syncthreads();      // ... for every thread; stage (j + 1) & 1 is free
    if (j + 1 < ntile) {
      const int nxt = (j + 1) & 1;
      load_tile<D, TC_BK, THREADS>(sK + nxt * TC_BK * DP, kb, kv_row, (j + 1) * TC_BK, sk, tid);
      load_tile<D, TC_BK, THREADS>(sV + nxt * TC_BK * DP, vb, kv_row, (j + 1) * TC_BK, sk, tid);
    }
    cp_async_commit();

    const int k0 = j * TC_BK;
    // every row of this warp is padding, or above the diagonal of this tile
    if (!warp_live || (causal && k0 > wq0 + 16 * MT - 1 + q_offset)) continue;
    const bf16* cK = sK + (j & 1) * TC_BK * DP;
    const bf16* cV = sV + (j & 1) * TC_BK * DP;

    // S = Q K^T: per m16 tile 8 n-blocks of 8 keys, 4 f32 each; each K
    // fragment feeds the warp's MT tiles
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];   // Q's A fragments, reloaded: registers go to S and O
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<DP>(qa[mt], sQ, (warp * MT + mt) * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_b<DP>(b, cK, np * 16, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
        }
      }
    }

    // mask only a tile that crosses the ragged edge or this warp's diagonal
    const bool edge = k0 + TC_BK > sk || (causal && k0 + TC_BK - 1 > wq0 + q_offset);
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + nb * 8 + 2 * tq + (e & 1);
            const int pos = wq0 + 16 * mt + gr + (e < 2 ? 0 : 8) + q_offset;
            if (key >= sk || (causal && key > pos)) s[mt][nb][e] = NEG_INF;
          }
    }

    // online softmax on the fragments (scores in the log2 domain)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][nb][0], s[mt][nb][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][nb][2], s[mt][nb][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[mt][0], mx0 * scale_log2);
      const float mn1 = fmaxf(m[mt][1], mx1 * scale_log2);
      const float alpha0 = ex2(m[mt][0] - mn0), alpha1 = ex2(m[mt][1] - mn1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        s[mt][nb][0] = ex2(fmaf(s[mt][nb][0], scale_log2, -mn0));
        s[mt][nb][1] = ex2(fmaf(s[mt][nb][1], scale_log2, -mn0));
        s[mt][nb][2] = ex2(fmaf(s[mt][nb][2], scale_log2, -mn1));
        s[mt][nb][3] = ex2(fmaf(s[mt][nb][3], scale_log2, -mn1));
        sum0 += s[mt][nb][0] + s[mt][nb][1];
        sum1 += s[mt][nb][2] + s[mt][nb][3];
      }
      l[mt][0] = alpha0 * l[mt][0] + sum0;   // this lane's share of the row sum
      l[mt][1] = alpha1 * l[mt][1] + sum1;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[mt][nb][0] *= alpha0;
        acc[mt][nb][1] *= alpha0;
        acc[mt][nb][2] *= alpha1;
        acc[mt][nb][3] *= alpha1;
      }
    }

    // O += P V: P's accumulator fragments are P V's A operand, in bf16;
    // each V fragment feeds the warp's MT tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t b[4];
        load_b_trans<DP>(b, cV, np * 16, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], pa[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], pa[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int row0 = wq0 + 16 * mt + gr, row1 = row0 + 8;
    // the row's log-sum-exp of the scaled scores, natural log: m and the
    // sum are in the base-2 domain of scale_log2
    if (lse != nullptr && tq == 0) {
      float* lrow = lse + ((long)bi * h + hi) * sq;
      if (row0 < sq) lrow[row0] = (m[mt][0] + log2f(fmaxf(l0, 1e-30f))) * LN2;
      if (row1 < sq) lrow[row1] = (m[mt][1] + log2f(fmaxf(l1, 1e-30f))) * LN2;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * tq;
      if (row0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * q_row + c) =
            __floats2bfloat162_rn(acc[mt][nb][0] * inv0, acc[mt][nb][1] * inv0);
      if (row1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * q_row + c) =
            __floats2bfloat162_rn(acc[mt][nb][2] * inv1, acc[mt][nb][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int b,
               int sq, int sk, int h, int kvh, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, h, kvh, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                int sq, int sk, int h, int kvh, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, b, (sq + TcShape<D>::BQ - 1) / TcShape<D>::BQ);
  flash_fwd_bf16_kernel<D><<<grid, TcShape<D>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, sq, sk, h, kvh, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kvh, float scale, int causal, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, s)
                 : launch_f32<D>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, s);
}

}  // namespace

// Dynamic shared memory of a CTA for head_dim d on either route.
extern "C" size_t gf_flash_smem(int d, int is_bf16) {
  switch (d) {
    case 16: return is_bf16 ? bf16_smem_bytes<16>() : f32_smem_bytes<16>();
    case 64: return is_bf16 ? bf16_smem_bytes<64>() : f32_smem_bytes<64>();
    case 80: return is_bf16 ? bf16_smem_bytes<80>() : f32_smem_bytes<80>();
    case 128: return is_bf16 ? bf16_smem_bytes<128>() : f32_smem_bytes<128>();
    default: return 0;
  }
}

// q (b, sq, h, d), k/v (b, sk, kvh, d), o (b, sq, h, d), all contiguous, of
// one dtype: bf16 when is_bf16 (the tensor-core route; 16-byte aligned),
// else f32 (the CUDA-core route).  lse: null, or f32 (b, h, sq) that takes
// each row's log-sum-exp of the scaled scores (natural log), what the
// backward kernels read.  Returns cudaGetLastError().
extern "C" int gf_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int b, int sq, int sk, int h, int kvh,
                                  int d, int is_bf16, float scale, int causal,
                                  void* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 16: return launch<16>(is_bf16, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, s);
    case 64: return launch<64>(is_bf16, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, s);
    case 80: return launch<80>(is_bf16, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, s);
    case 128: return launch<128>(is_bf16, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
