// Split-K flash-decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel (the
//   Pallas TPU kernel behind decode_attention, kernel.py:65).  Same function:
//   one query token per (batch, head) against a (b, S, kv, d) cache; the GQA
//   group of H / KV query heads shares one K/V read; cache_len[b] masks the
//   tail, and entries at or past it never contribute (their K is not read,
//   their V is zero-filled), so a stale or garbage tail is ignored; float32
//   online softmax; output acc / max(l, 1e-30) in the input dtype.
// Yardstick (timed beside it, never on the path): one call of
//   torch.nn.functional.scaled_dot_product_attention with a boolean mask
//   built from cache_len.
// Bound on an H100: it reads the live cache once.  At b=8, S=2176 with 2,112
//   live entries, 32 kv heads of 80 in bf16 that is ~173 MB a call, ~52 us at
//   3.35 TB/s; its FLOPs are ~4 per cache byte, far below the tensor-core
//   ridge, so the only lever is bytes in flight.
//
// Both routes run one CTA of 128 threads per (split, kv head, batch row):
//   b x kv CTAs alone (256 at b=8) would underfill 132 SMs, so the cache is
//   cut into splits, sized by the wrapper's plan (kernel.py::plan_splits) so
//   that the grid fills the card several times over; splits past cache_len
//   exit at once.  Each writes a partial (m, l, acc) per head of the group,
//   m in natural-log units; a second launch merges a (batch, head)'s live
//   splits by log-sum-exp (fusing it into the first through an atomic
//   ticket, the last split merging, measured no faster: the merge then sits
//   at the end of the critical path).
//
// bf16 (every main path): the group's queries are the A operand of
//   mma.sync.m16n8k16 (HMMA), padded to 16 rows, their fragments loaded once
//   by ldmatrix.  K and V stay bf16 in a 3-stage shared-memory ring of
//   64-key tiles filled by 16-byte cp.async (LDGSTS), neighbouring threads
//   on neighbouring 16 B of a row; keys past the split's end are
//   zero-filled, not read.  The next tile's copy is in flight during this
//   tile's math, and one barrier a tile guards the ring.  Every warp owns 16
//   keys of each tile and keeps its own (m, l, acc) for the group in
//   registers: S = Q K^T on the tensor cores, the online softmax on the
//   fragments (exp2f), P split in registers into a bf16 hi and lo part, the
//   A operands of two P V products (so P keeps f32 precision, at no cost to
//   a kernel bound by memory), V read by ldmatrix.trans.  The 4 warps merge once, at the end of the
//   split, through shared memory.  Rows are padded to D + 8 elements, so an
//   ldmatrix's 8 rows fall on distinct banks.
// f32: the CUDA-core kernel of the port's first design: a thread per key
//   dots its K row with the group's queries, one warp per head takes the
//   tile's softmax, V staged in shared memory as f32; tensor-core products
//   in bf16 or TF32 would miss the f32 tolerance of 2e-5.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAXG = 16;     // largest GQA group
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float from_f(float v, float*) { return v; }
__device__ __forceinline__ bf16 from_f(float v, bf16*) { return __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int DT = 128;      // threads per CTA, and keys per tile

size_t f32_smem(int g, int d) {
  return sizeof(float) * ((size_t)g * d + (size_t)DT * d + (size_t)g * DT + 3 * (size_t)g);
}

template <int D>
__global__ void __launch_bounds__(DT)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                  const float* __restrict__ vc, const int* __restrict__ cache_len,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int S, int h, int kvh, int split,
                  int nsplit, float scale) {
  constexpr int MAXO = MAXG * D / DT + 1;   // outputs per thread, upper bound
  const int si = blockIdx.x, kvi = blockIdx.y, bi = blockIdx.z;
  const int g = h / kvh;
  const int len = min(max(cache_len[bi], 0), S);
  const int start = si * split;
  if (start >= len) return;                 // this split lies past the live cache
  const int end = min(start + split, len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* sq = smem;              // (g, D) the group's queries
  float* sV = sq + g * D;        // (DT, D) V tile
  float* sP = sV + DT * D;       // (g, DT) scores, then probabilities
  float* sm = sP + g * DT;       // (g) running max
  float* sl = sm + g;            // (g) running sum
  float* sa = sl + g;            // (g) this tile's rescale factor

  const float* qb = q + ((long)bi * h + (long)kvi * g) * D;
  for (int idx = tid; idx < g * D; idx += DT) sq[idx] = qb[idx];
  if (tid < g) { sm[tid] = NEG_INF; sl[tid] = 0.f; }

  float acc[MAXO];
#pragma unroll
  for (int r = 0; r < MAXO; ++r) acc[r] = 0.f;

  const long row = (long)kvh * D;
  const float* kb = kc + (long)bi * S * row + (long)kvi * D;
  const float* vb = vc + (long)bi * S * row + (long)kvi * D;

  for (int k0 = start; k0 < end; k0 += DT) {
    __syncthreads();   // queries staged; the previous tile's readers are done
    const int nk = min(DT, end - k0);
    for (int idx = tid; idx < DT * (D / 4); idx += DT) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      const float4 f = r < nk ? *reinterpret_cast<const float4*>(vb + (long)(k0 + r) * row + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      sV[r * D + c] = f.x;
      sV[r * D + c + 1] = f.y;
      sV[r * D + c + 2] = f.z;
      sV[r * D + c + 3] = f.w;
    }
    float s[MAXG];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) s[gi] = 0.f;
    const bool valid = tid < nk;
    if (valid) {
      const float* kr = kb + (long)(k0 + tid) * row;
      for (int c = 0; c < D; c += 4) {
        const float4 f = *reinterpret_cast<const float4*>(kr + c);
        const float kv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi < g) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[gi] = fmaf(sq[gi * D + c + e], kv[e], s[gi]);
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi)
      if (gi < g) sP[gi * DT + tid] = valid ? s[gi] * scale : NEG_INF;
    __syncthreads();

    // one warp per head: tile max, probabilities, sum, online update
    for (int gi = warp; gi < g; gi += DT / 32) {
      float x[DT / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int r = 0; r < DT / 32; ++r) {
        x[r] = sP[gi * DT + lane + 32 * r];
        mx = fmaxf(mx, x[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < DT / 32; ++r) {
        const int j = lane + 32 * r;
        const float p = j < nk ? expf(x[r] - m_new) : 0.f;
        sP[gi * DT + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sa[gi] = alpha;
        sl[gi] = alpha * sl[gi] + sum;
        sm[gi] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
      const int o = tid + DT * r;
      if (o < g * D) {
        const int gi = o / D, c = o % D;
        float a = acc[r] * sa[gi];
        const float* pp = sP + gi * DT;
        for (int j = 0; j < nk; ++j) a = fmaf(pp[j], sV[j * D + c], a);
        acc[r] = a;
      }
    }
  }

  const long head0 = (long)bi * h + (long)kvi * g;
#pragma unroll
  for (int r = 0; r < MAXO; ++r) {
    const int o = tid + DT * r;
    if (o < g * D) {
      const int gi = o / D, c = o % D;
      part_acc[((head0 + gi) * nsplit + si) * D + c] = acc[r];
    }
  }
  if (tid < g) {
    part_m[(head0 + tid) * nsplit + si] = sm[tid];
    part_l[(head0 + tid) * nsplit + si] = sl[tid];
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), a 3-stage cp.async ring, warps
// that each own their keys
// ---------------------------------------------------------------------------

constexpr int TILE = 64;        // keys a stage: 16 for each warp
constexpr int STAGES = 3;
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !in (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats (a in the low half: the lower column) as bf16x2 pairs hi and
// lo with hi + lo = (a, b) to ~2^-17 relative: hi their rounding, lo its
// remainder rounded
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// TILE rows of D bf16 (row r at src + (r0 + r) * pitch) into a shared tile of
// pitch D + 8; rows at or past rmax are zero-filled and not read
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long pitch, int r0,
                                          int rmax, int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
  constexpr int N = TILE * CPR;
#pragma unroll
  for (int i = 0; i < (N + TC_THREADS - 1) / TC_THREADS; ++i) {
    const int idx = tid + i * TC_THREADS;
    if (N % TC_THREADS && idx >= N) break;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool in = r0 + r < rmax;
    const bf16* s = in ? src + (long)(r0 + r) * pitch + c : src;
    cp_async16(smem_u32(dst + r * (D + 8) + c), s, in);
  }
}

// the K/V ring and the 16 query rows; the warps' merge reuses the ring
template <int D>
constexpr size_t bf16_smem() {
  return sizeof(bf16) * (size_t)(D + 8) * (2 * STAGES * TILE + 16);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                   const bf16* __restrict__ vc, const int* __restrict__ cache_len,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int S, int h, int kvh, int split,
                   int nsplit, float scale_log2) {
  constexpr int DP = D + 8;    // row pitch in shared memory, elements
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NB = D / 8;    // n-blocks of P V
  static_assert(sizeof(float) * TC_WARPS * 16 * (D + 2) <= sizeof(bf16) * DP * 2 * STAGES * TILE,
                "the merge scratch must fit in the ring");
  const int si = blockIdx.x, kvi = blockIdx.y, bi = blockIdx.z;
  const int grp = h / kvh;
  const int len = min(max(cache_len[bi], 0), S);
  const int start = si * split;
  if (start >= len) return;                 // this split lies past the live cache
  const int end = min(start + split, len);
  const int ntile = (end - start + TILE - 1) / TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row and column pair

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][TILE][DP]
  bf16* sV = sK + STAGES * TILE * DP;             // [STAGES][TILE][DP]
  bf16* sQ = sV + STAGES * TILE * DP;             // [16][DP], rows >= grp zero

  const long row = (long)kvh * D;
  const bf16* kb = kc + (long)bi * S * row + (long)kvi * D;
  const bf16* vb = vc + (long)bi * S * row + (long)kvi * D;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntile) {
      load_tile<D>(sK + st * TILE * DP, kb, row, start + st * TILE, end, tid);
      load_tile<D>(sV + st * TILE * DP, vb, row, start + st * TILE, end, tid);
    }
    cp_async_commit();
  }
  const bf16* qb = q + ((long)bi * h + (long)kvi * grp) * D;
  for (int idx = tid; idx < 16 * D; idx += TC_THREADS) {
    const int r = idx / D, c = idx % D;
    sQ[r * DP + c] = r < grp ? qb[r * D + c] : __float2bfloat16(0.f);
  }

  uint32_t qf[KS][4];
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<STAGES - 2>();   // tile t has landed for this thread
    __syncthreads();               // ... for every thread; tile t - 1's stage is free
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk], smem_u32(sQ + r * DP + c));
      }
    }
    const int nxt = t + STAGES - 1;
    if (nxt < ntile) {
      const int st = nxt % STAGES;
      load_tile<D>(sK + st * TILE * DP, kb, row, start + nxt * TILE, end, tid);
      load_tile<D>(sV + st * TILE * DP, vb, row, start + nxt * TILE, end, tid);
    }
    cp_async_commit();

    const int kw0 = start + t * TILE + warp * 16;   // this warp's first key
    if (kw0 >= end) continue;
    const bf16* cK = sK + (t % STAGES) * TILE * DP + warp * 16 * DP;
    const bf16* cV = sV + (t % STAGES) * TILE * DP + warp * 16 * DP;

    // S = Q K^T over the warp's 16 keys: 2 n-blocks of 8
    float s[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];
      const int r = (lane & 7) + (lane >> 4) * 8;
      const int c = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(b, smem_u32(cK + r * DP + c));
      mma_bf16(s[0], qf[kk], b[0], b[1]);
      mma_bf16(s[1], qf[kk], b[2], b[3]);
    }
    if (kw0 + 16 > end) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kw0 + nb * 8 + 2 * tq + (e & 1) >= end) s[nb][e] = NEG_INF;
    }

    // online softmax on the fragments (scores in the log2 domain)
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      s[nb][0] = exp2f(fmaf(s[nb][0], scale_log2, -mn0));
      s[nb][1] = exp2f(fmaf(s[nb][1], scale_log2, -mn0));
      s[nb][2] = exp2f(fmaf(s[nb][2], scale_log2, -mn1));
      s[nb][3] = exp2f(fmaf(s[nb][3], scale_log2, -mn1));
    }
    l0 = alpha0 * l0 + (s[0][0] + s[0][1] + s[1][0] + s[1][1]);
    l1 = alpha1 * l1 + (s[0][2] + s[0][3] + s[1][2] + s[1][3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      acc[nb][0] *= alpha0;
      acc[nb][1] *= alpha0;
      acc[nb][2] *= alpha1;
      acc[nb][3] *= alpha1;
    }

    // O += P V: P's accumulator fragments are P V's A operand, as a bf16
    // hi and lo part, so that P keeps f32 precision (the memory bounds
    // this kernel; the second product costs no time)
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = np * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(b, smem_u32(cV + r * DP + c));
      mma_bf16(acc[2 * np], ph, b[0], b[1]);
      mma_bf16(acc[2 * np], pl, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], ph, b[2], b[3]);
      mma_bf16(acc[2 * np + 1], pl, b[2], b[3]);
    }
  }

  // merge the 4 warps' (m, l, acc) through shared memory, once a split
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  cp_async_wait<0>();
  __syncthreads();               // every warp is done with the ring
  float* wm = reinterpret_cast<float*>(smem_raw);   // [TC_WARPS][16]
  float* wl = wm + TC_WARPS * 16;                   // [TC_WARPS][16]
  float* wa = wl + TC_WARPS * 16;                   // [TC_WARPS][16][D]
  if (tq == 0) {
    wm[warp * 16 + gr] = m0;
    wm[warp * 16 + gr + 8] = m1;
    wl[warp * 16 + gr] = l0;
    wl[warp * 16 + gr + 8] = l1;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * tq;
    float* a0 = wa + (warp * 16 + gr) * D + c;
    float* a1 = a0 + 8 * D;
    a0[0] = acc[nb][0];
    a0[1] = acc[nb][1];
    a1[0] = acc[nb][2];
    a1[1] = acc[nb][3];
  }
  __syncthreads();
  const long head0 = (long)bi * h + (long)kvi * grp;
  for (int o = tid; o < grp * D; o += TC_THREADS) {
    const int r = o / D, c = o % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) M = fmaxf(M, wm[w * 16 + r]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float f = exp2f(wm[w * 16 + r] - M);   // 0 for a warp that saw no key
      L = fmaf(wl[w * 16 + r], f, L);
      a = fmaf(wa[(w * 16 + r) * D + c], f, a);
    }
    part_acc[((head0 + r) * nsplit + si) * D + c] = a;
    if (c == 0) {
      part_m[(head0 + r) * nsplit + si] = M * LN2;   // natural-log units
      part_l[(head0 + r) * nsplit + si] = L;
    }
  }
}

// ---------------------------------------------------------------------------
// combine, launch
// ---------------------------------------------------------------------------

// one CTA of D threads per (head, batch row): merge the live splits
template <typename T, int D>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      const int* __restrict__ cache_len,
                                      T* __restrict__ out, int S, int h, int split,
                                      int nsplit) {
  const int hi = blockIdx.x, bi = blockIdx.y, c = threadIdx.x;
  const int len = min(max(cache_len[bi], 0), S);
  const int live = (len + split - 1) / split;
  const long base = ((long)bi * h + hi) * nsplit;
  float M = NEG_INF;
  for (int s = 0; s < live; ++s) M = fmaxf(M, part_m[base + s]);
  float L = 0.f, a = 0.f;
  for (int s = 0; s < live; ++s) {
    const float w = expf(part_m[base + s] - M);
    L = fmaf(part_l[base + s], w, L);
    a = fmaf(part_acc[(base + s) * D + c], w, a);
  }
  out[((long)bi * h + hi) * D + c] = from_f(a / fmaxf(L, 1e-30f), (T*)nullptr);
}

template <int D>
int launch(int is_bf16, const void* q, const void* kc, const void* vc, const int* lens,
           float* pm, float* pl, float* pa, void* out, int b, int S, int h, int kvh,
           int split, float scale, cudaStream_t stream) {
  const int nsplit = (S + split - 1) / split;
  const dim3 grid(nsplit, kvh, b);
  cudaError_t err;
  if (is_bf16) {
    const size_t smem = bf16_smem<D>();
    err = cudaFuncSetAttribute(decode_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_bf16_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
        static_cast<const bf16*>(vc), lens, pm, pl, pa, S, h, kvh, split, nsplit,
        scale * LOG2E);
  } else {
    const size_t smem = f32_smem(h / kvh, D);
    err = cudaFuncSetAttribute(decode_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_f32_kernel<D><<<grid, DT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kc),
        static_cast<const float*>(vc), lens, pm, pl, pa, S, h, kvh, split, nsplit, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    decode_combine_kernel<bf16, D><<<dim3(h, b), D, 0, stream>>>(
        pm, pl, pa, lens, static_cast<bf16*>(out), S, h, split, nsplit);
  else
    decode_combine_kernel<float, D><<<dim3(h, b), D, 0, stream>>>(
        pm, pl, pa, lens, static_cast<float*>(out), S, h, split, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the partial pass for a group of g heads of d.
extern "C" size_t gf_decode_smem(int g, int d, int is_bf16) {
  if (!is_bf16) return f32_smem(g, d);
  switch (d) {
    case 16: return bf16_smem<16>();
    case 64: return bf16_smem<64>();
    case 80: return bf16_smem<80>();
    case 128: return bf16_smem<128>();
    default: return 0;
  }
}

// q (b, 1, h, d), caches (b, S, kvh, d) contiguous and 16-byte aligned, of one
// dtype (bf16 when is_bf16: the tensor-core route; else f32); cache_len (b,)
// int32; workspace part_m/part_l (b, h, nsplit) and part_acc (b, h, nsplit, d)
// float32 with nsplit = ceil(S / split); out (b, 1, h, d).  Returns
// cudaGetLastError().
extern "C" int gf_decode_attention(const void* q, const void* kc, const void* vc,
                                   const void* cache_len, void* part_m,
                                   void* part_l, void* part_acc, void* out, int b,
                                   int S, int h, int kvh, int d, int split,
                                   int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(cache_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  switch (d) {
    case 16: return launch<16>(is_bf16, q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    case 64: return launch<64>(is_bf16, q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    case 80: return launch<80>(is_bf16, q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    case 128: return launch<128>(is_bf16, q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
