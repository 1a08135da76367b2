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
//   masked here.  The gradients come back in the inputs' dtype, bitwise
//   the same from call to call.
// Yardstick (timed beside it, never on the path): torch.autograd.grad
//   through scaled_dot_product_attention(..., is_causal=True, enable_gqa=True).
// Bound on an H100: operations.  The backward does five products over the
//   (query, key) pairs the mask keeps, 2.5 times the forward's two: S and
//   dP = dO V^T (recomputed), then dV, dK and dQ.  At granite's microbatch
//   (b=2, s=4096, 32 heads of 64 over 8, causal) that is ~3.4e11 FLOP,
//   ~0.35 ms at the 989 TFLOP/s bf16 tensor-core rate, against ~0.03 ms
//   for its bytes.
//
// Routes, picked by the wrapper from the dtype and head_dim
// (kernel.py::bwd_plan):
// bf16 at head_dim 64 and 128 (the trainer's shapes): one pass, each of
//   the five products once, on wgmma (HGMMA), fed by TMA.  Three launches:
//   1. flash_bwd_prep_kernel: D = rowsum(dO * O) and lse * log2(e) into
//      padded (b, h, sq_pad) rows; the dQ accumulator and the counters
//      zeroed.
//   2. flash_bwd_sm90_bf16_kernel: a persistent grid (as many CTAs as fit
//      at once, one an SM) of 384 threads.  A work item is one (kv head,
//      batch, 128-key tile); the CTAs take items from an atomic counter in
//      ascending key-tile order, which under the causal mask is heaviest
//      first.  One producer thread (warpgroup 0, whose registers go to the
//      consumers through setmaxnreg) loads the item's K and V once and, for
//      each query tile that sees the keys (from the last down) and each
//      head of the group, that step's Q and dO tiles (TMA, 128-byte
//      swizzle, two 64-column boxes a row at head_dim 128, zero past the
//      end) and its lse and D rows (bulk copies) into a 2-stage ring, with
//      mbarrier full/empty pairs.  Two consumer warpgroups hold 64 keys
//      each.  Per step each computes S^T = K Q^T and dP^T = V dO^T (m64 x
//      BQ, A and B from shared memory), forms P^T = 2^(S^T scale log2e -
//      lse log2e) while dP^T is in flight (the mask only on the tiles it
//      cuts) and dS^T = P^T (dP^T - D), and issues dV += P^T dO and
//      dK += dS^T Q with A from registers (the f32 accumulator rounded to
//      bf16, as the forward rounds P; B MN-major through the descriptor's
//      transpose bit, so nothing is copied transposed).  While those run it
//      stores dS^T in bf16 to shared memory; then the two warpgroups share
//      it for dQ_part = dS K over the 128 keys, each taking half of the
//      BQ x d result, which they leave in shared memory (two buffers).  A
//      second thread of warpgroup 0, the dQ writer, adds each dQ_part into
//      an f32 accumulator with one bulk reduction (cp.reduce.async.bulk).
//      BQ, the queries a step, is 128 at head_dim 64 and 64 at 128, where
//      the dK and dV accumulators take 128 of a consumer's 232 registers.
//   3. flash_bwd_dq_out_kernel: dQ = bf16(acc * scale).
//   dQ is summed in a fixed order.  Each (batch, head, query tile) has a
//   counter; the writer adds key tile j's part only after it reads j
//   (tiles 0 .. j - 1 done), and counts it once the reduction has
//   completed.  Unordered adds would change the bits from run to run, and
//   the trainer's checks (a second call bitwise equal, a resumed run
//   bitwise equal) rely on them not changing.  The wait cannot deadlock: an
//   item waits only on items of lower index, handed out before it to CTAs
//   that are running; and as every item walks the query tiles from the last
//   down with the heads inside, key tile j + 1 walks a prefix of tile j's
//   steps and trails it.  Measured on an H100 (kernel_sweeps.py bwd with a
//   scratch copy that adds without waiting): the order costs ~1-2% of the
//   call; the reductions themselves cost ~24% at head_dim 128, less than
//   the two products a separate dQ kernel would recompute.
// bf16 at head_dim 16 and 80: FlashAttention-2's backward on
//   mma.sync.m16n8k16 (HMMA), 4 warps of 16 rows, in three kernels and no
//   atomics: flash_bwd_dot_kernel (D), flash_bwd_dkdv_* (one CTA per kv
//   head, batch and 64-key tile walking its group's query tiles: S^T,
//   dP^T, dV, dK) and flash_bwd_dq_* (one CTA per head, batch and 64-query
//   tile walking its key tiles: S, dP again, dQ); the streamed tiles
//   through a 2-stage cp.async ring.
// f32: CUDA cores, 256 threads (16 x 16) over 64 x 64 tiles staged in
//   shared memory as f32, the forward f32 route's scheme; no main path
//   trains in f32, the route exists for the f32 tolerance of 2e-5.
#include "flash_sm90.cuh"

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
// bf16 route at head_dim 16 and 80: tensor cores (mma.sync), cp.async ring
// ---------------------------------------------------------------------------

constexpr int T_THREADS = 128;   // 4 warps of 16 rows
constexpr int T_ROWS = 64;       // resident rows a CTA: keys (dK/dV) or queries (dQ)
constexpr int T_BK = 64;         // streamed keys a tile in dQ
constexpr int T_BQ = 64;         // streamed query rows a tile in dK/dV

template <int D>
constexpr size_t dkdv_bf16_smem() {
  return sizeof(bf16) * (size_t)(D + 8) * (2 * T_ROWS + 4 * T_BQ) + sizeof(float) * 4 * T_BQ;
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
  constexpr int BQ = T_BQ;
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
// bf16 route at head_dim 64 and 128: wgmma, TMA, a producer warp, one pass
// ---------------------------------------------------------------------------

template <int D>
struct Hop {
  static constexpr int BQ = D == 64 ? 128 : 64;   // queries a streamed tile
  static constexpr int BK = 128;                   // keys a work item, 64 a consumer warpgroup
  static constexpr int STAGES = 2;                 // Q / dO ring
  static constexpr int NBOX = D / 64;              // 64-column boxes a row
  static constexpr int THREADS = 384;              // producer, two consumer warpgroups
  static constexpr int KV_BYTES = BK * D * 2;      // one of K, V
  static constexpr int QT_BYTES = BQ * D * 2;      // one of Q, dO
  static constexpr int DS_BYTES = BK * BQ * 2;
  static constexpr int DQ_BYTES = BQ * D * 4;      // one f32 dQ_part
  static constexpr int ROW_BYTES = BQ * 4;         // one of a tile's lse, D
  static constexpr int STAGE_TX = 2 * QT_BYTES + 2 * ROW_BYTES;
  // shared memory, from a 1,024-byte aligned base: K, V [NBOX][BK][64];
  // Q, dO [STAGES][NBOX][BQ][64]; dS [BQ / 64][BK][64] (queries innermost);
  // dQ_part [2] (fragment order, see flash_bwd_dq_out_kernel); lse (base 2),
  // D [STAGES][BQ]; each stage's and each dQ_part's step [STAGES + 2][8];
  // barriers kv_full, kv_empty, full[STAGES], empty[STAGES], dq_full[2],
  // dq_empty[2]
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_BYTES;
  static constexpr int OFF_Q = OFF_V + KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * QT_BYTES;
  static constexpr int OFF_DQ = OFF_DS + DS_BYTES;
  static constexpr int OFF_L = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int OFF_DD = OFF_L + STAGES * ROW_BYTES;
  static constexpr int OFF_META = OFF_DD + STAGES * ROW_BYTES;
  static constexpr int OFF_BAR = OFF_META + (STAGES + 2) * 32;
  static constexpr int SMEM = OFF_BAR + 8 * (2 + 2 * STAGES + 4) + 1024;   // + alignment slack
};

// The scratch of one call, in 4-byte words from its start: lse * log2(e)
// and D, (b, h, sq_pad) each, zero past sq; the dQ accumulator, f32
// (b, h, sq_pad, d) with each query tile's BQ x d in the fragment order of
// flash_bwd_dq_out_kernel; one counter a (batch, head, query tile), then
// the work counter.  Other routes take D alone, (b, h, sq).
struct Workspace {
  long lse2, dsum, acc, cnt, n_cnt, words;
  int n_qt, sq_pad;
};

Workspace workspace(int b, int sq, int h, int d, int is_bf16) {
  Workspace w{};
  if (!(is_bf16 && (d == 64 || d == 128))) {
    w.words = (long)b * h * sq;
    return w;
  }
  const int bq = d == 64 ? Hop<64>::BQ : Hop<128>::BQ;
  w.n_qt = (sq + bq - 1) / bq;
  w.sq_pad = w.n_qt * bq;
  w.lse2 = 0;
  w.dsum = (long)b * h * w.sq_pad;
  w.acc = 2 * w.dsum;
  w.cnt = w.acc + (long)b * h * w.sq_pad * d;
  w.n_cnt = (long)b * h * w.n_qt + 1;
  w.words = w.cnt + w.n_cnt;
  return w;
}

struct HopArgs {
  const float* lse2;
  const float* dsum;
  float* acc;
  unsigned* cnt;
  unsigned* work;
  bf16* dk;
  bf16* dv;
  int b, sq, sk, h, kvh, sq_pad, n_qt, n_items, causal;
  float scale_log2, scale;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// Before the main kernel: lse (base 2) and D = rowsum(dO * O) over the
// padded (b, h, sq_pad) rows, one warp a row, zero past sq; the dQ
// accumulator zeroed (d words a row), and the counters.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ dsum, float* __restrict__ acc,
                      unsigned* __restrict__ cnt, int n_cnt, long rows, int sq, int sq_pad,
                      int h) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) cnt[i] = 0u;
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64)
    *reinterpret_cast<float2*>(acc + row * D + c) = make_float2(0.f, 0.f);
  const int s = (int)(row % sq_pad);
  const long bh = row / sq_pad;   // bi * h + hi
  if (s >= sq) {
    if (lane == 0) lse2[row] = dsum[row] = 0.f;
    return;
  }
  const long off = ((bh / h * sq + s) * h + bh % h) * D;
  float a = 0.f;
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 fo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + c));
    const float2 fd = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
    a = fmaf(fo.x, fd.x, a);
    a = fmaf(fo.y, fd.y, a);
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) a += __shfl_xor_sync(0xffffffffu, a, k);
  if (lane == 0) {
    lse2[row] = lse[bh * sq + s] * LOG2E;
    dsum[row] = a;
  }
}

// After it: dQ = bf16(acc * scale).  A query tile's BQ x d accumulator is
// stored as the consumers hold it: [warpgroup][warp][8-column block][lane]
// of 4 values (rows r, r + 8 of columns c, c + 1), so that a consumer
// stores 16 contiguous bytes a thread; one thread here takes one such 4.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_out_kernel(const float4* __restrict__ acc, bf16* __restrict__ dq, long n4, int sq,
                        int h, int n_qt, float scale) {
  constexpr int BQ = Hop<D>::BQ, T4 = BQ * D / 4;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const long tile = i / T4;
    const int r = (int)(i % T4);
    const int w = r >> 10, wp = (r >> 8) & 3, nb = (r >> 5) & 7, lane = r & 31;
    const int row = (int)(tile % n_qt) * BQ + (BQ == 128 ? w * 64 : 0) + wp * 16 + (lane >> 2);
    const int col = (BQ == 128 ? 0 : w * 64) + nb * 8 + 2 * (lane & 3);
    const long bh = tile / n_qt;   // bi * h + hi
    const float4 a = acc[i];
    bf16* p = dq + ((bh / h * sq + row) * h + bh % h) * D + col;
    if (row < sq)
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    if (row + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(p + 8L * h * D) =
          __floats2bfloat162_rn(a.z * scale, a.w * scale);
  }
}

// The main kernel: a persistent grid.  In warpgroup 0, thread 0 is the
// producer: it takes work items from the work counter in ascending order
// (item n is key tile n / (kvh b), kv head n % kvh, batch n % (kvh b) / kvh),
// loads the item's K and V once, then walks the query tiles that see the
// item's keys from the last down and, within each, the group's heads,
// loading each step's Q, dO, lse and D into the ring.  Thread 32 is the dQ
// writer: for each step's dQ_part that the consumers leave in shared
// memory it waits for the tile's counter, adds the part into the
// accumulator with one bulk reduction, and counts it.  Warpgroups 1 and 2
// are the consumers, 64 keys each.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_sm90_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do, const HopArgs a) {
  using C = Hop<D>;
  using namespace sm90;
  constexpr int NS = C::BQ / 2;     // S^T accumulator values a thread
  constexpr int QK = C::BQ / 16;    // k-steps over a tile's queries
  constexpr int DK = D / 16;        // k-steps over head_dim
  constexpr int FIRST = 1, LAST = 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  int* meta = reinterpret_cast<int*>(gbase + C::OFF_META);   // [STAGES][8]
  int* dq_meta = meta + C::STAGES * 8;                        // [2][8]
  const float* sL = reinterpret_cast<const float*>(gbase + C::OFF_L);
  const float* sDD = reinterpret_cast<const float*>(gbase + C::OFF_DD);
  const uint32_t kv_full = base + C::OFF_BAR, kv_empty = kv_full + 8;
  const uint32_t full0 = kv_full + 16, empty0 = full0 + 8 * C::STAGES;
  const uint32_t dq_full0 = empty0 + 8 * C::STAGES, dq_empty0 = dq_full0 + 16;
  const int tid = threadIdx.x, wg = tid / 128;
  const int q_off = a.sk - a.sq;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(dq_full0 + 8 * s, 256);
      mbar_init(dq_empty0 + 8 * s, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<40>();
    if (tid == 0) {
      // the producer
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_do);
      const int grp = a.h / a.kvh, per_tile = a.kvh * a.b;
      int st = 0, items = 0;
      uint32_t ph = 0;
      for (;;) {
        const int n = (int)atomicAdd(a.work, 1u);
        if (n >= a.n_items) {
          mbar_wait(empty0 + 8 * st, ph ^ 1);
          meta[st * 8] = -1;
          mbar_arrive(full0 + 8 * st);
          return;
        }
        const int j = n / per_tile, r = n % per_tile;
        const int kvi = r % a.kvh, bi = r / a.kvh;
        const int k0 = j * C::BK;
        const int t_first = a.causal ? max(0, k0 - q_off) / C::BQ : 0;
        if (items > 0) mbar_wait(kv_empty, (items - 1) & 1);
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
        for (int bx = 0; bx < C::NBOX; ++bx) {
          tma_load_4d(base + C::OFF_K + bx * C::BK * 128, &tm_k, kv_full, bx * 64, kvi, k0, bi);
          tma_load_4d(base + C::OFF_V + bx * C::BK * 128, &tm_v, kv_full, bx * 64, kvi, k0, bi);
        }
        for (int t = a.n_qt - 1; t >= t_first; --t) {
          for (int g = 0; g < grp; ++g) {
            const int hi = kvi * grp + g;
            const uint32_t full = full0 + 8 * st;
            mbar_wait(empty0 + 8 * st, ph ^ 1);
            int* m = meta + st * 8;
            m[0] = j;
            m[1] = kvi;
            m[2] = bi;
            m[3] = hi;
            m[4] = t;
            m[5] = (t == a.n_qt - 1 && g == 0 ? FIRST : 0) |
                   (t == t_first && g == grp - 1 ? LAST : 0);
            mbar_expect_tx(full, C::STAGE_TX);
            for (int bx = 0; bx < C::NBOX; ++bx) {
              const uint32_t o = st * C::QT_BYTES + bx * C::BQ * 128;
              tma_load_4d(base + C::OFF_Q + o, &tm_q, full, bx * 64, hi, t * C::BQ, bi);
              tma_load_4d(base + C::OFF_DO + o, &tm_do, full, bx * 64, hi, t * C::BQ, bi);
            }
            const long row = ((long)bi * a.h + hi) * a.sq_pad + (long)t * C::BQ;
            bulk_load(base + C::OFF_L + st * C::ROW_BYTES, a.lse2 + row, C::ROW_BYTES, full);
            bulk_load(base + C::OFF_DD + st * C::ROW_BYTES, a.dsum + row, C::ROW_BYTES, full);
            if (++st == C::STAGES) {
              st = 0;
              ph ^= 1;
            }
          }
        }
        ++items;
      }
    }
    if (tid == 32) {
      // the dQ writer: key tile j adds into a (batch, head, query tile)
      // after tiles 0 .. j - 1 have, then counts itself
      int buf = 0;
      uint32_t ph = 0;
      for (;;) {
        mbar_wait(dq_full0 + 8 * buf, ph);
        const int* m = dq_meta + buf * 8;
        const int j = m[0];
        if (j < 0) return;
        const long tile = ((long)m[1] * a.h + m[2]) * a.n_qt + m[3];
        unsigned* cnt = a.cnt + tile;
        int spins = 0;
        long long t0 = 0;
        while (ld_acquire(cnt) < (unsigned)j) watchdog(spins, t0);
        fence_proxy_async_global();
        bulk_reduce_add(a.acc + tile * (C::BQ * D), base + C::OFF_DQ + buf * C::DQ_BYTES,
                        C::DQ_BYTES);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(dq_empty0 + 8 * buf);
        bulk_wait<0>();
        fence_proxy_async_global();
        __threadfence();
        atomicAdd(cnt, 1u);
        if (++buf == 2) {
          buf = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup w holds keys w * 64 .. w * 64 + 63 of the item
  reg_alloc<232>();
  const int w = wg - 1, ctid = tid - 128, wtid = ctid & 127;
  const int wp = wtid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int key_l = w * 64 + wp * 16 + gr;   // the thread's first key row of the tile (+8 the second)
  float dk[D / 2], dv[D / 2];   // 64 keys x d, the m64nd accumulator layout
  int st = 0, kv_it = 0, dbuf = 0;
  uint32_t ph = 0, dph = 0;
  for (;;) {
    mbar_wait(full0 + 8 * st, ph);
    const int* m = meta + st * 8;
    const int j = m[0];
    if (j < 0) {
      // tell the writer
      mbar_wait(dq_empty0 + 8 * dbuf, dph ^ 1);
      if (ctid == 0) dq_meta[dbuf * 8] = -1;
      mbar_arrive(dq_full0 + 8 * dbuf);
      break;
    }
    const int kvi = m[1], bi = m[2], hi = m[3], t = m[4], flags = m[5];
    if (flags & FIRST) {
      mbar_wait(kv_full, kv_it & 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    }
    const int k0 = j * C::BK, q0 = t * C::BQ;
    const uint32_t sQ = base + C::OFF_Q + st * C::QT_BYTES;
    const uint32_t sdO = base + C::OFF_DO + st * C::QT_BYTES;
    const uint32_t sKw = base + C::OFF_K + w * 64 * 128, sVw = base + C::OFF_V + w * 64 * 128;
    const uint32_t sDS = base + C::OFF_DS;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, over head_dim
    float s[NS], dp[NS];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const uint32_t ka = (kk / 4) * C::BK * 128 + (kk % 4) * 32;
      const uint32_t qa = (kk / 4) * C::BQ * 128 + (kk % 4) * 32;
      if constexpr (C::BQ == 128)
        wgmma_m64n128_ss<0, 0>(s, desc_sw128(sKw + ka), desc_sw128(sQ + qa), kk > 0);
      else
        wgmma_m64n64_ss<0, 0>(s, desc_sw128(sKw + ka), desc_sw128(sQ + qa), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const uint32_t ka = (kk / 4) * C::BK * 128 + (kk % 4) * 32;
      const uint32_t qa = (kk / 4) * C::BQ * 128 + (kk % 4) * 32;
      if constexpr (C::BQ == 128)
        wgmma_m64n128_ss<0, 0>(dp, desc_sw128(sVw + ka), desc_sw128(sdO + qa), kk > 0);
      else
        wgmma_m64n64_ss<0, 0>(dp, desc_sw128(sVw + ka), desc_sw128(sdO + qa), kk > 0);
    }
    wg_commit();

    // P^T = 2^(S^T scale log2(e) - lse log2(e)) while dP^T is in flight;
    // the mask (0 past the ends and the diagonal) only on the tiles it cuts
    const float* L = sL + st * C::BQ;
    const float* Dd = sDD + st * C::BQ;
    const int key0 = k0 + key_l;
    const bool cut = q0 + C::BQ > a.sq || k0 + C::BK > a.sk ||
                     (a.causal && k0 + C::BK - 1 > q0 + q_off);
    wg_wait<1>();
    fence_regs(s);
    if (cut) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int qc = (i / 4) * 8 + 2 * tq + (i & 1);
        const int row = q0 + qc, key = key0 + (i & 2 ? 8 : 0);
        const bool ok = row < a.sq && key < a.sk && (!a.causal || key <= row + q_off);
        s[i] = ok ? ex2(fmaf(s[i], a.scale_log2, -L[qc])) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = ex2(fmaf(s[i], a.scale_log2, -L[(i / 4) * 8 + 2 * tq + (i & 1)]));
    }
    // dS^T = P^T (dP^T - D); P^T and dS^T rounded to bf16 as A fragments
    // as they are formed (k-step kk takes the accumulator's 8-column blocks
    // 2kk and 2kk + 1), so that the f32 values die as they go
    wg_wait<0>();
    fence_regs(dp);
    uint32_t pa[QK][4], da[QK][4];
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float2 dd = *reinterpret_cast<const float2*>(Dd + (i / 4) * 8 + 2 * tq);
        pa[kk][e] = pack_bf16(s[i], s[i + 1]);
        da[kk][e] = pack_bf16(s[i] * (dp[i] - dd.x), s[i + 1] * (dp[i + 1] - dd.y));
      }

    // dV += P^T dO and dK += dS^T Q over all d columns (at 128 the two
    // boxes, C::BQ * 128 bytes apart)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      const uint64_t bo = desc_sw128(sdO + kk * 2048, C::BQ * 128);
      if constexpr (D == 128)
        wgmma_m64n128_rs<1>(dv, pa[kk], bo, 1);
      else
        wgmma_m64n64_rs<1>(dv, pa[kk], bo, 1);
    }
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      const uint64_t bq = desc_sw128(sQ + kk * 2048, C::BQ * 128);
      if constexpr (D == 128)
        wgmma_m64n128_rs<1>(dk, da[kk], bq, 1);
      else
        wgmma_m64n64_rs<1>(dk, da[kk], bq, 1);
    }
    wg_commit();

    // dS into shared memory while they run, once both warpgroups are done
    // with the last step's: fragment e of k-step kk is the query pair
    // (16 kk + 2 tq + 8 (e / 2), + 1) of key row key_l + 8 (e % 2); stored
    // [query / 64][key][query % 64], swizzled
    named_sync(2, 256);
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = 16 * kk + 2 * tq + (e & 2 ? 8 : 0);
        const int kt = key_l + (e & 1 ? 8 : 0);
        st_shared(sDS + (qq / 64) * (C::BK * 128) + kt * 128 +
                      ((((qq % 64) >> 3) ^ (kt & 7)) << 4) + (qq % 8) * 2,
                  da[kk][e]);
      }
    fence_view_async_shared();
    named_sync(1, 256);

    // dQ_part = dS K over the tile's 128 keys: at BQ = 128 warpgroup w
    // takes queries w * 64.., all 64 columns; at BQ = 64 all 64 queries and
    // columns w * 64..
    float dq[32];
    const uint32_t aDS = sDS + (C::BQ == 128 ? w : 0) * (C::BK * 128);
    const uint32_t bK = base + C::OFF_K + (C::BQ == 128 ? 0 : w) * (C::BK * 128);
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
      wgmma_m64n64_ss<1, 1>(dq, desc_sw128(aDS + kk * 2048), desc_sw128(bK + kk * 2048), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(dq);
    fence_regs(pa);
    fence_regs(da);
    // this stage's Q, dO, lse and D, and at the item's end K and V, are free
    if (wtid == 0) {
      mbar_arrive(empty0 + 8 * st);
      if (flags & LAST) mbar_arrive(kv_empty);
    }

    // dQ_part to the writer, in fragment order (16 bytes a thread)
    mbar_wait(dq_empty0 + 8 * dbuf, dph ^ 1);
    float4* part = reinterpret_cast<float4*>(gbase + C::OFF_DQ + dbuf * C::DQ_BYTES) +
                   w * 1024 + wp * 256 + lane;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      part[nb * 32] = make_float4(dq[4 * nb], dq[4 * nb + 1], dq[4 * nb + 2], dq[4 * nb + 3]);
    if (ctid == 0) {
      int* dm = dq_meta + dbuf * 8;
      dm[0] = j;
      dm[1] = bi;
      dm[2] = hi;
      dm[3] = t;
    }
    fence_view_async_shared();
    mbar_arrive(dq_full0 + 8 * dbuf);
    if (++dbuf == 2) {
      dbuf = 0;
      dph ^= 1;
    }

    if (flags & LAST) {
      // dK (scaled) and dV of the warpgroup's 64 keys
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = key0 + 8 * half;
        if (key >= a.sk) continue;
        const long off = (((long)bi * a.sk + key) * a.kvh + kvi) * D + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
          const int i = nb * 4 + 2 * half, c = nb * 8;
          *reinterpret_cast<__nv_bfloat162*>(a.dk + off + c) =
              __floats2bfloat162_rn(dk[i] * a.scale, dk[i + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + off + c) =
              __floats2bfloat162_rn(dv[i], dv[i + 1]);
        }
      }
      ++kv_it;
    }
    if (++st == C::STAGES) {
      st = 0;
      ph ^= 1;
    }
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

// head_dim 16 and 80: mma.sync, dK/dV and dQ in two kernels
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint[ByVersion]): the library links only the
// runtime, not libcuda, so no build flag or library key changes
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// codes past cudaError_t's: no encoder; 900 + the CUresult of a refused
// tensor map
constexpr int NO_ENCODER = 899, MAP_REFUSED = 900;

// The tensor map of a (b, s, heads, d) bf16 array: boxes of 64 columns of
// `rows` positions of one head, 128-byte swizzled, zero past s
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_REFUSED + (int)r;
}

// head_dim 64 and 128: the prep kernel, the persistent wgmma kernel, dQ out
template <int D>
int launch_sm90(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* work, void* dq, void* dk, void* dv, int b, int sq,
                int sk, int h, int kvh, float scale, int causal, cudaStream_t s) {
  using C = Hop<D>;
  const Workspace ws = workspace(b, sq, h, D, 1);
  unsigned* cnt = reinterpret_cast<unsigned*>(work + ws.cnt);
  const long rows = (long)b * h * ws.sq_pad;
  flash_bwd_prep_kernel<D><<<(int)((rows * 32 + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, work + ws.lse2,
      work + ws.dsum, work + ws.acc, cnt, (int)ws.n_cnt, rows, sq, ws.sq_pad, h);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if ((rc = make_map(&tm_q, q, b, sq, h, D, C::BQ))) return rc;
  if ((rc = make_map(&tm_do, dout, b, sq, h, D, C::BQ))) return rc;
  if ((rc = make_map(&tm_k, k, b, sk, kvh, D, C::BK))) return rc;
  if ((rc = make_map(&tm_v, v, b, sk, kvh, D, C::BK))) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_sm90_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_sm90_bf16_kernel<D>,
                                                      C::THREADS, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  HopArgs a;
  a.lse2 = work + ws.lse2;
  a.dsum = work + ws.dsum;
  a.acc = work + ws.acc;
  a.cnt = cnt;
  a.work = cnt + ws.n_cnt - 1;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.kvh = kvh;
  a.sq_pad = ws.sq_pad;
  a.n_qt = ws.n_qt;
  a.n_items = (sk + C::BK - 1) / C::BK * kvh * b;
  a.causal = causal;
  a.scale_log2 = scale * LOG2E;
  a.scale = scale;
  // every CTA resident at once; each takes items until none is left
  const int grid = a.n_items < per_sm * sms ? a.n_items : per_sm * sms;
  flash_bwd_sm90_bf16_kernel<D><<<grid, C::THREADS, C::SMEM, s>>>(tm_q, tm_k, tm_v, tm_do, a);
  if ((rc = (int)cudaGetLastError())) return rc;
  const long n4 = (long)b * h * ws.sq_pad * D / 4;
  const long blocks = (n4 + 255) / 256;
  flash_bwd_dq_out_kernel<D><<<(int)(blocks < 8L * sms ? blocks : 8L * sms), 256, 0, s>>>(
      reinterpret_cast<const float4*>(work + ws.acc), static_cast<bf16*>(dq), n4, sq, h,
      ws.n_qt, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* work, void* dq, void* dk, void* dv,
           int b, int sq, int sk, int h, int kvh, float scale, int causal, cudaStream_t s) {
  if (!is_bf16)
    return launch_f32<D>(q, k, v, o, dout, lse, work, dq, dk, dv, b, sq, sk, h, kvh, scale,
                         causal, s);
  if constexpr (D == 64 || D == 128)
    return launch_sm90<D>(q, k, v, o, dout, lse, work, dq, dk, dv, b, sq, sk, h, kvh, scale,
                          causal, s);
  else
    return launch_bf16<D>(q, k, v, o, dout, lse, work, dq, dk, dv, b, sq, sk, h, kvh, scale,
                          causal, s);
}

}  // namespace

// The scratch `work` of gf_flash_attention_bwd in bytes: (b, h, sq) f32 for
// D, and on the wgmma route (bf16, head_dim 64 or 128) also the padded lse,
// the dQ accumulator and the counters (see Workspace).
extern "C" size_t gf_flash_attention_bwd_workspace(int b, int sq, int sk, int h, int kvh, int d,
                                                   int is_bf16) {
  (void)sk;
  (void)kvh;
  return 4 * (size_t)workspace(b, sq, h, d, is_bf16).words;
}

// q, o, dout, dq (b, sq, h, d); k, v, dk, dv (b, sk, kvh, d), all contiguous,
// of one dtype: bf16 when is_bf16 (the tensor-core routes; 16-byte aligned),
// else f32; lse f32 (b, h, sq), the forward's; work: scratch of
// gf_flash_attention_bwd_workspace bytes, 16-byte aligned, written here.
// Three launches on the stream; returns cudaGetLastError() (or a code
// past cudaError_t's when a tensor map cannot be made: 899 no encoder,
// 900 + the CUresult).
extern "C" int gf_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* work, void* dq, void* dk, void* dv, int b,
                                      int sq, int sk, int h, int kvh, int d, int is_bf16,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  switch (d) {
    case 16: return launch<16>(is_bf16, q, k, v, o, dout, l, w, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    case 64: return launch<64>(is_bf16, q, k, v, o, dout, l, w, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    case 80: return launch<80>(is_bf16, q, k, v, o, dout, l, w, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    case 128: return launch<128>(is_bf16, q, k, v, o, dout, l, w, dq, dk, dv, b, sq, sk, h, kvh, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
