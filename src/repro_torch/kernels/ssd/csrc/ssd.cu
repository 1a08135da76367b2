// Mamba2 chunked SSD (state-space dual) for Hopper (sm_90a): products on
// the tensor cores as 3xTF32, float32 in and out.
//
// Replaces: src/repro/kernels/ssd/kernel.py::_ssd_kernel (the Pallas TPU
//   kernel behind ssd, kernel.py:76).  Same function, on the pre-weighted
//   inputs xdt = x*dt (b, L, nh, hd) and loga = dt*A (b, L, nh), with B and C
//   (b, L, n) shared by all heads.  Per chunk of Q tokens:
//     cum = cumsum(loga),  G = C B^T,  M = G * exp(cum_t - cum_s) * [t >= s],
//     y   = M @ xdt + exp(cum) * (C @ S),
//     S   = exp(total) S + B^T (xdt * exp(total - cum)),
//   returning y (without the D term, which mamba2_apply adds) and the final
//   state (b, nh, n, hd).  The exponent is taken only where t >= s: the
//   Pallas kernel takes exp on the upper triangle and selects afterwards
//   (kernel.py:53), which here would give inf * 0 = NaN.  Any L: the last
//   chunk's tail is masked.
// Yardstick: no single PyTorch call computes it (library_ms is null).
// Bound on an H100: at b=8, L=2048, 80 heads of 64, state 64, chunk 128 the
//   function moves 695,205,888 B (xdt and y in f32, loga, B, C, the state):
//   0.2075 ms at 3.35 TB/s.  Its chunked form needs 3.24e10 FLOP with G
//   shared by the heads and the triangle skipped, 0.1966 ms as 3xTF32
//   products at 495 TFLOP/s (the recurrence, 2.68e10 FLOP on the f32 CUDA
//   cores, 0.40 ms).  So it is bound by bytes, at 0.2075 ms.
// Precision: every product runs on TF32 parts as 3xTF32: a = hi + lo with
//   hi rounded to nearest (ties away from zero) and lo = a - hi, and
//   mma.sync m16n8k8 accumulates lo*hi + hi*lo + hi*hi in f32.  That is as
//   accurate as f32 products; one TF32 product misses the reference's
//   5e-4 / 5e-3 by 20x (tests/test_torch_ssd.py emulates both).  An operand
//   is split when its fragment is loaded into registers (3 instructions),
//   and a split fragment feeds every product of its k-step.
// Design, against what held the CUDA-core kernel back:
//   1. Products on the tensor cores: G, M @ xdt, C @ S and B^T (xdt w) are
//      mma.sync tf32 in 3xTF32.
//   2. Only the function's work: G and M @ xdt run over the 16x8 tiles on or
//      below the diagonal; G stays in registers and becomes M there.  Its
//      accumulator layout is used as M's A fragment by permuting the k index
//      (A column c <-> token 2c, column c+4 <-> 2c+1), and xdt's rows are read
//      in the same order, so M passes through no shared memory.  The decays
//      are one ex2.approx each, on cum scaled by log2(e) once a token.
//      G is not shared by heads: a CTA of two heads (G formed once) measured
//      1.4x slower on the H100, its registers leaving one CTA an SM.
//   3. A smaller footprint: B and xdt in f32 rows padded for conflict-free
//      fragment reads, the state (n, hd), cum and its exponents; C's
//      fragments go from global memory (L2: every head of a row reads them)
//      straight to registers.  105,984 B at Q = 128, n = hd = 64: two CTAs of
//      8 warps an SM (one CTA of 8 warps before, at 182,784 B).
//   4. The loads are 16-byte cp.async copies; C's first fragments and the
//      cumsum (warp 0, reading loga from global memory) are taken while they
//      fly.  Three __syncthreads a chunk; the two CTAs of an SM overlap each
//      other's.
//   Two teams of 4 warps each take half of y's and the state's columns.  In
//   a team, warp w owns row tiles w and 2*4-1-w (balanced triangles) for y
//   and state row tiles w, w+4 for the update.  The two warps on the same
//   rows (one of each team) each form G over half of its k steps and add
//   the other's partial sums through shared memory.  The state stays in
//   shared memory, updated in place after every reader of the entering one
//   is done.  At zamba2's widths (hd = n = 64) the widths are compile-time
//   constants, so fragment offsets fold into the loads.
//   Left for later: wgmma with TMA and a producer warp, a two-stage ring
//   (it does not fit beside two CTAs an SM), fusing x*dt into the staging.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

using namespace ssd_tc;

// two teams of four warps: a team takes half of y's and the state's columns
constexpr int ROW_WARPS = 4;
constexpr int THREADS = 32 * 2 * ROW_WARPS;
// G is formed SG s-tiles at a time; the two warps of a row-tile pair (one
// of each team) each take half of its k steps and swap their partial sums
// through shared memory, two buffers of SG 16x8 tiles a warp
constexpr int SG = 2;
constexpr int GX_FLOATS = 2 * ROW_WARPS * 2 * SG * 4 * 32;
constexpr float LOG2E = 1.4426950408889634f;

// float offsets of the shared arrays; B rows padded to NP + 4, xdt rows to
// hd + 4 (a multiple of 4 words plus 4: the k-permuted fragment reads hit 32
// banks), state rows to hd + 8
struct Layout {
  int NP, PB, PX, PS, oX, oS, oCum, oEc, oW, oG, total;
};

__host__ __device__ inline Layout layout(int Q, int n, int hd) {
  Layout l;
  l.NP = (n + 15) / 16 * 16;   // state rows, padded to the m16 tile
  l.PB = l.NP + 4;
  l.PX = hd + 4;
  l.PS = hd + 8;
  l.oX = Q * l.PB;
  l.oS = l.oX + Q * l.PX;
  l.oCum = l.oS + l.NP * l.PS;
  l.oEc = l.oCum + Q;
  l.oW = l.oEc + Q;
  l.oG = l.oW + Q;
  l.total = l.oG + GX_FLOATS;
  return l;
}

size_t smem_bytes(int Q, int n, int hd) {
  return sizeof(float) * (size_t)layout(Q, n, hd).total;
}

// C's A fragments for rows ta, tb of the chunk at c0 (zero past q or n),
// from global memory
template <int W>
__device__ __forceinline__ void load_c(float (&cf)[W][4], const float* Cb, int c0, int ta,
                                       int q, int n, int nk, int c) {
  const int tb = ta + 8;
  const float* ca = Cb + (long)(c0 + ta) * n;
  const float* cb = Cb + (long)(c0 + tb) * n;
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
    const int k0 = 8 * kk + c, k1 = k0 + 4;
    const bool inA = kk < nk && ta < q, inB = kk < nk && tb < q;
    cf[kk][0] = inA && k0 < n ? ca[k0] : 0.f;
    cf[kk][1] = inB && k0 < n ? cb[k0] : 0.f;
    cf[kk][2] = inA && k1 < n ? ca[k1] : 0.f;
    cf[kk][3] = inB && k1 < n ? cb[k1] : 0.f;
  }
}

// One head of one batch row a CTA.  W bounds NP / 8 and hd / 8 (a team's
// half of y's and the state's columns is W / 2 n8 tiles); HD and NPAD, where
// not 0, fix hd and NP at compile time.
template <int W, int HD, int NPAD>
__global__ void __launch_bounds__(THREADS, W == 8 ? 2 : 1)
ssd_tc_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ y, float* __restrict__ state, int L, int nh,
              int hd_arg, int n, int Q) {
  constexpr int JW = W / 2;
  const int hd = HD ? HD : hd_arg;
  const Layout lay = layout(Q, n, hd);
  const int NP = NPAD ? NPAD : lay.NP;
  const int PB = NP + 4, PX = hd + 4, PS = hd + 8;
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                  // (Q, PB)   B of the chunk
  float* sX = smem + lay.oX;         // (Q, PX)   xdt of the chunk
  float* sS = smem + lay.oS;         // (NP, PS)  the carried state
  float* sCum = smem + lay.oCum;     // (Q)       cum * log2(e)
  float* sEc = smem + lay.oEc;       // (Q)       exp(cum)
  float* sW = smem + lay.oW;         // (Q)       exp(total - cum)
  float* sG = smem + lay.oG;         // (warp, 2, SG * 4, 32) partial G

  const int hi = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % ROW_WARPS, team = warp / ROW_WARPS;
  const int g = lane >> 2, c = lane & 3;
  const int nk = NP / 8, RT = Q / 16;
  const int ntt = hd / 16, j0 = team * ntt;   // this team's n8 column tiles
  const int kb = team * (nk / 2), ke = kb + nk / 2;   // this warp's k steps of G
  const long xrow = (long)nh * hd;   // elements between consecutive tokens
  const float* xb = xdt + (long)bi * L * xrow + (long)hi * hd;
  float* yb = y + (long)bi * L * xrow + (long)hi * hd;
  const float* lb = loga + (long)bi * L * nh + hi;
  const float* Bb = Bm + (long)bi * L * n;
  const float* Cb = Cm + (long)bi * L * n;
  const bool b16 = n % 4 == 0 && (reinterpret_cast<uintptr_t>(Bm) & 15) == 0;
  float* gmine = sG + warp * 2 * SG * 4 * 32 + lane;
  const float* gother = sG + ((warp + ROW_WARPS) % (2 * ROW_WARPS)) * 2 * SG * 4 * 32 + lane;

  // the state starts at zero; B's columns n..NP are never copied: zero them
  for (int i = tid; i < NP * PS; i += THREADS) sS[i] = 0.f;
  for (int i = tid; i < Q * (NP - n); i += THREADS)
    sB[(i / (NP - n)) * PB + n + i % (NP - n)] = 0.f;

  float cf[W][4];
  int gbuf = 0;   // which of its two partial-G buffers this warp writes next
  for (int c0 = 0; c0 < L; c0 += Q) {
    const int q = min(Q, L - c0);    // live tokens of this chunk
    // ---- copies of B and xdt; rows past q are zero-filled ----
    if (b16) {
      const int cpr = n / 4;
      for (int i = tid; i < Q * cpr; i += THREADS) {
        const int t = i / cpr, k = (i % cpr) * 4;
        const bool in = t < q;
        cp_async16(smem_u32(sB + t * PB + k), in ? Bb + (long)(c0 + t) * n + k : Bb, in);
      }
    } else {
      for (int i = tid; i < Q * n; i += THREADS) {
        const int t = i / n, k = i % n;
        const bool in = t < q;
        cp_async4(smem_u32(sB + t * PB + k), in ? Bb + (long)(c0 + t) * n + k : Bb, in);
      }
    }
    {
      const int cpr = hd / 4;
      for (int i = tid; i < Q * cpr; i += THREADS) {
        const int t = i / cpr, k = (i % cpr) * 4;
        const bool in = t < q;
        cp_async16(smem_u32(sX + t * PX + k), in ? xb + (long)(c0 + t) * xrow + k : xb, in);
      }
    }
    // ---- while they fly: C's fragments of this warp's first row tile,
    // and warp 0 scans the log-decays (zero past q, so the last entry is
    // the chunk total), 4 consecutive a lane ----
    load_c<W>(cf, Cb, c0, 16 * wr + g, q, n, nk, c);
    if (warp == 0) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        v[e] = t < q ? lb[(long)(c0 + t) * nh] : 0.f;
      }
      v[1] += v[0]; v[2] += v[1]; v[3] += v[2];
      float run = v[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += up;
      }
      const float excl = run - v[3];
      const float total = __shfl_sync(0xffffffffu, run, 31);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        if (t < Q) {
          const float cum = excl + v[e];
          sCum[t] = cum * LOG2E;
          sEc[t] = expf(cum);
          sW[t] = expf(total - cum);
        }
      }
    }
    cp_async_commit_wait_all();
    __syncthreads();   // (a) the chunk, cum and the entering state are visible

    // ---- y: the warps of a team take row tiles wr, 2*ROW_WARPS-1-wr,
    // 2*ROW_WARPS+wr, ... and the team's half of y's columns ----
    for (int j2 = 0; j2 * ROW_WARPS < RT; ++j2) {
      const int r = j2 * ROW_WARPS + ((j2 & 1) ? ROW_WARPS - 1 - wr : wr);
      const int t0 = 16 * r;
      if (r >= RT || t0 >= q) continue;
      const int ta = t0 + g, tb = ta + 8;   // this thread's two rows
      if (j2 > 0) load_c<W>(cf, Cb, c0, ta, q, n, nk, c);
      float acc[JW][4];
#pragma unroll
      for (int j = 0; j < JW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      // exp(cum_t) * (C @ S) with the entering state (zero on the first chunk)
      if (c0 > 0) {
#pragma unroll
        for (int kk = 0; kk < W; ++kk) {
          if (kk >= nk) break;
          const FragA a(cf[kk][0], cf[kk][1], cf[kk][2], cf[kk][3]);
          const float* sp = sS + (8 * kk + c) * PS + 8 * j0 + g;
#pragma unroll
          for (int j = 0; j < JW; ++j) {
            if (j >= ntt) break;
            mma3(acc[j], a, sp[8 * j], sp[4 * PS + 8 * j]);
          }
        }
        const float ea = sEc[ta], eb = sEc[tb];
#pragma unroll
        for (int j = 0; j < JW; ++j) {
          acc[j][0] *= ea; acc[j][1] *= ea;
          acc[j][2] *= eb; acc[j][3] *= eb;
        }
      }

      // G on the 8-token s-tiles on or below the diagonal, SG of them at a
      // time (C's fragment split once for them): this warp's half of the k
      // steps plus the other team's; then M @ xdt on each
      const float cta = sCum[ta], ctb = sCum[tb];
      const int nst = min(2 * r + 2, (q + 7) / 8);
      for (int sg0 = 0; sg0 < nst; sg0 += SG) {
        float gacc[SG][4], gs[SG][4];   // G (ta|tb, s0+2c|s0+2c+1) of s-tile sg0 + u
#pragma unroll
        for (int u = 0; u < SG; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[u][e] = gs[u][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < W; ++kk) {
          if (kk >= ke) break;
          if (kk < kb) continue;
          const FragA a(cf[kk][0], cf[kk][1], cf[kk][2], cf[kk][3]);
#pragma unroll
          for (int u = 0; u < SG; ++u) {
            if (sg0 + u >= nst) break;
            const float* bp = sB + (8 * (sg0 + u) + g) * PB + 8 * kk + c;   // B^T (k, s)
            mma3_split(gacc[u], gs[u], a, bp[0], bp[4]);
          }
        }
        float* mine = gmine + gbuf * SG * 4 * 32;
#pragma unroll
        for (int u = 0; u < SG; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gacc[u][e] += gs[u][e];
            mine[(u * 4 + e) * 32] = gacc[u][e];
          }
        // the two warps on these rows: ids 1..ROW_WARPS (0 is __syncthreads)
        asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wr), "r"(64) : "memory");
        const float* other = gother + gbuf * SG * 4 * 32;
#pragma unroll
        for (int u = 0; u < SG; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[u][e] += other[(u * 4 + e) * 32];
        gbuf ^= 1;
#pragma unroll
        for (int u = 0; u < SG; ++u) {
          if (sg0 + u >= nst) break;
          const int sa = 8 * (sg0 + u) + 2 * c, sb = sa + 1;
          const float csa = sCum[sa], csb = sCum[sb];
          // A fragment of M with k permuted: column c <-> token sa, c+4 <-> sb
          const FragA m(sa <= ta ? gacc[u][0] * ex2(cta - csa) : 0.f,
                        sa <= tb ? gacc[u][2] * ex2(ctb - csa) : 0.f,
                        sb <= ta ? gacc[u][1] * ex2(cta - csb) : 0.f,
                        sb <= tb ? gacc[u][3] * ex2(ctb - csb) : 0.f);
          const float* xp = sX + sa * PX + 8 * j0 + g;     // rows sa, sb
#pragma unroll
          for (int j = 0; j < JW; ++j) {
            if (j >= ntt) break;
            mma3(acc[j], m, xp[8 * j], xp[PX + 8 * j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        if (j >= ntt) break;
        float* yp = yb + (long)(c0 + ta) * xrow + 8 * (j0 + j) + 2 * c;
        if (ta < q) *reinterpret_cast<float2*>(yp) = make_float2(acc[j][0], acc[j][1]);
        if (tb < q) *reinterpret_cast<float2*>(yp + 8 * xrow) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();   // (b) every reader of the entering state is done

    // ---- S = exp(total) S + B^T (xdt * exp(total - cum)), in place: the
    // warps of a team take state row tiles wr, wr + ROW_WARPS, ... and the
    // team's half of the columns; tokens k-permuted as above ----
    const int nks = (q + 7) / 8;
    const float et = ex2(sCum[Q - 1]);
    for (int mt = wr; mt < NP / 16; mt += ROW_WARPS) {
      const int ka = 16 * mt + g, kb8 = ka + 8;
      float sacc[JW][4];
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        if (j >= ntt) break;
        const float* sp = sS + ka * PS + 8 * (j0 + j) + 2 * c;
        const float2 u = *reinterpret_cast<const float2*>(sp);
        const float2 v = *reinterpret_cast<const float2*>(sp + 8 * PS);
        sacc[j][0] = et * u.x; sacc[j][1] = et * u.y;
        sacc[j][2] = et * v.x; sacc[j][3] = et * v.y;
      }
      for (int ks = 0; ks < nks; ++ks) {
        const int sa = 8 * ks + 2 * c, sb = sa + 1;
        const FragA a(sB[sa * PB + ka], sB[sa * PB + kb8], sB[sb * PB + ka], sB[sb * PB + kb8]);
        const float wa = sW[sa], wb = sW[sb];
        const float* xp = sX + sa * PX + 8 * j0 + g;
#pragma unroll
        for (int j = 0; j < JW; ++j) {
          if (j >= ntt) break;
          mma3(sacc[j], a, xp[8 * j] * wa, xp[PX + 8 * j] * wb);
        }
      }
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        if (j >= ntt) break;
        float* sp = sS + ka * PS + 8 * (j0 + j) + 2 * c;
        *reinterpret_cast<float2*>(sp) = make_float2(sacc[j][0], sacc[j][1]);
        *reinterpret_cast<float2*>(sp + 8 * PS) = make_float2(sacc[j][2], sacc[j][3]);
      }
    }
    __syncthreads();   // (c) B and xdt free for the next copies; the state written
  }

  float* st = state + ((long)bi * nh + hi) * n * hd;
  for (int i = tid; i < n * hd; i += THREADS) st[i] = sS[(i / hd) * PS + i % hd];
}

template <int W, int HD, int NPAD>
int launch(const void* xdt, const void* loga, const void* B, const void* C, void* y,
           void* state, int b, int L, int nh, int hd, int n, int chunk, void* stream) {
  const size_t smem = smem_bytes(chunk, n, hd);
  auto* k = ssd_tc_kernel<W, HD, NPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  k<<<dim3(nh, b), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(state), L, nh, hd, n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t gf_ssd_smem(int chunk, int n, int hd) {
  return smem_bytes(chunk, n, hd);
}

// xdt (b, L, nh, hd), loga (b, L, nh), B/C (b, L, n), all float32 and
// contiguous, xdt 16-byte aligned; y (b, L, nh, hd), state (b, nh, n, hd)
// float32.  chunk is a multiple of 16 up to 128, hd a multiple of 16 up to
// 128, n from 1 to 128.  Returns cudaGetLastError().
extern "C" int gf_ssd(const void* xdt, const void* loga, const void* B,
                      const void* C, void* y, void* state, int b, int L, int nh,
                      int hd, int n, int chunk, void* stream) {
  if (hd == 64 && (n + 15) / 16 * 16 == 64)   // zamba2's widths
    return launch<8, 64, 64>(xdt, loga, B, C, y, state, b, L, nh, hd, n, chunk, stream);
  if (hd <= 64 && n <= 64)
    return launch<8, 0, 0>(xdt, loga, B, C, y, state, b, L, nh, hd, n, chunk, stream);
  return launch<16, 0, 0>(xdt, loga, B, C, y, state, b, L, nh, hd, n, chunk, stream);
}
