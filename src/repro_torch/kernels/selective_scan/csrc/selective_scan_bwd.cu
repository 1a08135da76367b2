// The gradient of the fused Mamba1 scan for Hopper (sm_90a): CUDA cores,
// float32 state, no atomics.
//
// Replaces: none.  The reference has no backward kernel: its trainer
//   differentiates the XLA route (src/repro/models/ssm.py:101-127, the
//   chunked associative scan), and its Pallas forward is
//   kernels/selective_scan/kernel.py:23 (_scan_kernel, pallas_call at :65),
//   which csrc/selective_scan.cu ports and fuses.  This is the gradient of
//   that fused form,
//     y = ((scan(xc, delta, A, B, C) + D xc) * silu(z)).bf16,
//     delta = softplus(dt_raw + dt_b),
//   from dy (b, L, d) bf16 -> dxc, ddt_raw, dz (b, L, d) bf16, dB, dC
//   (b, L, n) bf16, ddt_b (d), dA (d, n), dD (d) float32.  A = -exp(A_log)
//   stays outside: autograd takes dA to A_log.
// Yardstick: no single PyTorch call computes it (library_ms is null).
// Bound on an H100 (chip_smoke.py::fused_scan_bwd_bound): at falcon-mamba's
//   microbatch (b=2, L=4,096, d=8,192, n=16) the function reads xc, dt_raw,
//   z, dy, B, C and writes their gradients but dy's, in bf16 (942 MB, 0.281
//   ms at 3.35 TB/s); it takes the state's exp once a (token, channel,
//   state) and the softplus's and the gate's special-function operations a
//   (token, channel), 1.28e9 on the special-function units at 4.19e12/s
//   (0.304 ms), beside 2.07e10 f32 operations at 67 TFLOP/s (0.3085 ms):
//   the operations bound it.
// Structure: four lanes a channel, n / 4 states each in registers (their
//   sums over the states by two shuffles); a CTA takes CH = 64 channels of
//   one batch row, 256 threads.
//   1. Forward over the sequence: the state entering every chunk of T
//      tokens into a scratch (b, chunks, n, d).
//   2. The chunks in reverse.  For each, the chunk's states are recomputed
//      from its entering state into shared memory (T + 1 of them); the
//      scan's output then gives the gate's gradient dz; dC's part of the
//      CTA's channels, sum_c g_t h_t, is summed over the channels in
//      channel order; then the reverse recurrence, with g_t = dy_t silu(z_t),
//        dh_t = a_{t+1} dh_{t+1} + g_t C_t,      a_t = exp(delta_t A),
//        dxc_t = delta_t (dh_t . B_t) + D g_t,
//        ddelta_t = dh_t . (A a_t h_{t-1}) + xc_t (dh_t . B_t),
//        dA += dh_t delta_t a_t h_{t-1},
//      the softplus's derivative a sigmoid (1 above PyTorch's threshold
//      20), and dB's part, sum_c dh_t delta_t xc_t, summed alike.
//   3. scan_bwd_finish: dB and dC summed over the CTAs' parts in order
//      and cast to bf16; dA, dD and ddt_b summed over the batch rows in
//      order.  So a call gives the same bits every time.
// The state's exp is one FMUL and one ex2.approx, as in the forward.
// Four lanes a channel put four times the warps on an SM of the first
//   version's one thread a channel, which left one warp a scheduler to
//   wait on its own chain of dependent loads and exps.
// Left for later: the states pass written by the forward, a cp.async ring
//   for the per-token loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 64;          // channels per CTA
constexpr int PARTS = 4;        // lanes per channel, n / PARTS states each
constexpr int THREADS = CH * PARTS;
constexpr int MAX_N = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the forward's softplus (csrc/selective_scan.cu)
__device__ __forceinline__ float softplus(float v) {
  const float e = ex2(v * kLog2e);
  const float lp = e < 1e-2f ? e * (1.f - e * (0.5f - e * (1.f / 3.f)))
                             : kLn2 * lg2(1.f + e);
  return v > 20.f ? v : lp;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + ex2(-v * kLog2e)); }

__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

struct Args {
  const __nv_bfloat16* x;     // xc (b, L, d), strides sx_b, sx_l
  const __nv_bfloat16* dt;    // dt_raw
  const __nv_bfloat16* z;
  const __nv_bfloat16* B;     // (b, L, n)
  const __nv_bfloat16* C;
  const __nv_bfloat16* dy;    // (b, L, d) contiguous
  const float* A;             // (d, n)
  const float* D;             // (d,)
  const float* dt_b;          // (d,)
  __nv_bfloat16* dx;          // (b, L, d) contiguous
  __nv_bfloat16* ddt;
  __nv_bfloat16* dz;
  float* hb;                  // (b, nch, n, d): states entering each chunk
  float* dBp;                 // (b, nblk, L, n): the CTAs' parts
  float* dCp;
  float* dAp;                 // (b, d, n)
  float* dDp;                 // (b, d)
  float* ddtbp;               // (b, d)
  long long sx_b, sx_l, sdt_b, sdt_l, sz_b, sz_l, sB_b, sB_l, sC_b, sC_l;
  int L, d, n;
};

// tokens a chunk for NP states a channel: the recomputed states (T + 1,
// NP, CH + 1) stay under ~80 KB of shared memory
template <int NP>
__host__ __device__ constexpr int chunk_tokens() { return NP <= 16 ? 16 : (NP == 32 ? 8 : 4); }

template <int NP>
constexpr int smem_floats() {
  constexpr int T = chunk_tokens<NP>();
  return (T + 1) * NP * (CH + 1)  // states, then dB's parts
         + 2 * T * NP             // B, C of the chunk
         + 4 * T * CH;            // delta, xc, g, the gate's sigmoid
}

// the sum of v over a channel's PARTS lanes (neighbours), in a fixed order
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = 1; off < PARTS; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int S>
__global__ void __launch_bounds__(THREADS) scan_bwd_kernel(const Args a) {
  constexpr int NP = PARTS * S;
  constexpr int T = chunk_tokens<NP>();
  constexpr int PC = CH + 1;
  extern __shared__ float smem[];
  float* sH = smem;                          // [T + 1][NP][PC]
  float* sB = sH + (T + 1) * NP * PC;        // [T][NP]
  float* sC = sB + T * NP;                   // [T][NP]
  float* sDel = sC + T * NP;                 // [T][CH]
  float* sU = sDel + T * CH;                 // [T][CH]
  float* sG = sU + T * CH;                   // [T][CH] dy * silu(z)
  float* sSz = sG + T * CH;                  // [T][CH] sigmoid(z)

  const int tid = threadIdx.x, blk = blockIdx.x, bi = blockIdx.y;
  const int cl = tid / PARTS, part = tid % PARTS;   // channel of the CTA, lane in it
  const int c = blk * CH + cl;
  const bool live = c < a.d;
  const int L = a.L, d = a.d, n = a.n;
  const int nch = (L + T - 1) / T, nblk = gridDim.x;
  const int cc = live ? c : 0;

  const __nv_bfloat16* gx = a.x + bi * a.sx_b;
  const __nv_bfloat16* gdt = a.dt + bi * a.sdt_b;
  const __nv_bfloat16* gz = a.z + bi * a.sz_b;
  const __nv_bfloat16* gB = a.B + bi * a.sB_b;
  const __nv_bfloat16* gC = a.C + bi * a.sC_b;
  const __nv_bfloat16* gdy = a.dy + (long long)bi * L * d;
  float* hb = a.hb + (long long)bi * nch * n * d;

  // this lane's states k = part * S + j; padded states have A = 0 and
  // B = C = 0, so they stay 0 and add nothing
  float a2[S], Av[S], h[S], dh[S], dA[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = part * S + j;
    const float av = (live && k < n) ? a.A[(long long)c * n + k] : 0.f;
    Av[j] = av;
    a2[j] = av * kLog2e;
    h[j] = 0.f;
    dh[j] = 0.f;
    dA[j] = 0.f;
  }
  const float dtb = live ? a.dt_b[c] : 0.f;
  const float Dc = live ? a.D[c] : 0.f;

  // 1. the state entering each chunk
  for (int jc = 0; jc < nch; ++jc) {
    if (live) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = part * S + j;
        if (k < n) hb[((long long)jc * n + k) * d + c] = h[j];
      }
    }
    const int t1 = min(L, (jc + 1) * T);
    for (int t = jc * T; t < t1; ++t) {
      const float dv = softplus(bf(gdt + t * a.sdt_l + cc) + dtb);
      const float dx = dv * bf(gx + t * a.sx_l + cc);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = part * S + j;
        const float bk = k < n ? bf(gB + t * a.sB_l + k) : 0.f;
        h[j] = fmaf(ex2(dv * a2[j]), h[j], dx * bk);
      }
    }
  }

  // 2. the chunks in reverse
  float dD = 0.f, ddtb = 0.f;
  for (int jc = nch - 1; jc >= 0; --jc) {
    const int t0 = jc * T, q = min(T, L - t0);
    __syncthreads();   // the last chunk's readers of shared memory are done
    for (int i = tid; i < T * NP; i += THREADS) {
      const int t = i / NP, k = i % NP;
      const bool in = t < q && k < n;
      sB[i] = in ? bf(gB + (t0 + t) * a.sB_l + k) : 0.f;
      sC[i] = in ? bf(gC + (t0 + t) * a.sC_l + k) : 0.f;
    }
    // the per-(token, channel) values, consecutive threads on consecutive
    // channels; a channel past d adds nothing to dB's and dC's sums (g = 0)
    for (int i = tid; i < q * CH; i += THREADS) {
      const int t = i / CH, ch = i % CH;
      const int cg = blk * CH + ch;
      const bool lv = cg < d;
      const long long r = t0 + t;
      const int col = lv ? cg : 0;
      const float zv = bf(gz + r * a.sz_l + col);
      const float sz = sigmoid(zv);
      const float db = lv ? a.dt_b[cg] : 0.f;
      sDel[i] = softplus(bf(gdt + r * a.sdt_l + col) + db);
      sU[i] = bf(gx + r * a.sx_l + col);
      sSz[i] = sz;
      sG[i] = lv ? bf(gdy + r * d + col) * zv * sz : 0.f;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = part * S + j;
      h[j] = (live && k < n) ? hb[((long long)jc * n + k) * d + c] : 0.f;
      sH[k * PC + cl] = h[j];
    }
    __syncthreads();

    // the chunk's states, the scan's output and the gate's gradient
    for (int t = 0; t < q; ++t) {
      const float dv = sDel[t * CH + cl], u = sU[t * CH + cl];
      const float dx = dv * u;
      float ys = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = part * S + j;
        h[j] = fmaf(ex2(dv * a2[j]), h[j], dx * sB[t * NP + k]);
        ys = fmaf(h[j], sC[t * NP + k], ys);
        sH[((t + 1) * NP + k) * PC + cl] = h[j];
      }
      ys = lanes_sum(ys);
      if (part == 0 && live) {
        const float zv = bf(gz + (long long)(t0 + t) * a.sz_l + c);
        const float sz = sSz[t * CH + cl];
        const float g = bf(gdy + (long long)(t0 + t) * d + c);
        const float ypre = fmaf(Dc, u, ys);
        a.dz[((long long)bi * L + t0 + t) * d + c] =
            __float2bfloat16_rn(g * ypre * sz * (1.f + zv * (1.f - sz)));
      }
    }
    __syncthreads();
    // dC's part: sum over the CTA's channels, in channel order
    float* dCp = a.dCp + ((long long)bi * nblk + blk) * L * n;
    for (int i = tid; i < q * n; i += THREADS) {
      const int t = i / n, k = i % n;
      const float* hr = sH + ((t + 1) * NP + k) * PC;
      const float* gr = sG + t * CH;
      float acc = 0.f;
      for (int ch = 0; ch < CH; ++ch) acc = fmaf(gr[ch], hr[ch], acc);
      dCp[(long long)(t0 + t) * n + k] = acc;
    }
    __syncthreads();

    // the reverse recurrence; dB's part of token t replaces h_t in sH
    for (int t = q - 1; t >= 0; --t) {
      const float dv = sDel[t * CH + cl], u = sU[t * CH + cl];
      const float g = sG[t * CH + cl];
      float s1 = 0.f, sa = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = part * S + j;
        dh[j] = fmaf(g, sC[t * NP + k], dh[j]);
        const float ak = ex2(dv * a2[j]);
        const float hp = sH[(t * NP + k) * PC + cl];
        s1 = fmaf(dh[j], sB[t * NP + k], s1);
        const float dha = dh[j] * ak * hp;
        sa = fmaf(dha, Av[j], sa);
        dA[j] = fmaf(dha, dv, dA[j]);
        sH[((t + 1) * NP + k) * PC + cl] = dh[j] * dv * u;
        dh[j] *= ak;
      }
      s1 = lanes_sum(s1);
      sa = lanes_sum(sa);
      if (part == 0) {
        const float ddelta = fmaf(s1, u, sa);
        const float v = bf(gdt + (long long)(t0 + t) * a.sdt_l + cc) + dtb;
        const float ddt = v > 20.f ? ddelta : ddelta * sigmoid(v);
        dD = fmaf(g, u, dD);
        ddtb += ddt;
        if (live) {
          const long long o = ((long long)bi * L + t0 + t) * d + c;
          a.dx[o] = __float2bfloat16_rn(fmaf(s1, dv, g * Dc));
          a.ddt[o] = __float2bfloat16_rn(ddt);
        }
      }
    }
    __syncthreads();
    float* dBp = a.dBp + ((long long)bi * nblk + blk) * L * n;
    for (int i = tid; i < q * n; i += THREADS) {
      const int t = i / n, k = i % n;
      const float* r = sH + ((t + 1) * NP + k) * PC;
      float acc = 0.f;
      for (int ch = 0; ch < CH; ++ch) acc += r[ch];
      dBp[(long long)(t0 + t) * n + k] = acc;
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = part * S + j;
      if (k < n) a.dAp[((long long)bi * d + c) * n + k] = dA[j];
    }
    if (part == 0) {
      a.dDp[(long long)bi * d + c] = dD;
      a.ddtbp[(long long)bi * d + c] = ddtb;
    }
  }
}

// dB, dC: the parts summed over the CTAs in order, cast to bf16; dA, dD,
// ddt_b: summed over the batch rows in order
__global__ void scan_bwd_finish(const float* __restrict__ dBp, const float* __restrict__ dCp,
                                const float* __restrict__ dAp, const float* __restrict__ dDp,
                                const float* __restrict__ ddtbp, __nv_bfloat16* dB,
                                __nv_bfloat16* dC, float* dA, float* dD, float* ddtb, int b,
                                int L, int d, int n, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)L * n;
  if (i < (long long)b * per) {
    const long long bi = i / per, r = i % per;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      sb += dBp[(bi * nblk + k) * per + r];
      sc += dCp[(bi * nblk + k) * per + r];
    }
    dB[i] = __float2bfloat16_rn(sb);
    dC[i] = __float2bfloat16_rn(sc);
  }
  if (i < (long long)d * n) {
    float s = 0.f;
    for (int bi = 0; bi < b; ++bi) s += dAp[(long long)bi * d * n + i];
    dA[i] = s;
  }
  if (i < d) {
    float s = 0.f, t = 0.f;
    for (int bi = 0; bi < b; ++bi) {
      s += dDp[(long long)bi * d + i];
      t += ddtbp[(long long)bi * d + i];
    }
    dD[i] = s;
    ddtb[i] = t;
  }
}

template <int S>
int launch(const Args& a, int b, cudaStream_t st) {
  constexpr int smem = smem_floats<PARTS * S>() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  scan_bwd_kernel<S><<<dim3((a.d + CH - 1) / CH, b), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// states a lane: n / PARTS, rounded up to a power of two
int states_for(int n) {
  for (int s = 1; s * PARTS <= MAX_N; s *= 2)
    if (n <= s * PARTS) return s;
  return 0;
}

int tokens_for(int n) {
  const int np = PARTS * states_for(n);
  return np <= 16 ? 16 : (np == 32 ? 8 : 4);
}

}  // namespace

// Floats of scratch gf_mamba1_scan_bwd needs: the chunks' entering states
// (b, chunks, n, d), dB's and dC's parts (b, d / 64, L, n) each, dA's
// (b, d, n), dD's and ddt_b's (b, d).
extern "C" long long gf_mamba1_scan_bwd_scratch(int b, int L, int d, int n) {
  const long long nch = (L + tokens_for(n) - 1) / tokens_for(n);
  const long long nblk = (d + CH - 1) / CH;
  return (long long)b * nch * n * d + 2LL * b * nblk * L * n + (long long)b * d * n +
         2LL * b * d;
}

// xc, dt_raw, z: (b, L, d) bf16, last stride 1; B, C: (b, L, n) bf16, last
// stride 1; dy (b, L, d) bf16 contiguous; A (d, n), D, dt_b (d,) f32
// contiguous.  dxc, ddt_raw, dz (b, L, d) and dB, dC (b, L, n) bf16
// contiguous; dA (d, n), dD, ddt_b (d,) f32; scratch of
// gf_mamba1_scan_bwd_scratch floats.  1 <= n <= 64.  Returns
// cudaGetLastError() after the two launches.
extern "C" int gf_mamba1_scan_bwd(
    const void* x, long long sx_b, long long sx_l, const void* dt, long long sdt_b,
    long long sdt_l, const void* z, long long sz_b, long long sz_l, const void* B,
    long long sB_b, long long sB_l, const void* C, long long sC_b, long long sC_l,
    const void* dy, const void* A, const void* D, const void* dt_b, void* dx, void* ddt,
    void* dz, void* dB, void* dC, void* dA, void* dD, void* ddtb, void* scratch, int b,
    int L, int d, int n, void* stream) {
  if (b < 1 || L < 1 || d < 1 || n < 1 || n > MAX_N || b > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nch = (L + tokens_for(n) - 1) / tokens_for(n);
  const int nblk = (d + CH - 1) / CH;
  float* hb = static_cast<float*>(scratch);
  float* dBp = hb + (long long)b * nch * n * d;
  float* dCp = dBp + (long long)b * nblk * L * n;
  float* dAp = dCp + (long long)b * nblk * L * n;
  float* dDp = dAp + (long long)b * d * n;
  float* ddtbp = dDp + (long long)b * d;
  using bf16 = __nv_bfloat16;
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
         static_cast<const bf16*>(z), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const bf16*>(dy),
         static_cast<const float*>(A), static_cast<const float*>(D),
         static_cast<const float*>(dt_b), static_cast<bf16*>(dx), static_cast<bf16*>(ddt),
         static_cast<bf16*>(dz), hb, dBp, dCp, dAp, dDp, ddtbp, sx_b, sx_l, sdt_b, sdt_l,
         sz_b, sz_l, sB_b, sB_l, sC_b, sC_l, L, d, n};
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (states_for(n)) {
    case 1: rc = launch<1>(a, b, st); break;
    case 2: rc = launch<2>(a, b, st); break;
    case 4: rc = launch<4>(a, b, st); break;
    case 8: rc = launch<8>(a, b, st); break;
    default: rc = launch<16>(a, b, st); break;
  }
  if (rc != 0) return rc;
  long long total = (long long)b * L * n;
  if ((long long)d * n > total) total = (long long)d * n;
  scan_bwd_finish<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      dBp, dCp, dAp, dDp, ddtbp, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dA), static_cast<float*>(dD), static_cast<float*>(ddtb), b, L, d,
      n, nblk);
  return (int)cudaGetLastError();
}
