// Mamba1 selective scan for Hopper (sm_90a): CUDA cores, float32 state.
//
// Replaces: src/repro/kernels/selective_scan/kernel.py::_scan_kernel (:23),
//   the Pallas TPU kernel behind selective_scan (pallas_call at :65).  Same
//   function: x/dt (b, L, d), A (d, n), B/C (b, L, n), D (d,), per channel
//     h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t,
//   and, on request, the final state h_L (b, d, n) that prefill keeps.  Any
//   L and d a multiple of the 16-byte vector (4 f32, 8 bf16; the ragged
//   edges are masked), n up to 64.
// The TPU kernel walks a grid of (batch, d/512, L/128) in order and keeps the
//   (512, n) state in VMEM across the sequence axis.  Hopper runs its blocks
//   in no order, so here the sequence axis is a loop inside one CTA and the
//   state lives in registers.
//
// One design, two forms (template flag FUSED):
//   - the reference's interface (FUSED = false): x, dt, B, C in f32, y in f32;
//   - the Mamba1 block's work from the dt_w product to out_proj (FUSED =
//     true), which the model calls: xc, dt_raw, z, B, C in bf16, y in bf16,
//       y = (scan(xc, softplus(dt_raw + dt_b), A, B, C, D) * silu(z)).bf16
//     with PyTorch's softplus (threshold 20).  B, C and z are read through
//     the strided views the projections leave (rows of r + 2n and 2d).
// Yardstick: no single PyTorch call computes either (library_ms is null).
//
// Bound on an H100: at b=4, L=4096, d=8192, n=16 (falcon-mamba-7b's layer at
//   the loss shape) the fused form moves 1.08 GB (xc, dt_raw and z read and y
//   written once, in bf16; B, C, A, dt_b and D are small), 0.32 ms at 3.35
//   TB/s.  The function needs b L d n = 2.15e9 exp for the state and 3 more
//   special-function operations a (token, channel) (the softplus's exp and
//   log; the gate's one, as silu(z) = z/2 (1 + tanh(z/2)) takes a single
//   tanh), 2.55e9 on the special-function units at 16 a clock on each SM
//   (4.19e12/s), 0.61 ms: the operations bound it (chip_smoke.py's
//   fused_scan_bound).  This kernel's gate takes two (ex2, rcp), one more
//   than the bound counts.  The f32 form moves 1.61 GB (0.48 ms) against
//   0.51 ms of exp.
// Design, against what held the first version (2.10 ms, 24% of its bound):
//   - each exp of the state is one FMUL and one ex2.approx: A is scaled by
//     log2(e) once, in registers;
//   - x, dt (and z) move as 16-byte vectors through a two-stage cp.async
//     ring: chunk j+1 of T tokens loads while chunk j is computed, so no
//     chunk's loads stall the CTA; B and C (shared by every channel of a
//     row) are read into registers beside them and stored as f32;
//   - the work per (token, channel) runs once, in a pass over the staged
//     chunk before and after the recurrence, not on every lane of a channel:
//     the dt_b add and softplus and dt*x before it, D*x, the gate and the
//     bf16 cast after it; y is written once, as 16-byte vectors;
//   - a channel is split over PARTS neighbouring lanes that hold n/PARTS
//     states each and add their parts with log2(PARTS) shuffles a token.
//     PARTS, the channels a CTA (CH) and the chunk (T) were chosen by a sweep
//     on the card (PERF.md, the scan's launch-shape sweep).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int PARTS = 2;   // lanes per channel
constexpr int CH = 128;    // channels per CTA
constexpr int T = 32;      // tokens per chunk
constexpr int THREADS = CH * PARTS;
constexpr int MAX_N = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(PARTS >= 1 && PARTS <= 32 && (PARTS & (PARTS - 1)) == 0, "PARTS");
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "THREADS");
static_assert(CH % 8 == 0, "CH");

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
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// PyTorch's softplus (beta 1, threshold 20): v above 20, else log1p(exp(v));
// log1p by its series where exp(v) is small, so that small dt keep their
// relative precision.
__device__ __forceinline__ float softplus(float v) {
  const float e = ex2(v * kLog2e);
  const float lp = e < 1e-2f ? e * (1.f - e * (0.5f - e * (1.f / 3.f)))
                             : kLn2 * lg2(1.f + e);
  return v > 20.f ? v : lp;
}

__device__ __forceinline__ float silu(float v) {
  return v * rcp(1.f + ex2(-v * kLog2e));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* x;    // (b, L, d), rows of stride sx_l, batches of sx_b
  const void* dt;   // (b, L, d)
  const void* z;    // (b, L, d), FUSED only
  const void* B;    // (b, L, n)
  const void* C;    // (b, L, n)
  const float* A;   // (d, n) contiguous
  const float* D;   // (d,)
  const float* dt_b;  // (d,), FUSED only
  void* y;          // (b, L, d) contiguous
  float* h;         // (b, d, n) contiguous, or null
  long long sx_b, sx_l, sdt_b, sdt_l, sz_b, sz_l;  // in elements
  long long sB_b, sB_l, sC_b, sC_l;
  int L, d, n;
};

// Shared memory of one CTA, in bytes, for FUSED and S states a lane.
template <bool FUSED, int S>
constexpr int smem_bytes() {
  using In = std::conditional_t<FUSED, __nv_bfloat16, float>;
  constexpr int NT = FUSED ? 3 : 2;      // staged tensors: x, dt (, z)
  constexpr int NP = PARTS * S;
  return 2 * NT * T * CH * (int)sizeof(In)  // the ring
         + 2 * T * CH * 4                   // dt (after softplus), dt*x then y
         + 2 * 2 * T * NP * 4;              // B, C per stage, f32
}

template <bool FUSED, int S>
__global__ void __launch_bounds__(THREADS) scan_kernel(const Args a) {
  using In = std::conditional_t<FUSED, __nv_bfloat16, float>;
  constexpr int VEC = 16 / sizeof(In);   // elements a 16-byte vector
  constexpr int NT = FUSED ? 3 : 2;
  constexpr int NP = PARTS * S;          // states, padded
  constexpr int RV = CH / VEC;           // vectors a token row of the CTA
  constexpr int NV = T * RV;             // vectors a chunk, per tensor
  constexpr int NBC = (2 * T * NP + THREADS - 1) / THREADS;
  static_assert(THREADS % RV == 0, "a thread keeps its vector column");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* sIn = reinterpret_cast<In*>(smem_raw);                 // [2][NT][T][CH]
  float* sDv = reinterpret_cast<float*>(sIn + 2 * NT * T * CH);  // [T][CH]
  float* sDx = sDv + T * CH;             // [T][CH]: dt*x, then y of the scan
  float* sBC = sDx + T * CH;             // [2][2][T][NP]: B, C per stage

  const int tid = threadIdx.x;
  const int cl = tid / PARTS, part = tid % PARTS;
  const int c0 = blockIdx.x * CH, bi = blockIdx.y;
  const int c = c0 + cl;
  const bool live = c < a.d;
  const int L = a.L, d = a.d, n = a.n;
  const int nchunks = (L + T - 1) / T;

  const In* gx = static_cast<const In*>(a.x) + bi * a.sx_b;
  const In* gdt = static_cast<const In*>(a.dt) + bi * a.sdt_b;
  const In* gz = FUSED ? static_cast<const In*>(a.z) + bi * a.sz_b : nullptr;
  const In* gB = static_cast<const In*>(a.B) + bi * a.sB_b;
  const In* gC = static_cast<const In*>(a.C) + bi * a.sC_b;

  // 16-byte vectors of chunk j into stage st (zeros past L and d)
  auto issue = [&](int j, int st) {
    const int t0 = j * T;
    for (int v = tid; v < NV; v += THREADS) {
      const int t = v / RV, cc = (v % RV) * VEC;
      const bool in = t0 + t < L && c0 + cc < d;
      const long long tt = in ? t0 + t : 0;
      const int col = in ? c0 + cc : 0;
      In* dst = sIn + ((st * NT) * T + t) * CH + cc;
      cp_async16(dst, gx + tt * a.sx_l + col, in);
      cp_async16(dst + T * CH, gdt + tt * a.sdt_l + col, in);
      if constexpr (FUSED) cp_async16(dst + 2 * T * CH, gz + tt * a.sz_l + col, in);
    }
    cp_async_commit();
  };
  // B and C of chunk j into registers (entry i: B then C, token-major)
  float bc[NBC];
  auto load_bc = [&](int j) {
    const int t0 = j * T;
#pragma unroll
    for (int i = 0; i < NBC; ++i) {
      const int idx = tid + i * THREADS;
      const int which = idx / (T * NP), r = idx % (T * NP);
      const int t = r / NP, k = r % NP;
      float v = 0.f;
      if (idx < 2 * T * NP && t0 + t < L && k < n)
        v = which == 0 ? to_f(gB[(long long)(t0 + t) * a.sB_l + k])
                       : to_f(gC[(long long)(t0 + t) * a.sC_l + k]);
      bc[i] = v;
    }
  };
  auto store_bc = [&](int st) {
#pragma unroll
    for (int i = 0; i < NBC; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < 2 * T * NP) sBC[st * 2 * T * NP + idx] = bc[i];
    }
  };

  issue(0, 0);
  load_bc(0);
  store_bc(0);

  // the passes before and after the recurrence: before it, thread tid takes
  // channel column pc of every PARTS-th token (consecutive threads on
  // consecutive words); after it, the 16-byte vector at column vcol
  const int pc = tid % CH;
  const float dtb = (FUSED && c0 + pc < d) ? a.dt_b[c0 + pc] : 0.f;
  const int vcol = (tid % RV) * VEC;
  float dreg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) dreg[i] = c0 + vcol + i < d ? a.D[c0 + vcol + i] : 0.f;

  // this lane's states k = part * S + j; padded states have A = 0 and
  // B = C = 0, so they stay 0 and add nothing
  float a2[S], h[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = part * S + j;
    a2[j] = (live && k < n) ? a.A[(long long)c * n + k] * kLog2e : 0.f;
    h[j] = 0.f;
  }

  for (int j = 0; j < nchunks; ++j) {
    const int st = j & 1;
    const int q = min(T, L - j * T);   // live tokens of this chunk
    cp_async_wait_all();
    __syncthreads();   // chunk j staged, its B and C stored; stage st^1 free
    if (j + 1 < nchunks) {
      issue(j + 1, st ^ 1);
      load_bc(j + 1);
    }
    const In* sx = sIn + (st * NT) * T * CH;
    const In* sdt = sx + T * CH;

    // before the recurrence: dt (softplus of dt_raw + dt_b) and dt*x
    for (int t = tid / CH; t < q; t += PARTS) {
      float dv = to_f(sdt[t * CH + pc]);
      if constexpr (FUSED) dv = softplus(dv + dtb);
      sDv[t * CH + pc] = dv;
      sDx[t * CH + pc] = dv * to_f(sx[t * CH + pc]);
    }
    __syncthreads();

    // the recurrence; q is the same for the whole CTA, so every lane
    // reaches the shuffles
    const float* sB = sBC + st * 2 * T * NP + part * S;
    const float* sC = sB + T * NP;
    for (int t = 0; t < q; ++t) {
      const float dv = sDv[t * CH + cl], dx = sDx[t * CH + cl];
      float bv[S], cv[S];
      if constexpr (S % 4 == 0) {
#pragma unroll
        for (int j4 = 0; j4 < S; j4 += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(sB + t * NP + j4);
          const float4 c4 = *reinterpret_cast<const float4*>(sC + t * NP + j4);
          bv[j4] = b4.x; bv[j4 + 1] = b4.y; bv[j4 + 2] = b4.z; bv[j4 + 3] = b4.w;
          cv[j4] = c4.x; cv[j4 + 1] = c4.y; cv[j4 + 2] = c4.z; cv[j4 + 3] = c4.w;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < S; ++jj) {
          bv[jj] = sB[t * NP + jj];
          cv[jj] = sC[t * NP + jj];
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int jj = 0; jj < S; ++jj) {
        h[jj] = fmaf(ex2(dv * a2[jj]), h[jj], dx * bv[jj]);
        acc = fmaf(h[jj], cv[jj], acc);
      }
#pragma unroll
      for (int off = PARTS / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      // every lane of the channel read dt*x before the shuffles
      if (part == 0) sDx[t * CH + cl] = acc;
    }
    __syncthreads();

    // after the recurrence: D*x, the gate, the cast; y once, in 16 bytes
    const In* sz = sx + 2 * T * CH;
    for (int v = tid; v < T * RV; v += THREADS) {
      const int t = v / RV;
      if (t >= q) break;
      if (c0 + vcol >= d) continue;
      const In* px = sx + t * CH + vcol;
      const long long row = (long long)bi * L + j * T + t;
      float ys[VEC];
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 y4 = *reinterpret_cast<const float4*>(sDx + t * CH + vcol + i);
        ys[i] = y4.x; ys[i + 1] = y4.y; ys[i + 2] = y4.z; ys[i + 3] = y4.w;
      }
      alignas(16) In out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float yv = ys[i] + to_f(px[i]) * dreg[i];
        if constexpr (FUSED) {
          yv = yv * silu(to_f(sz[t * CH + vcol + i]));
          out[i] = __float2bfloat16_rn(yv);
        } else {
          out[i] = yv;
        }
      }
      *reinterpret_cast<uint4*>(static_cast<In*>(a.y) + row * d + c0 + vcol) =
          *reinterpret_cast<const uint4*>(out);
    }
    if (j + 1 < nchunks) store_bc(st ^ 1);
  }

  if (a.h != nullptr && live) {
#pragma unroll
    for (int jj = 0; jj < S; ++jj) {
      const int k = part * S + jj;
      if (k < n) a.h[((long long)bi * d + c) * n + k] = h[jj];
    }
  }
}

template <bool FUSED, int S>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr int smem = smem_bytes<FUSED, S>();
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<FUSED, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.d + CH - 1) / CH, b);
  scan_kernel<FUSED, S><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(const Args& a, int b, cudaStream_t st) {
  const int per = (a.n + PARTS - 1) / PARTS;
  if (per <= 1) return launch<FUSED, 1>(a, b, st);
  if (per <= 2) return launch<FUSED, 2>(a, b, st);
  if (per <= 4) return launch<FUSED, 4>(a, b, st);
  if (per <= 8) return launch<FUSED, 8>(a, b, st);
  if constexpr (MAX_N / PARTS >= 16) {
    if (per <= 16) return launch<FUSED, 16>(a, b, st);
  }
  if constexpr (MAX_N / PARTS >= 32) {
    if (per <= 32) return launch<FUSED, 32>(a, b, st);
  }
  if constexpr (MAX_N / PARTS >= 64) {
    if (per <= 64) return launch<FUSED, 64>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fused != 0: xc, dt_raw, z, B, C bf16, y bf16, dt_b f32; else x, dt, B, C
// and y f32 and z, dt_b unused.  A (d, n), D (d,) f32 contiguous; y (b, L,
// d) contiguous; h (b, d, n) f32 or null.  x, dt, z: 16-byte aligned, the
// last stride 1 and the others (in elements) multiples of the 16-byte
// vector; B, C: the last stride 1.  L >= 1, 1 <= n <= 64, d a multiple of
// the vector.  Returns a CUDA error code (0 when the launch was taken).
extern "C" int gf_mamba1_scan(
    int fused, const void* x, long long sx_b, long long sx_l, const void* dt,
    long long sdt_b, long long sdt_l, const void* z, long long sz_b,
    long long sz_l, const void* B, long long sB_b, long long sB_l,
    const void* C, long long sC_b, long long sC_l, const void* A,
    const void* D, const void* dt_b, void* y, void* h, int b, int L, int d,
    int n, void* stream) {
  const int vec = fused ? 8 : 4;
  if (b < 1 || L < 1 || d < 1 || n < 1 || n > MAX_N || b > 65535 || d % vec)
    return (int)cudaErrorInvalidValue;
  Args a{x, dt, z, B, C, static_cast<const float*>(A),
         static_cast<const float*>(D), static_cast<const float*>(dt_b), y,
         static_cast<float*>(h), sx_b, sx_l, sdt_b, sdt_l, sz_b, sz_l,
         sB_b, sB_l, sC_b, sC_l, L, d, n};
  auto st = static_cast<cudaStream_t>(stream);
  return fused ? dispatch<true>(a, b, st) : dispatch<false>(a, b, st);
}
