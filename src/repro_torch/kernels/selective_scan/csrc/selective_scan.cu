// Mamba1 selective scan for Hopper (sm_90a): CUDA cores, float32.
//
// Replaces: src/repro/kernels/selective_scan/kernel.py::_scan_kernel (:23),
//   the Pallas TPU kernel behind selective_scan (pallas_call at :65).  Same
//   function: x/dt (b, L, d), A (d, n), B/C (b, L, n), D (d,), per channel
//     h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t,
//   and, on request, the final state h_L (b, d, n) that prefill keeps.  Any
//   L and d (the ragged edges are masked), n up to 64.
// The TPU kernel walks a grid of (batch, d/512, L/128) in order and keeps the
//   (512, n) state in VMEM across the sequence axis.  Hopper runs its blocks
//   in no order, so here the sequence axis is a loop inside one CTA and the
//   state lives in registers.
// Yardstick: no single PyTorch call computes it (library_ms is null).
// Bound on an H100: at b=4, L=4096, d=8192, n=16 (falcon-mamba-7b's layer
//   at the loss shape) it moves ~1.61 GB (x, dt and y in f32; B, C, A and D
//   are small), 0.48 ms at 3.35 TB/s.  It takes b L d n = 2.15e9 exp, one
//   MUFU.EX2 each on the special-function units (16 a clock on each SM: 16 x
//   132 SMs x 1.98 GHz = 4.19e12/s, a sixteenth of the f32 FMA rate, as
//   chip_smoke.py's scan_bound counts it), 0.51 ms, and ~6 f32 operations
//   per (token, channel, state),
//   1.3e10, 0.19 ms at 67 TFLOP/s.  Bytes and exps set the pace at the same
//   order; the chain through h is one FMA a token.
// This first design: a CTA of 256 threads owns 64 channels of one batch row;
//   each channel is split over 4 neighbouring lanes that hold n/4 states
//   each (4 at n = 16), so the loss shape runs 131,072 threads, ~31 warps an
//   SM, enough to hide the dependent chain and the MUFU latency.  Chunks of
//   32 tokens of x and dt are staged in shared memory by coalesced row loads
//   (neighbouring threads on neighbouring channels); B_t and C_t, shared by
//   every channel of the row, are staged beside them; y is reduced over the
//   4 lanes with two warp shuffles, gathered in shared memory and written
//   back in rows.  Left for later: exp2 with A pre-scaled by log2(e), double
//   buffering of the chunks (cp.async or TMA), and a chunked parallel form
//   on the tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PARTS = 4;                  // lanes per channel
constexpr int CH = THREADS / PARTS;       // channels per CTA
constexpr int T = 32;                     // tokens staged per chunk
constexpr int MAX_N = 64;                 // PARTS x the largest S below

template <int S>   // states per lane; the state is padded to PARTS * S
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ D,
            float* __restrict__ y, float* __restrict__ hout, int L, int d,
            int n) {
  constexpr int NP = PARTS * S;
  __shared__ float sX[T][CH];
  __shared__ float sDt[T][CH];
  __shared__ float sY[T][CH];
  __shared__ float sB[T][NP];
  __shared__ float sC[T][NP];

  const int tid = threadIdx.x;
  const int cl = tid / PARTS, part = tid % PARTS;
  const int c0 = blockIdx.x * CH, bi = blockIdx.y;
  const int c = c0 + cl;
  const bool live = c < d;

  // this lane's states k = part * S + j; padded states have A = 0 and
  // B = C = 0, so they stay 0 and add nothing
  float a[S], h[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = part * S + j;
    a[j] = (live && k < n) ? A[(long)c * n + k] : 0.f;
    h[j] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  const long row0 = (long)bi * L;

  for (int t0 = 0; t0 < L; t0 += T) {
    const int q = min(T, L - t0);   // live tokens of this chunk
    for (int idx = tid; idx < T * CH; idx += THREADS) {
      const int t = idx / CH, cc = idx % CH;
      const bool in = t < q && c0 + cc < d;
      const long g = (row0 + t0 + t) * d + c0 + cc;
      sX[t][cc] = in ? x[g] : 0.f;
      sDt[t][cc] = in ? dt[g] : 0.f;
    }
    for (int idx = tid; idx < T * NP; idx += THREADS) {
      const int t = idx / NP, k = idx % NP;
      const bool in = t < q && k < n;
      const long g = (row0 + t0 + t) * n + k;
      sB[t][k] = in ? Bm[g] : 0.f;
      sC[t][k] = in ? Cm[g] : 0.f;
    }
    __syncthreads();

    // q is the same for the whole CTA, so every lane reaches the shuffles
    for (int t = 0; t < q; ++t) {
      const float xv = sX[t][cl], dv = sDt[t][cl];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = part * S + j;
        h[j] = fmaf(expf(dv * a[j]), h[j], dx * sB[t][k]);
        acc = fmaf(h[j], sC[t][k], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) sY[t][cl] = fmaf(dd, xv, acc);
    }
    __syncthreads();

    for (int idx = tid; idx < T * CH; idx += THREADS) {
      const int t = idx / CH, cc = idx % CH;
      if (t < q && c0 + cc < d) y[(row0 + t0 + t) * d + c0 + cc] = sY[t][cc];
    }
    // the next chunk's staging writes only buffers that the compute loop
    // above read, and every lane has passed the barrier after that loop
  }

  if (hout != nullptr && live) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = part * S + j;
      if (k < n) hout[((long)bi * d + c) * n + k] = h[j];
    }
  }
}

template <int S>
void launch(const float* x, const float* dt, const float* A, const float* B,
            const float* C, const float* D, float* y, float* h, int b, int L,
            int d, int n, cudaStream_t stream) {
  const dim3 grid((d + CH - 1) / CH, b);
  scan_kernel<S><<<grid, THREADS, 0, stream>>>(x, dt, A, B, C, D, y, h, L, d, n);
}

}  // namespace

// x, dt (b, L, d); A (d, n); B, C (b, L, n); D (d,); y (b, L, d); h (b, d, n)
// or null: float32, contiguous.  L >= 1, 1 <= n <= 64.  Returns
// cudaGetLastError().
extern "C" int gf_selective_scan(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, const void* D,
                                 void* y, void* h, int b, int L, int d, int n,
                                 void* stream) {
  if (b < 1 || L < 1 || d < 1 || n < 1 || n > MAX_N || b > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(B);
  const auto* Cf = static_cast<const float*>(C);
  const auto* Df = static_cast<const float*>(D);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(h);
  auto st = static_cast<cudaStream_t>(stream);
  const int per = (n + PARTS - 1) / PARTS;
  if (per <= 1)
    launch<1>(xf, dtf, Af, Bf, Cf, Df, yf, hf, b, L, d, n, st);
  else if (per <= 2)
    launch<2>(xf, dtf, Af, Bf, Cf, Df, yf, hf, b, L, d, n, st);
  else if (per <= 4)
    launch<4>(xf, dtf, Af, Bf, Cf, Df, yf, hf, b, L, d, n, st);
  else if (per <= 8)
    launch<8>(xf, dtf, Af, Bf, Cf, Df, yf, hf, b, L, d, n, st);
  else
    launch<16>(xf, dtf, Af, Bf, Cf, Df, yf, hf, b, L, d, n, st);
  return (int)cudaGetLastError();
}
