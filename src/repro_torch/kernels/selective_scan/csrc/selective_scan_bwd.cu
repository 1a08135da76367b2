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
// The state h and its gradient dh are linear recurrences, so the sequence
//   is cut into segments of SEG = 512 tokens that run in parallel.  With
//   a_t = exp(delta_t A) and g_t = dy_t silu(z_t), four launches:
//   1. scan_bwd_local_kernel, one CTA per (64 channels, segment, batch row):
//      the segment's states from a zero start, saved at the start of every
//      chunk of T tokens with the sum of delta before it, and at its end;
//      the segment's decay P = prod a_t and its reverse recurrence's carry
//      out of a zero start, sum_t (prod_{u <= t} a_u) g_t C_t, in the same
//      forward walk.
//   2. scan_bwd_carry_kernel, one thread per (batch row, channel, state):
//      H_{s+1} = P_s H_s + h_end_s over the segments and
//      R_{s-1} = P_s R_s + carry_s in reverse: the state entering each
//      segment and the state's gradient arriving at its end.
//   3. scan_bwd_seg_kernel, the same CTAs: the segment's chunks in reverse.
//      A chunk's entering state is its saved local state plus
//      exp(A sum delta) H_s; its states are recomputed forward (the
//      decays kept in registers, the states in shared memory), the scan's
//      output gives the gate's gradient dz, dC's part sums g_t h_t over the
//      CTA's channels; then the reverse recurrence from R_s,
//        dh_t = a_{t+1} dh_{t+1} + g_t C_t,
//        dxc_t = delta_t (dh_t . B_t) + D g_t,
//        ddelta_t = dh_t . (A a_t h_{t-1}) + xc_t (dh_t . B_t),
//        dA += dh_t delta_t a_t h_{t-1},
//      the softplus's derivative e / (1 + e) of its own exp (1 above
//      PyTorch's threshold 20), and dB's part, sum_c dh_t delta_t xc_t.
//   4. scan_bwd_finish: dB and dC summed over the CTAs' parts in channel-
//      block order and cast to bf16; dA, dD and ddt_b summed over the
//      (batch row, segment) parts in order.  So a call gives the same bits
//      every time.
// Design, against what held this kernel's first version (7.1 ms at
//   falcon-mamba's microbatch) back:
//   - 8x the CTAs: 2,048 at falcon-mamba's microbatch (256 before, each
//     walking the whole sequence alone, its loads on the dependent chain);
//     segments of 256 and 128 tokens measured 2% and 7% slower;
//   - the state's exp twice a (token, channel, state), once in each walk
//     (three times before): the final pass's recompute keeps its decays in
//     registers (T x n/4 a lane) for the reverse recurrence;
//   - a chunk's inputs (xc, dt_raw, z, dy, B, C in bf16) copied into shared
//     memory by 16-byte cp.async while the chunk before is computed, so no
//     chunk waits on its loads (the staging's exposed loads were the
//     largest cost of this design's first version);
//   - the work a (token, channel) once a channel, in a pass over the staged
//     chunk (the softplus and its slope, sigmoid(z), dy silu(z), the gate's
//     derivative; z, dy and dt_raw loaded once a token), not on each lane;
//   - dB's and dC's sums over a warp's 8 channels by halving exchanges of
//     shuffles (4 a token for n = 16), the warps' parts added after one
//     barrier; no shared-memory state read across threads, so three
//     __syncthreads a chunk (four before);
//   - straight-line chunks: a token past the sequence's end is staged as
//     zeros (decay 1, nothing added), so every chunk runs all T tokens
//     unrolled with no per-token branch, and B, C and the saved states
//     move as 16-byte vectors;
//   - dh . B and the decay term summed over a channel's lanes by one
//     halving exchange and a shuffle (four shuffles before); dxc, ddt_raw
//     and dz gathered in shared memory and stored after the chunk by every
//     thread, consecutive threads on consecutive channels (one lane in
//     four stored 2-byte values before).
//   Four lanes a channel (n/4 states each, their sums by two shuffles),
//   64 channels and 256 threads a CTA; the state's exp is one FMUL and one
//   ex2.approx, as in the forward.
// Left for later: part of the state's exps as a polynomial on the FMA
//   pipes, the boundary states written by the forward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 64;          // channels per CTA
constexpr int PARTS = 4;        // lanes per channel, n / PARTS states each
constexpr int THREADS = CH * PARTS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 64;
constexpr int SEG = 512;        // tokens a segment (a multiple of every T)
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

__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + ex2(-v * kLog2e));
}

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
  float* hb;                  // (b, chunks, n, d): local states entering each chunk
  float* cd;                  // (b, chunks, d): the segment's delta summed before it
  float* hend;                // (b, segs, n, d): local end states, then entering states
  float* pseg;                // (b, segs, n, d): the segments' decays
  float* rout;                // (b, segs, n, d): carries out, then gradients arriving
  float* dBp;                 // (b, nblk, L, n): the CTAs' parts
  float* dCp;
  float* dAp;                 // (b, segs, d, n)
  float* dDp;                 // (b, segs, d)
  float* ddtbp;               // (b, segs, d)
  long long sx_b, sx_l, sdt_b, sdt_l, sz_b, sz_l, sB_b, sB_l, sC_b, sC_l;
  int L, d, n;
  bool vec_x, vec_bc;   // xc, dt_raw, z, dy (B, C) rows copy as 16-byte vectors
};

// tokens a chunk for NP states a channel: the final pass keeps T x NP / 4
// decays a lane in registers (at most 64)
template <int NP>
__host__ __device__ constexpr int chunk_tokens() { return NP <= 16 ? 16 : (NP == 32 ? 8 : 4); }

// the raw bf16 inputs of a chunk: xc, dt_raw, z, dy [T][CH], B, C [T][NP]
template <int NP>
constexpr int raw_floats() {
  return 2 * chunk_tokens<NP>() * CH + chunk_tokens<NP>() * NP;
}

template <int NP>
constexpr int local_smem_floats() {
  return 2 * chunk_tokens<NP>() * NP + 3 * chunk_tokens<NP>() * CH + raw_floats<NP>();
}

template <int NP>
constexpr int seg_smem_floats() {
  constexpr int T = chunk_tokens<NP>();
  return (T - 1) * NP / PARTS * THREADS   // each lane's states h_0 .. h_{T-2}
         + 2 * T * NP                     // B, C of the chunk
         + 5 * T * CH                     // the per-(token, channel) values
         + 2 * WARPS * T * NP             // dB's and dC's parts of each warp
         + raw_floats<NP>();              // the next chunk's raw inputs
}

// the sum of v over a channel's PARTS lanes (neighbours), in a fixed order
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = 1; off < PARTS; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// one exchange of warp_channel_sum: with V >= 2 values left, the lane
// keeps the half its bit OFF picks and adds its partner's half of it
template <int S, int V, int OFF>
__device__ __forceinline__ void exchange(float (&w)[S], int& base, int lane) {
  if constexpr (V >= 2) {
    constexpr int H = V / 2;
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? w[i] : w[i + H];
      const float keep = up ? w[i + H] : w[i];
      w[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    if (up) base += H;
  } else {
    w[0] += __shfl_xor_sync(kFull, w[0], OFF);
  }
}

// v[j] summed over the warp's 8 channels (the lanes that share this lane's
// part: lane bits 2-4) for each of the lane's S states, into
// out[part * S + j]: S/2 + S/4 + ... shuffles, each lane keeping the half
// of the values its bit picks; where one value is left the pair adds it,
// and the lanes whose unused bits are zero write
template <int S>
__device__ __forceinline__ void warp_channel_sum(const float (&v)[S], float* out, int part) {
  const int lane = threadIdx.x & 31;
  float w[S];
#pragma unroll
  for (int j = 0; j < S; ++j) w[j] = v[j];
  int base = 0;
  constexpr int V1 = S >= 2 ? S / 2 : 1, V2 = V1 >= 2 ? V1 / 2 : 1, V3 = V2 >= 2 ? V2 / 2 : 1;
  exchange<S, S, 16>(w, base, lane);
  exchange<S, V1, 8>(w, base, lane);
  exchange<S, V2, 4>(w, base, lane);
  constexpr int unused = (S < 2 ? 16 : 0) | (S < 4 ? 8 : 0) | (S < 8 ? 4 : 0);
  if ((lane & unused) == 0) {
#pragma unroll
    for (int i = 0; i < V3; ++i) out[part * S + base + i] = w[i];
  }
}

// the lane's S consecutive values at p (16-byte vectors where S allows)
template <int S>
__device__ __forceinline__ void load_s(float (&v)[S], const float* p) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int m = 0; m < S / 4; ++m) {
      const float4 q = reinterpret_cast<const float4*>(p)[m];
      v[4 * m] = q.x;
      v[4 * m + 1] = q.y;
      v[4 * m + 2] = q.z;
      v[4 * m + 3] = q.w;
    }
  } else if constexpr (S == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// a lane's S states of token t in the final pass's private array: groups
// of 4 states, each group's lanes side by side (conflict-free 16-byte
// accesses); below 4 states a lane's states side by side
template <int S>
__device__ __forceinline__ float* state_slot(float* sH, int t, int tid, int m) {
  if constexpr (S % 4 == 0)
    return sH + ((t * (S / 4) + m) * THREADS + tid) * 4;
  else
    return sH + (t * THREADS + tid) * S;
}

template <int S>
__device__ __forceinline__ void store_states(float* sH, int t, int tid, const float (&h)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int m = 0; m < S / 4; ++m)
      *reinterpret_cast<float4*>(state_slot<S>(sH, t, tid, m)) =
          make_float4(h[4 * m], h[4 * m + 1], h[4 * m + 2], h[4 * m + 3]);
  } else if constexpr (S == 2) {
    *reinterpret_cast<float2*>(state_slot<S>(sH, t, tid, 0)) = make_float2(h[0], h[1]);
  } else {
    *state_slot<S>(sH, t, tid, 0) = h[0];
  }
}

template <int S>
__device__ __forceinline__ void load_states(float (&h)[S], float* sH, int t, int tid) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int m = 0; m < S / 4; ++m) {
      float v[4];
      load_s<4>(v, state_slot<S>(sH, t, tid, m));
#pragma unroll
      for (int e = 0; e < 4; ++e) h[4 * m + e] = v[e];
    }
  } else {
    load_s<S>(h, state_slot<S>(sH, t, tid, 0));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A chunk's raw inputs in shared memory, bf16 as they are in global memory:
// xc, dt_raw, z, dy [T][CH] and B, C [T][NP]
template <int NP>
struct Raw {
  static constexpr int T = chunk_tokens<NP>();
  __nv_bfloat16 *x, *dt, *z, *dy, *B, *C;
  __device__ Raw(float* base) {
    x = reinterpret_cast<__nv_bfloat16*>(base);
    dt = x + T * CH;
    z = dt + T * CH;
    dy = z + T * CH;
    B = dy + T * CH;
    C = B + T * NP;
  }
  static constexpr int floats = 2 * T * CH + T * NP;
};

// Copies the chunk at t0 (q live tokens) into raw: rows past q and
// channels past d zero.  16-byte cp.async copies where the rows allow
// (a.vec_x, a.vec_bc), so the copies fly while the previous chunk is
// computed; plain loads otherwise.  B's and C's columns past n are zeroed
// once by the caller.
template <int NP>
__device__ __forceinline__ void fetch_raw(const Args& a, const Raw<NP>& raw, int bi, int blk,
                                          int t0, int q) {
  constexpr int T = Raw<NP>::T, V = CH / 8;
  const int tid = threadIdx.x, c0 = blk * CH;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  if (a.vec_x) {
    for (int i = tid; i < 4 * T * V; i += THREADS) {
      const int w = i / (T * V), t = i / V % T, v = i % V, cg = c0 + 8 * v;
      const bool in = t < q && cg < a.d;
      const long long r = t0 + t;
      const __nv_bfloat16* src = w == 0 ? a.x + bi * a.sx_b + r * a.sx_l
                               : w == 1 ? a.dt + bi * a.sdt_b + r * a.sdt_l
                               : w == 2 ? a.z + bi * a.sz_b + r * a.sz_l
                                        : a.dy + (bi * (long long)a.L + r) * a.d;
      __nv_bfloat16* dst = w == 0 ? raw.x : w == 1 ? raw.dt : w == 2 ? raw.z : raw.dy;
      cp_async16(dst + t * CH + 8 * v, in ? src + cg : a.x, in);
    }
  } else {
    for (int i = tid; i < T * CH; i += THREADS) {
      const int t = i / CH, cg = c0 + i % CH;
      const bool in = t < q && cg < a.d;
      const long long r = t0 + t;
      raw.x[i] = in ? a.x[bi * a.sx_b + r * a.sx_l + cg] : zero;
      raw.dt[i] = in ? a.dt[bi * a.sdt_b + r * a.sdt_l + cg] : zero;
      raw.z[i] = in ? a.z[bi * a.sz_b + r * a.sz_l + cg] : zero;
      raw.dy[i] = in ? a.dy[(bi * (long long)a.L + r) * a.d + cg] : zero;
    }
  }
  if (a.vec_bc) {
    const int vb = a.n / 8;
    for (int i = tid; i < 2 * T * vb; i += THREADS) {
      const int w = i / (T * vb), t = i / vb % T, v = i % vb;
      const bool in = t < q;
      const long long r = t0 + t;
      const __nv_bfloat16* src = w == 0 ? a.B + bi * a.sB_b + r * a.sB_l
                                        : a.C + bi * a.sC_b + r * a.sC_l;
      cp_async16((w == 0 ? raw.B : raw.C) + t * NP + 8 * v, in ? src + 8 * v : a.B, in);
    }
  } else {
    for (int i = tid; i < T * NP; i += THREADS) {
      const int t = i / NP, k = i % NP;
      const bool in = t < q && k < a.n;
      const long long r = t0 + t;
      raw.B[i] = in ? a.B[bi * a.sB_b + r * a.sB_l + k] : zero;
      raw.C[i] = in ? a.C[bi * a.sC_b + r * a.sC_l + k] : zero;
    }
  }
  cp_async_commit();
}

// The chunk's per-(token, channel) values from its raw inputs, once a
// channel, consecutive threads on consecutive channels: delta =
// softplus(dt_raw + dt_b) (the forward's softplus, csrc/selective_scan.cu)
// into sDel, xc into sU (delta xc where !FINAL), g = dy silu(z) into sG;
// where FINAL also the gate's derivative dy sigmoid(z) (1 + z (1 -
// sigmoid(z))) into sGd and the softplus's slope into sSp.  A channel past
// d and a token past q get zeros, so the recurrences run every token of
// the chunk: a token of zeros has decay 1 and adds nothing.  B and C into
// sB, sC as f32.  dtb: dt_b of this thread's channel (blk * CH + tid % CH).
template <int NP, bool FINAL>
__device__ __forceinline__ void convert_raw(const Args& a, const Raw<NP>& raw, int blk, int q,
                                            float dtb, float* sB, float* sC, float* sDel,
                                            float* sU, float* sG, float* sGd, float* sSp) {
  constexpr int T = Raw<NP>::T;
  const int tid = threadIdx.x;
  for (int i = tid; i < T * NP; i += THREADS) {
    sB[i] = __bfloat162float(raw.B[i]);
    sC[i] = __bfloat162float(raw.C[i]);
  }
  const bool lv = blk * CH + tid % CH < a.d;
  for (int i = tid; i < T * CH; i += THREADS) {
    if (i / CH >= q || !lv) {
      sDel[i] = sU[i] = sG[i] = 0.f;
      if (FINAL) sGd[i] = sSp[i] = 0.f;
      continue;
    }
    const float v = __bfloat162float(raw.dt[i]) + dtb;
    const float e = ex2(v * kLog2e);
    const float lp = e < 1e-2f ? e * (1.f - e * (0.5f - e * (1.f / 3.f)))
                               : kLn2 * lg2(1.f + e);
    const float delta = v > 20.f ? v : lp;
    const float u = __bfloat162float(raw.x[i]);
    const float zv = __bfloat162float(raw.z[i]);
    const float sz = sigmoid(zv);
    const float gy = __bfloat162float(raw.dy[i]);
    sDel[i] = delta;
    sU[i] = FINAL ? u : delta * u;
    sG[i] = gy * zv * sz;
    if (FINAL) {
      sGd[i] = gy * sz * (1.f + zv * (1.f - sz));
      sSp[i] = v > 20.f ? 1.f : __fdividef(e, 1.f + e);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS) scan_bwd_local_kernel(const Args a) {
  constexpr int NP = PARTS * S;
  constexpr int T = chunk_tokens<NP>();
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;              // [T][NP]
  float* sC = sB + T * NP;       // [T][NP]
  float* sDel = sC + T * NP;     // [T][CH] delta
  float* sDu = sDel + T * CH;    // [T][CH] delta xc
  float* sG = sDu + T * CH;      // [T][CH] dy silu(z)
  const Raw<NP> raw(sG + T * CH);

  const int tid = threadIdx.x, blk = blockIdx.x, seg = blockIdx.y, bi = blockIdx.z;
  const int cl = tid / PARTS, part = tid % PARTS;
  const int c = blk * CH + cl;
  const bool live = c < a.d;
  const int L = a.L, d = a.d, n = a.n;
  const int nch = (L + T - 1) / T, nseg = gridDim.y;
  const int s0 = seg * SEG, s1 = min(L, s0 + SEG);
  const int mc = blk * CH + tid % CH;   // the staging's channel
  const float dtb = mc < d ? a.dt_b[mc] : 0.f;

  float a2[S], h[S], P[S], Lb[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = part * S + j;
    a2[j] = (live && k < n) ? a.A[(long long)c * n + k] * kLog2e : 0.f;
    h[j] = 0.f;
    P[j] = 1.f;
    Lb[j] = 0.f;
  }
  float cum = 0.f;   // the channel's delta summed over the segment so far

  for (int i = tid; i < T * NP; i += THREADS) raw.B[i] = raw.C[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  fetch_raw<NP>(a, raw, bi, blk, s0, min(T, s1 - s0));
  for (int t0 = s0; t0 < s1; t0 += T) {
    const int q = min(T, s1 - t0), jg = t0 / T;
    if (live) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = part * S + j;
        if (k < n) a.hb[((long long)bi * nch + jg) * n * d + (long long)k * d + c] = h[j];
      }
      if (part == 0) a.cd[((long long)bi * nch + jg) * d + c] = cum;
    }
    cp_async_wait_all();
    __syncthreads();   // the chunk's copies are in; the last chunk's readers are done
    convert_raw<NP, false>(a, raw, blk, q, dtb, sB, sC, sDel, sDu, sG, nullptr, nullptr);
    __syncthreads();
    if (t0 + T < s1) fetch_raw<NP>(a, raw, bi, blk, t0 + T, min(T, s1 - t0 - T));
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float dv = sDel[t * CH + cl], du = sDu[t * CH + cl], gg = sG[t * CH + cl];
      float bv[S], cv[S];
      load_s<S>(bv, sB + t * NP + part * S);
      load_s<S>(cv, sC + t * NP + part * S);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float ak = ex2(dv * a2[j]);
        h[j] = fmaf(ak, h[j], du * bv[j]);
        P[j] *= ak;
        Lb[j] = fmaf(P[j], gg * cv[j], Lb[j]);
      }
      cum += dv;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = part * S + j;
      if (k < n) {
        const long long o = ((long long)bi * nseg + seg) * n * d + (long long)k * d + c;
        a.hend[o] = h[j];
        a.pseg[o] = P[j];
        a.rout[o] = Lb[j];
      }
    }
  }
}

// over the segments, one lane per (batch row, state, channel): hend's local
// end states become the states entering each segment and rout's carries
// the gradients arriving at each segment's end
__global__ void __launch_bounds__(256)
scan_bwd_carry_kernel(float* __restrict__ hend, const float* __restrict__ pseg,
                      float* __restrict__ rout, long long lanes, int nseg, long long per) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= lanes) return;
  const long long base = (i / per) * nseg * per + i % per;
  float H = 0.f, R = 0.f;
  for (int s = 0; s < nseg; ++s) {
    const long long o = base + s * per;
    const float v = hend[o];
    hend[o] = H;
    H = fmaf(pseg[o], H, v);
  }
  for (int s = nseg - 1; s >= 0; --s) {
    const long long o = base + s * per;
    const float v = rout[o];
    rout[o] = R;
    R = fmaf(pseg[o], R, v);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 2) scan_bwd_seg_kernel(const Args a) {
  constexpr int NP = PARTS * S;
  constexpr int T = chunk_tokens<NP>();
  extern __shared__ __align__(16) float smem[];
  float* sH = smem;                          // each lane's h_0 .. h_{T-2} (state_slot)
  float* sB = sH + (T - 1) * S * THREADS;    // [T][NP]
  float* sC = sB + T * NP;                   // [T][NP]
  float* sDel = sC + T * NP;                 // [T][CH] delta
  float* sU = sDel + T * CH;                 // [T][CH] xc
  float* sG = sU + T * CH;                   // [T][CH] dy silu(z), then dxc
  float* sGd = sG + T * CH;                  // [T][CH] the gate's derivative, then dz
  float* sSp = sGd + T * CH;                 // [T][CH] the softplus's slope, then ddt_raw
  float* sPB = sSp + T * CH;                 // [WARPS][T][NP] dB's part of each warp
  float* sPC = sPB + WARPS * T * NP;         // [WARPS][T][NP] dC's
  const Raw<NP> raw(sPC + WARPS * T * NP);

  const int tid = threadIdx.x, blk = blockIdx.x, seg = blockIdx.y, bi = blockIdx.z;
  const int cl = tid / PARTS, part = tid % PARTS, warp = tid >> 5;
  const int c = blk * CH + cl;
  const bool live = c < a.d;
  const int L = a.L, d = a.d, n = a.n;
  const int nch = (L + T - 1) / T, nseg = gridDim.y, nblk = gridDim.x;
  const int s0 = seg * SEG, s1 = min(L, s0 + SEG);
  const int mc = blk * CH + tid % CH;   // the staging's channel
  const float dtb = mc < d ? a.dt_b[mc] : 0.f;

  // this lane's states k = part * S + j; padded states have A = 0 and
  // B = C = 0, so they stay 0 and add nothing
  float a2[S], Hs[S], dh[S], dA[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = part * S + j;
    const bool in = live && k < n;
    const long long o = ((long long)bi * nseg + seg) * n * d + (long long)k * d + c;
    a2[j] = in ? a.A[(long long)c * n + k] * kLog2e : 0.f;
    Hs[j] = in ? a.hend[o] : 0.f;
    dh[j] = in ? a.rout[o] : 0.f;
    dA[j] = 0.f;
  }
  const float Dc = live ? a.D[c] : 0.f;
  float dD = 0.f, ddtb = 0.f;

  // a chunk's saved local state and the segment's delta before it, loaded
  // a chunk ahead
  float hbn[S], cdn = 0.f;
  auto fetch_state = [&](int jg) {
    cdn = live ? a.cd[((long long)bi * nch + jg) * d + c] : 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = part * S + j;
      hbn[j] = (live && k < n) ? a.hb[((long long)bi * nch + jg) * n * d + (long long)k * d + c]
                               : 0.f;
    }
  };

  const int last = s0 + (s1 - s0 - 1) / T * T;
  for (int i = tid; i < T * NP; i += THREADS) raw.B[i] = raw.C[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  fetch_raw<NP>(a, raw, bi, blk, last, s1 - last);
  fetch_state(last / T);
  for (int t0 = last; t0 >= s0; t0 -= T) {
    const int q = min(T, s1 - t0);
    cp_async_wait_all();
    __syncthreads();   // the chunk's copies are in; the last chunk's readers are done
    convert_raw<NP, true>(a, raw, blk, q, dtb, sB, sC, sDel, sU, sG, sGd, sSp);
    // the state entering the chunk: its local state plus exp(A sum delta) H_s
    float hin[S];
#pragma unroll
    for (int j = 0; j < S; ++j) hin[j] = fmaf(ex2(a2[j] * cdn), Hs[j], hbn[j]);
    __syncthreads();
    if (t0 > s0) {
      fetch_raw<NP>(a, raw, bi, blk, t0 - T, T);
      fetch_state(t0 / T - 1);
    }

    // the chunk's states, the scan's output (dz) and dC's part; every token
    // of the chunk runs, those past q as zeros
    float av[T][S];
    {
      float h[S];
#pragma unroll
      for (int j = 0; j < S; ++j) h[j] = hin[j];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float dv = sDel[t * CH + cl], u = sU[t * CH + cl], gg = sG[t * CH + cl];
        const float du = dv * u;
        float bv[S], cv[S], gh[S];
        load_s<S>(bv, sB + t * NP + part * S);
        load_s<S>(cv, sC + t * NP + part * S);
        float ys = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          av[t][j] = ex2(dv * a2[j]);
          h[j] = fmaf(av[t][j], h[j], du * bv[j]);
          ys = fmaf(h[j], cv[j], ys);
          gh[j] = gg * h[j];
        }
        if (t < T - 1) store_states<S>(sH, t, tid, h);
        warp_channel_sum<S>(gh, sPC + (warp * T + t) * NP, part);
        ys = lanes_sum(ys);
        if (part == 0) sGd[t * CH + cl] *= fmaf(Dc, u, ys);
      }
    }

    // the reverse recurrence over the chunk
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      const float dv = sDel[t * CH + cl], u = sU[t * CH + cl], gg = sG[t * CH + cl];
      const float du = dv * u;
      float bv[S], cv[S], hp[S], db[S];
      load_s<S>(bv, sB + t * NP + part * S);
      load_s<S>(cv, sC + t * NP + part * S);
      if (t > 0) {
        load_states<S>(hp, sH, t - 1, tid);
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) hp[j] = hin[j];
      }
      float s1v = 0.f, sa = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        dh[j] = fmaf(gg, cv[j], dh[j]);
        s1v = fmaf(dh[j], bv[j], s1v);
        const float dha = dh[j] * av[t][j] * hp[j];
        sa = fmaf(dha, a2[j], sa);
        dA[j] = fmaf(dha, dv, dA[j]);
        db[j] = dh[j] * du;
        dh[j] *= av[t][j];
      }
      warp_channel_sum<S>(db, sPB + (warp * T + t) * NP, part);
      // dh . B and the decay term (over A log2(e)) summed over the channel's
      // lanes: the even parts keep the first, the odd the second, then the
      // pairs add theirs; part 0 then takes part 1's
      const bool odd = part & 1;
      float keep = odd ? sa : s1v;
      keep += __shfl_xor_sync(kFull, odd ? s1v : sa, 1);
      keep += __shfl_xor_sync(kFull, keep, 2);
      const float sat = __shfl_down_sync(kFull, keep, 1);
      if (part == 0) {
        const float ddt = fmaf(keep, u, sat * kLn2) * sSp[t * CH + cl];
        dD = fmaf(gg, u, dD);
        ddtb += ddt;
        sG[t * CH + cl] = fmaf(keep, dv, gg * Dc);
        sSp[t * CH + cl] = ddt;
      }
    }
    __syncthreads();

    // dB's and dC's parts of the CTA's channels: the warps' parts in order
    float* dBp = a.dBp + ((long long)bi * nblk + blk) * L * n;
    float* dCp = a.dCp + ((long long)bi * nblk + blk) * L * n;
    for (int i = tid; i < q * n; i += THREADS) {
      const int t = i / n, k = i % n;
      float sb = 0.f, scs = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sb += sPB[(w * T + t) * NP + k];
        scs += sPC[(w * T + t) * NP + k];
      }
      dBp[(long long)(t0 + t) * n + k] = sb;
      dCp[(long long)(t0 + t) * n + k] = scs;
    }
    // dxc, ddt_raw, dz of the chunk's rows
    for (int i = tid; i < q * CH; i += THREADS) {
      if (mc >= d) continue;
      const long long o = ((long long)bi * L + t0 + i / CH) * d + mc;
      a.dx[o] = __float2bfloat16_rn(sG[i]);
      a.ddt[o] = __float2bfloat16_rn(sSp[i]);
      a.dz[o] = __float2bfloat16_rn(sGd[i]);
    }
  }

  if (live) {
    const long long o = (long long)bi * nseg + seg;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = part * S + j;
      if (k < n) a.dAp[(o * d + c) * n + k] = dA[j];
    }
    if (part == 0) {
      a.dDp[o * d + c] = dD;
      a.ddtbp[o * d + c] = ddtb;
    }
  }
}

// dB, dC: the parts summed over the CTAs in order, cast to bf16; dA, dD,
// ddt_b: summed over the (batch row, segment) parts in order
__global__ void scan_bwd_finish(const float* __restrict__ dBp, const float* __restrict__ dCp,
                                const float* __restrict__ dAp, const float* __restrict__ dDp,
                                const float* __restrict__ ddtbp, __nv_bfloat16* dB,
                                __nv_bfloat16* dC, float* dA, float* dD, float* ddtb, int parts,
                                int b, int L, int d, int n, int nblk) {
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
    for (int p = 0; p < parts; ++p) s += dAp[(long long)p * d * n + i];
    dA[i] = s;
  }
  if (i < d) {
    float s = 0.f, t = 0.f;
    for (int p = 0; p < parts; ++p) {
      s += dDp[(long long)p * d + i];
      t += ddtbp[(long long)p * d + i];
    }
    dD[i] = s;
    ddtb[i] = t;
  }
}

template <int S>
int launch(const Args& a, int b, int nseg, cudaStream_t st) {
  constexpr int NP = PARTS * S;
  constexpr int s1 = local_smem_floats<NP>() * 4, s3 = seg_smem_floats<NP>() * 4;
  const dim3 grid((a.d + CH - 1) / CH, nseg, b);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_local_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  scan_bwd_local_kernel<S><<<grid, THREADS, s1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per = (long long)a.n * a.d, lanes = (long long)b * per;
  scan_bwd_carry_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(a.hend, a.pseg, a.rout,
                                                                          lanes, nseg, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(scan_bwd_seg_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scan_bwd_seg_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  scan_bwd_seg_kernel<S><<<grid, THREADS, s3, st>>>(a);
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

long long floats4(long long v) { return (v + 3) / 4 * 4; }

}  // namespace

// Floats of scratch gf_mamba1_scan_bwd needs: the local states entering
// each chunk (b, chunks, n, d) and the segment's delta before it (b,
// chunks, d); the segments' end states, decays and carries (b, segments,
// n, d) each; dB's and dC's parts (b, d / 64, L, n) each; dA's (b,
// segments, d, n), dD's and ddt_b's (b, segments, d); each part starts on
// 16 bytes.
extern "C" long long gf_mamba1_scan_bwd_scratch(int b, int L, int d, int n) {
  const long long nch = (L + tokens_for(n) - 1) / tokens_for(n);
  const long long nseg = (L + SEG - 1) / SEG, nblk = (d + CH - 1) / CH;
  return floats4((long long)b * nch * n * d) + floats4((long long)b * nch * d) +
         3 * floats4((long long)b * nseg * n * d) + 2 * floats4(b * nblk * L * n) +
         floats4((long long)b * nseg * d * n) + 2 * floats4((long long)b * nseg * d);
}

// xc, dt_raw, z: (b, L, d) bf16, last stride 1; B, C: (b, L, n) bf16, last
// stride 1; dy (b, L, d) bf16 contiguous; A (d, n), D, dt_b (d,) f32
// contiguous.  dxc, ddt_raw, dz (b, L, d) and dB, dC (b, L, n) bf16
// contiguous; dA (d, n), dD, ddt_b (d,) f32; scratch of
// gf_mamba1_scan_bwd_scratch floats.  1 <= n <= 64.  Returns
// cudaGetLastError() after the launches.
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
  const int nseg = (L + SEG - 1) / SEG, nblk = (d + CH - 1) / CH;
  float* hb = static_cast<float*>(scratch);
  float* cd = hb + floats4((long long)b * nch * n * d);
  float* hend = cd + floats4((long long)b * nch * d);
  float* pseg = hend + floats4((long long)b * nseg * n * d);
  float* rout = pseg + floats4((long long)b * nseg * n * d);
  float* dBp = rout + floats4((long long)b * nseg * n * d);
  float* dCp = dBp + floats4((long long)b * nblk * L * n);
  float* dAp = dCp + floats4((long long)b * nblk * L * n);
  float* dDp = dAp + floats4((long long)b * nseg * d * n);
  float* ddtbp = dDp + floats4((long long)b * nseg * d);
  using bf16 = __nv_bfloat16;
  auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
         static_cast<const bf16*>(z), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const bf16*>(dy),
         static_cast<const float*>(A), static_cast<const float*>(D),
         static_cast<const float*>(dt_b), static_cast<bf16*>(dx), static_cast<bf16*>(ddt),
         static_cast<bf16*>(dz), hb, cd, hend, pseg, rout, dBp, dCp, dAp, dDp, ddtbp,
         sx_b, sx_l, sdt_b, sdt_l, sz_b, sz_l, sB_b, sB_l, sC_b, sC_l, L, d, n,
         d % 8 == 0 && al16(x) && al16(dt) && al16(z) && al16(dy) &&
             (sx_b | sx_l | sdt_b | sdt_l | sz_b | sz_l) % 8 == 0,
         n % 8 == 0 && al16(B) && al16(C) && (sB_b | sB_l | sC_b | sC_l) % 8 == 0};
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (states_for(n)) {
    case 1: rc = launch<1>(a, b, nseg, st); break;
    case 2: rc = launch<2>(a, b, nseg, st); break;
    case 4: rc = launch<4>(a, b, nseg, st); break;
    case 8: rc = launch<8>(a, b, nseg, st); break;
    default: rc = launch<16>(a, b, nseg, st); break;
  }
  if (rc != 0) return rc;
  long long total = (long long)b * L * n;
  if ((long long)d * n > total) total = (long long)d * n;
  scan_bwd_finish<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      dBp, dCp, dAp, dDp, ddtbp, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dA), static_cast<float*>(dD), static_cast<float*>(ddtb), b * nseg,
      b, L, d, n, nblk);
  return (int)cudaGetLastError();
}
