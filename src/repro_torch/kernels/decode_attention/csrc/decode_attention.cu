// Split-K flash-decode for Hopper (sm_90a): CUDA cores and shared memory.
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
// Bound on an H100: it reads the live cache once.  At b=8, S=2176, 32 kv
//   heads of 80 in bf16 that is ~178 MB a call, ~53 us at 3.35 TB/s; its
//   FLOPs are ~4 per cache element, far below the tensor-core ridge.
// This first design: pass 1 runs one CTA of 128 threads per (split of
//   `split` keys, kv head, batch row) -- b x kv CTAs alone (256 at b=8)
//   would underfill 132 SMs at long S -- and skips splits past cache_len.
//   Per 128-key tile a thread owns one key: it reads that K row with 16-byte
//   loads and dots it with the group's queries (in shared memory); one warp
//   per head takes the tile's max and sum; the V tile is staged in shared
//   memory and the threads own (head, dim) outputs.  It writes a partial
//   (m, l, acc) per split.  Pass 2 merges the live splits of each (batch,
//   head) by log-sum-exp.  Left for later: cp.async/TMA prefetch of the next
//   tile, splits sized to cache_len instead of S, and fusing the combine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int DT = 128;      // threads per CTA, and keys per tile
constexpr int MAXG = 16;     // largest GQA group
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of a row as floats: 8 bf16 or 4 f32
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
};

size_t partial_smem(int g, int d) {
  return sizeof(float) * ((size_t)g * d + (size_t)DT * d + (size_t)g * DT + 3 * (size_t)g);
}

template <typename T, int D>
__global__ void __launch_bounds__(DT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ cache_len,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int S, int h, int kvh,
                      int split, int nsplit, float scale) {
  constexpr int VN = Vec<T>::N;
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

  const T* qb = q + ((long)bi * h + (long)kvi * g) * D;
  for (int idx = tid; idx < g * D; idx += DT) sq[idx] = to_f(qb[idx]);
  if (tid < g) { sm[tid] = NEG_INF; sl[tid] = 0.f; }

  float acc[MAXO];
#pragma unroll
  for (int r = 0; r < MAXO; ++r) acc[r] = 0.f;

  const long row = (long)kvh * D;
  const T* kb = kc + (long)bi * S * row + (long)kvi * D;
  const T* vb = vc + (long)bi * S * row + (long)kvi * D;

  for (int k0 = start; k0 < end; k0 += DT) {
    __syncthreads();   // queries staged; the previous tile's readers are done
    const int nk = min(DT, end - k0);
    for (int idx = tid; idx < DT * (D / VN); idx += DT) {
      const int r = idx / (D / VN), c = (idx % (D / VN)) * VN;
      float vv[VN];
      if (r < nk) {
        Vec<T>::load(vb + (long)(k0 + r) * row + c, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) sV[r * D + c + e] = vv[e];
    }
    float s[MAXG];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) s[gi] = 0.f;
    const bool valid = tid < nk;
    if (valid) {
      const T* kr = kb + (long)(k0 + tid) * row;
      for (int c = 0; c < D; c += VN) {
        float kv[VN];
        Vec<T>::load(kr + c, kv);
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi < g) {
#pragma unroll
            for (int e = 0; e < VN; ++e) s[gi] = fmaf(sq[gi * D + c + e], kv[e], s[gi]);
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
  out[((long)bi * h + hi) * D + c] = from_f<T>(a / fmaxf(L, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* lens,
           float* pm, float* pl, float* pa, void* out, int b, int S, int h,
           int kvh, int split, float scale, cudaStream_t stream) {
  const int g = h / kvh;
  const int nsplit = (S + split - 1) / split;
  const size_t smem = partial_smem(g, D);
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_partial_kernel<T, D><<<dim3(nsplit, kvh, b), DT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      lens, pm, pl, pa, S, h, kvh, split, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3(h, b), D, 0, stream>>>(
      pm, pl, pa, lens, static_cast<T*>(out), S, h, split, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* kc, const void* vc, const int* lens,
             float* pm, float* pl, float* pa, void* out, int b, int S, int h,
             int kvh, int split, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    case 80: return launch<T, 80>(q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" size_t gf_decode_smem(int g, int d) { return partial_smem(g, d); }

// q (b, 1, h, d), caches (b, S, kvh, d) contiguous and 16-byte aligned, of one
// dtype (bf16 when is_bf16, else f32); cache_len (b,) int32; workspace
// part_m/part_l (b, h, nsplit) and part_acc (b, h, nsplit, d) float32 with
// nsplit = ceil(S / split); out (b, 1, h, d).  Returns cudaGetLastError().
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
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh,
                                   split, scale, s);
  return dispatch<float>(d, q, kc, vc, lens, pm, pl, pa, out, b, S, h, kvh, split,
                         scale, s);
}
