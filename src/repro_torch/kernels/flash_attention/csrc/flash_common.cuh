// Device helpers shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels:
// shared-memory addresses, 16-byte cp.async copies, ldmatrix loads, the
// m16n8k16 bf16 tensor-core product and the base-2 exponential.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (MUFU.EX2), subnormal results flushed
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// two floats as bf16x2, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of an m16n8k16 product over 16 columns kk*16.. of two
// accumulator tiles (n-blocks 2kk and 2kk+1): the accumulator layout maps
// pairwise onto A's, so the f32 values are rounded to bf16 in registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Fragment loads from a shared tile of pitch DP (elements), for a product
// over k-step kk (16 columns of the tile's rows, or 16 of its rows):
//   load_a:       A (16 rows from r0, row-major in the tile)
//   load_b:       B for two n-blocks of 8 whose rows n0.. of the tile are
//                 B's columns (B = tile^T); b[0..1] the first, b[2..3] the
//                 second
//   load_b_trans: B for two n-blocks whose columns n0.. of the tile are
//                 B's columns and whose rows kk*16.. are B's k (B = tile)
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int kk,
                                       int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = kk * 16 + (lane >> 4) * 8;
  ldmatrix_x4(a, smem_u32(tile + r * DP + c));
}
template <int DP>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int kk,
                                       int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = kk * 16 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, smem_u32(tile + r * DP + c));
}
template <int DP>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int n0,
                                             int kk, int lane) {
  const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, smem_u32(tile + r * DP + c));
}

// ROWS rows of D bf16 from src (row r at src + (r0 + r) * pitch) into a
// shared tile of pitch D + 8; rows at or past rmax are zero-filled, unread
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long pitch, int r0,
                                          int rmax, int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    if (N % THREADS && idx >= N) break;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool in = r0 + r < rmax;
    const bf16* s = in ? src + (long)(r0 + r) * pitch + c : src;
    cp_async16(smem_u32(dst + r * (D + 8) + c), s, in);
  }
}

}  // namespace flash
