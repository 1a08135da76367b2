// Device helpers shared by the SSD's forward (ssd.cu) and backward
// (ssd_bwd.cu) kernels: shared-memory addresses, cp.async copies, the
// base-2 exponential and the 3xTF32 tensor-core product (mma.sync m16n8k8
// tf32 on operands split into a rounded TF32 hi and the rest).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ssd_tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled where !in (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a = hi + lo in TF32 (CUTLASS's 3xTF32 split): hi rounds a to nearest,
// ties away from zero, on the bits (add half of the 13 dropped bits' range
// to the magnitude, clear them); lo = a - hi is exact in f32, and the MMA
// reads only its top 19 bits (rounding lo toward zero)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// d += a * b as 3xTF32 with the hi*hi product in db and the two small cross
// terms in ds: two shorter chains
__device__ __forceinline__ void mma3_split(float (&db)[4], float (&ds)[4], const FragA& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(ds, a.lo, bh0, bh1);
  mma_tf32(db, a.hi, bh0, bh1);
  mma_tf32(ds, a.hi, bl0, bl1);
}

// 2^x on the special-function unit (MUFU.EX2), subnormal results flushed
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a * b as 3xTF32: the two small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// Fragment maps of mma.m16n8k8 (g = lane / 4, c = lane % 4):
//   A (16x8):  a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4)
//   B (8x8):   b0 (k=c, n=g), b1 (k=c+4, n=g)
//   D (16x8):  d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1)

}  // namespace ssd_tc
