// Tensor-core helpers shared by the float32 kernels that form their
// products as three TF32 products (3xTF32): cp.async staging, the TF32
// split, ldmatrix fragment loads and the m16n8k8 TF32 MMA.
//
// Why 3xTF32 keeps the float32 result: every operand x is split into
// hi = tf32(x) (round to nearest, ties away, as cvt.rna, done in integer
// operations because the conversion pipe is slow) and lo = x - hi (exact in
// f32; the MMA reads its top 19 bits).  Each product is formed as
// lo*hi + hi*lo + hi*hi, every partial product exact, summed in f32.  The
// dropped lo*lo term and the bits of lo the MMA drops are below 2^-21 of
// |a_i b_i|.  A kernel sums each 32-deep stage into a fresh accumulator and
// adds it to the tile's total with an f32 add, so the tensor cores' own
// accumulation only ever rounds values of a stage's size.  On integer data
// below 2048 lo = 0 and, while every partial sum is an integer below 2^24,
// the products are exact in any order.
#pragma once

#include "common.cuh"

namespace pipnn::mma_tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC floats from src to shared dst, or zeros when !ok
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const uint32_t s = smem_u32(dst);
  const int bytes = ok ? VEC * 4 : 0;
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 in integer operations (the conversion pipe is slow):
// round the magnitude to 10 explicit mantissa bits, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));   // exact; the MMA reads its top 19 bits
}

// four 8x8 b16 matrices, one 16-byte row address per lane (lanes 8m..8m+7
// give matrix m's rows); read as 8 rows x 4 floats, lane (g, t) receives
// word t of row g of each, which is the TF32 MMA fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace pipnn::mma_tf32
