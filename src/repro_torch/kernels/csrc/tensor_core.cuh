// Building blocks shared by the model kernels (flash_attention.cu,
// grouped_matmul.cu): type conversions, the tensor-core products they
// issue, and the cp.async copies that stage their tiles.
//
// f32 products run as 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each
// operand x is split into big = x rounded to TF32 and small = x - big,
// and a*b is taken as as*bb + ab*bs + ab*bb on mma.m16n8k8.tf32 with f32
// accumulation, the small*small term dropped.  big + small carries 21 of
// x's 24 significant bits, so the products stay within the port's f32
// tolerance, which single-pass TF32 misses (tests/test_torch_tf32_split.py
// emulates both).  big is rounded to nearest, ties away, by an integer
// add and mask: the bits of cvt.rna.tf32.f32 on every finite x in two
// instructions, where cvt itself takes five on sm_90a; small is exact in
// f32 and the tensor core reads its top 19 bits (truncation), so a NaN
// or infinite x still reaches the product through small.  bf16 products
// are one mma.m16n8k16.bf16 with f32 accumulation.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8/k16"),
// lane = 4 * g + t:
//   A (16 x 8 tf32):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8 tf32):   b0 (k t, n g)  b1 (k t + 4, n g)
//   A (16 x 16 bf16): a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g + 8, 2t+8..)
//   B (16 x 8 bf16):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8 f32):   c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                     c3 (g + 8, 2t + 1)
// The lower-indexed element of a bf16 pair sits in the low 16 bits.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace e2c {

template <typename T> __host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x = big + small: big rounded to TF32, small the exact rest (read by the
// tensor core to TF32 by truncation).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small cross terms first, then big*big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 values as a pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace e2c
