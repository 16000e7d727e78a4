// Warp-level tensor-core and async-copy helpers shared by the port's CUDA
// kernels (sm_90a): cp.async with zero fill, ldmatrix, mma.sync on bf16
// (m16n8k16) and on TF32 (m16n8k8), and the 3xTF32 split that gives f32
// accuracy on the TF32 tensor cores.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"), with
// g = lane / 4 and q = lane % 4 inside a warp:
//   C/D (16 x 8, f32): c0, c1 at (row g, cols 2q, 2q + 1); c2, c3 at row g + 8.
//   bf16 A (16 x 16): four 32-bit registers, each two bf16 of one row:
//     (g, 2q..), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..).
//   bf16 B (16 x 8): (k 2q.., col g), (k 2q + 8.., col g).
//   tf32 A (16 x 8): (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4).
//   tf32 B (8 x 8): (k q, col g), (k q + 4, col g).
// The bf16 C layout of two neighbouring n-tiles is the bf16 A layout of
// one k-step of 16, which lets attention feed P to P.V from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes < 16 fills the rest with
// zeros (0 reads nothing, but src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4-byte async copy with the same zero fill
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of every lane receives its part of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way (row-major V as the
// k-major B operand)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The products are plain (not volatile) asm: they only touch registers,
// so the compiler may interleave independent ones.

// d += a (16 x 16 bf16) . b (16 x 8 bf16), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 8 tf32) . b (8 x 8 tf32), f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: x = hi + lo with hi = x rounded to tf32's 10 mantissa bits and
// lo = x - hi (exact in f32), so that hi.hi + hi.lo + lo.hi keep ~21 bits
// of each operand (the dropped lo.lo term is below f32 rounding). hi is
// rounded half up on the mantissa with two integer operations rather
// than cvt.rna.tf32.f32; the tensor core reads lo's top 19 bits.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// d[nt] += a . b[nt] in 3xTF32 for NT n-tiles that share one A fragment,
// the small terms first; each pass runs over all NT accumulators, so NT
// independent products separate two that depend on each other
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NT][4],
                                           const Split (&a)[4],
                                           const Split (&b0)[NT],
                                           const Split (&b1)[NT]) {
  const uint32_t ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], al, b0[nt].hi, b1[nt].hi);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ah, b0[nt].lo, b1[nt].lo);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ah, b0[nt].hi, b1[nt].hi);
}

}  // namespace mma
