// Float32-accurate tensor-core products for sm_90a (3xTF32), shared by
// K2 (wavenet_stack.cu), K1 and K3 (rel_attention.cu).
//
// One TF32 product rounds each operand to ~5e-4 relative, which the port's
// 1e-4 limits do not allow.  So every float32 operand x is split into two
// TF32 values, hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in
// float32), and a product takes three tensor-core passes,
//   d += a_lo * b_hi;  d += a_hi * b_lo;  d += a_hi * b_hi,
// with float32 accumulation (CUTLASS calls this OpMultiplyAddFastF32; mma3
// below says why each k-step's d starts from zero).  The
// dropped lo * lo term is ~2^-22 of the product, so the result has about
// float32 accuracy at a third of the TF32 rate (495 / 3 = 165 TFLOP/s on
// the H100, against 67 on the CUDA cores).  ops/tf32x3.py emulates the same
// arithmetic on the CPU for the tests.
//
// The products are mma.sync.aligned.m16n8k8 (one warp: a 16x8 A fragment
// times an 8x8 B fragment into a 16x8 float32 accumulator).  With
// g = lane / 4 and c = lane % 4 a thread holds
//   A (row-major 16x8): a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4)
//   B (8x8, k x n):     b0 (c, g), b1 (c+4, g)
//   D (16x8):           d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1)
// The loaders below read fragments from shared memory; `ld` is the row
// stride in floats.  A row stride of 4 mod 8 floats keeps the row-indexed
// reads (g * ld + c) free of bank conflicts, a stride of 8 mod 32 the
// column-indexed ones (c * ld + g).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tf32x3 {

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// round to nearest TF32, ties away from zero; the low 13 bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// hi must be a clean TF32 value for x - hi to be exact; lo's low bits are
// left as cvt gives them (the tensor core reads lo as TF32 either way)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a * b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b (the accumulator input is one zero register)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// acc += a * b in 3xTF32.  The tensor core rounds its running sum toward
// zero on every mma (found on the H100: a chain of 360 mma at depth 960 was
// ~10x less accurate than float32 FMAs), so the three products of one
// k-step are summed from zero and then added to acc with a float32 add,
// which rounds to nearest: the truncation never compounds past one k-step.
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a,
                                     const FragB& b) {
  float d[4];
  mma_zero(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_c() { return threadIdx.x & 3; }

// A tile stored row-major, A[m][k] at s[m * ld + k]; s points at (0, 0)
__device__ __forceinline__ FragA load_a(const float* s, int ld) {
  const int g = lane_g(), c = lane_c();
  FragA f;
  split(s[g * ld + c], f.hi[0], f.lo[0]);
  split(s[(g + 8) * ld + c], f.hi[1], f.lo[1]);
  split(s[g * ld + c + 4], f.hi[2], f.lo[2]);
  split(s[(g + 8) * ld + c + 4], f.hi[3], f.lo[3]);
  return f;
}

// A tile stored transposed, A[m][k] at s[k * ld + m]
__device__ __forceinline__ FragA load_a_t(const float* s, int ld) {
  const int g = lane_g(), c = lane_c();
  FragA f;
  split(s[c * ld + g], f.hi[0], f.lo[0]);
  split(s[c * ld + g + 8], f.hi[1], f.lo[1]);
  split(s[(c + 4) * ld + g], f.hi[2], f.lo[2]);
  split(s[(c + 4) * ld + g + 8], f.hi[3], f.lo[3]);
  return f;
}

// B tile stored k-major, B[k][n] at s[k * ld + n]
__device__ __forceinline__ FragB load_b(const float* s, int ld) {
  const int g = lane_g(), c = lane_c();
  FragB f;
  split(s[c * ld + g], f.hi[0], f.lo[0]);
  split(s[(c + 4) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// B tile stored n-major, B[k][n] at s[n * ld + k] (e.g. keys as rows)
__device__ __forceinline__ FragB load_b_t(const float* s, int ld) {
  const int g = lane_g(), c = lane_c();
  FragB f;
  split(s[g * ld + c], f.hi[0], f.lo[0]);
  split(s[g * ld + c + 4], f.hi[1], f.lo[1]);
  return f;
}

// A tile already split into TF32 planes, A[m][k] = hi[m * ld + k] +
// lo[m * ld + k] (K1's Q, split once and read at every key tile)
__device__ __forceinline__ FragA load_a_split(const float* hi, const float* lo,
                                              int ld) {
  const int g = lane_g(), c = lane_c();
  const int at[4] = {g * ld + c, (g + 8) * ld + c, g * ld + c + 4,
                     (g + 8) * ld + c + 4};
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f.hi[e] = __float_as_uint(hi[at[e]]);
    f.lo[e] = __float_as_uint(lo[at[e]]);
  }
  return f;
}

// B tile of 8 keys stored k-major, B[key][n] at s[key * ld + n], read with
// k-index c as key 2c and c + 4 as key 2c + 1.  In that order an m16n8
// accumulator over the same 8 keys, taken as {d0, d2, d1, d3}, is the A
// fragment of the next product (K1's P V, with P from S = Q K^T).
__device__ __forceinline__ FragB load_b_pairs(const float* s, int ld) {
  const int g = lane_g(), c = lane_c();
  FragB f;
  split(s[2 * c * ld + g], f.hi[0], f.lo[0]);
  split(s[(2 * c + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// 16-byte global -> shared copy, bypassing L1; zero-fills when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4- and 8-byte copies (through L1); zero-fill when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Host side: a kernel's registers, dynamic shared memory and resident
// blocks per SM at `threads` threads and `smem` bytes of dynamic shared
// memory; its name into name[0:n).  Returns a cudaError_t.
inline int kernel_info(const void* fn, const char* fname, int threads,
                       size_t smem, char* name, int n, int* regs,
                       int* smem_out, int* blocks) {
  if (n > 0) {
    strncpy(name, fname, n - 1);
    name[n - 1] = 0;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_out = (int)(smem + attr.sharedSizeBytes);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            threads, smem);
}

}  // namespace tf32x3
