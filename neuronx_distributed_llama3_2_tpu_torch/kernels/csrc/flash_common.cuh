// Pieces shared by the attention kernels (flash_fwd.cu, flash_bwd.cu,
// paged_decode_tile.cu): the bf16 tensor-core product and its fragment
// loads, accumulator-to-fragment rounding, the row store.
//
// Every product is mma.sync.m16n8k16 bf16 x bf16 -> fp32 (PTX ISA,
// "Matrix fragments for mma.m16n8k16"). With g = lane / 4, t = lane % 4:
//   A (16 x 16, row-major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                           a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n):      b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// (two bf16 per 32-bit register, the lower index in the low half). A row
// of C is spread over the four lanes 4g..4g+3, so a row reduction is the
// lane's own values followed by two xor-shuffles (1, 2).
//
// paged_decode_tile.cu keeps tiles in shared memory as bf16 rows of D +
// kPad elements: the padding shifts consecutive rows by 4 banks, so the
// fragment loads of a warp touch 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace flash {

constexpr int kPad = 8;  // bf16 padding per shared-memory row

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_float(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B(k, n) = s[n * ld + k]: the 16 x 8 B is the transpose of the 8 rows of
// 16 at s (K^T read from row-major K).
__device__ __forceinline__ void load_b_t(uint32_t b[2], const bf16* s, int ld,
                                         int lane) {
  const bf16* p = s + (lane >> 2) * ld + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B(k, n) = s[k * ld + n]: 16 rows of 8 at s, row-major.
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* s, int ld,
                                       int lane) {
  const int g = lane >> 2, k = 2 * (lane & 3);
  b[0] = pack_bf16(s[k * ld + g], s[(k + 1) * ld + g]);
  b[1] = pack_bf16(s[(k + 8) * ld + g], s[(k + 9) * ld + g]);
}

// The A fragments of a 16 x 64 fp32 C block (8 tiles of 16 x 8), rounded
// to bf16: k chunk kc is made of C tiles 2kc and 2kc + 1.
__device__ __forceinline__ void c_to_a(uint32_t a[4][4], const float c[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_float(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_float(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_float(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_float(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// Rows of a warp's 16 x D fp32 result (D / 8 C tiles), times `scale`,
// as bf16 into rows row0 .. of a (rows, D) matrix; rows past `rows` are
// dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[D / 8][4],
                                           int row0, int rows, float scale,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= rows) continue;
    bf16* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_float(acc[dt][2 * half] * scale, acc[dt][2 * half + 1] * scale);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
