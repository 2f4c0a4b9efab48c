// Hopper (sm_90a) pieces of the flash-attention kernels (flash_fwd.cu, K1;
// flash_bwd.cu, K2 and K3): mbarriers, TMA tile loads and the host code
// that builds their tensor maps, shared-memory matrix descriptors, the
// warpgroup products (wgmma) and exp2, in raw PTX, as flash_common.cuh
// wraps mma.sync.
//
// Tiles are staged by TMA in the 128-byte swizzle: a box of 64 bf16 columns
// (128 bytes) by R rows lands as R rows of 128 bytes, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8). A wider row is ceil(D / 64) such
// boxes, one after the other: at D = 128 two full ones, at D = 96 a full
// one and one whose columns past the tensor's 96 are zero-filled by the
// copy. The swizzle is a function of the shared address, so every box
// starts on a 1024-byte boundary.
//
// wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply"): the four
// warps of a warpgroup issue one 64 x N x 16 product together. Warp w owns
// accumulator rows 16w .. 16w + 15 in mma.sync's C layout, repeated every 8
// columns: with g = lane / 4, t = lane % 4, d[j][0..1] = C[16w + g][8j + 2t
// ..] and d[j][2..3] = C[16w + g + 8][8j + 2t ..]. An A operand taken from
// registers has mma.sync's m16n8k16 A layout for each warp's 16 rows, so
// flash::c_to_a turns a score accumulator into one.
//
// A shared-memory operand is a 64-bit descriptor (PTX ISA, "Matrix
// Descriptor Format"): start address, leading and stride byte offsets, all
// in 16-byte units, and the swizzle mode (1 = 128 bytes) in bits 62-63.
// - K-major (the 16-deep k runs along a row: Q, and K as the B of Q K^T):
//   rows of 128 bytes, 8-row groups 1024 bytes apart (the stride offset).
//   Step k16 number i of a box starts 32 i bytes into the row; the hardware
//   applies the swizzle to the address. The leading offset is unused.
// - MN-major (V as the B of P V, its n = D running along the row, with the
//   transpose bit): the 16 k rows of a step are two 8-row groups 1024 bytes
//   apart (the stride offset), and columns 64 .. 127 lie in the next box
//   (the leading offset: one box's bytes). A product of n = 96 reads
//   columns 64 .. 95 of that box and none of its zero-filled rest.
//
// A (rows, d) bf16 operand is staged through a 3-D tensor map over (mats,
// rows, d) (make_map); an fp32 vector that a tile reads one value a row of
// (lse, delta) through a 1-D map over all of it (make_vec_map), unswizzled.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: nothing links the driver)
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

constexpr int kBoxCols = 64;   // bf16 columns of one swizzled box
constexpr int kRowBytes = 128; // bytes of a box row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (shared-memory addresses) ----------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// The box at (c0, c1, c2), innermost first, of the tensor `map` describes
// (a __grid_constant__ kernel parameter) into shared memory at dst; its
// bytes complete the transaction count of barrier `bar`. Elements past the
// tensor's end are zero.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box at c0 of the 1-D tensor `map` describes into shared memory at
// dst, as tma_load_3d.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at shared address `addr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// orders the registers' last writes before the next wgmma reads them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// returns once at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator across the asynchronous
// product: after wgmma_wait, the registers count as written here.
template <int J>
__device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
  }
}

// 2^x on the special-function unit, as exp2f computes it but with results
// below 2^-126 flushed to 0, which saves exp2f's rescaling around the
// instruction; exp2_ftz(-inf) = 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define SM90_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define SM90_ACC32                                                                 \
  SM90_ACC4(0), SM90_ACC4(1), SM90_ACC4(2), SM90_ACC4(3), SM90_ACC4(4), SM90_ACC4(5), \
      SM90_ACC4(6), SM90_ACC4(7)
#define SM90_ACC48 \
  SM90_ACC32, SM90_ACC4(8), SM90_ACC4(9), SM90_ACC4(10), SM90_ACC4(11)
#define SM90_ACC64                                                                  \
  SM90_ACC48, SM90_ACC4(12), SM90_ACC4(13), SM90_ACC4(14), SM90_ACC4(15)
#define SM90_REGS32                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "              \
  "%8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, "       \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_REGS48                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "              \
  "%8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, "       \
  "%24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, "       \
  "%40, %41, %42, %43, %44, %45, %46, %47}"
#define SM90_REGS64                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "              \
  "%8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, "       \
  "%24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, "       \
  "%40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, "       \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N, fp32) = A B (+ d when accumulate), bf16 operands; A and B from
// shared memory, both K-major. N = 8 x the first extent of d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, fp32) = A B (+ d when accumulate), A (64 x 16 bf16) from
// registers in mma.sync's A layout, B from shared memory, MN-major (the
// transpose bit set).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[8][4], const uint32_t a[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[12][4], const uint32_t a[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " SM90_REGS48
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : SM90_ACC48
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[16][4], const uint32_t a[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef SM90_ACC4
#undef SM90_ACC32
#undef SM90_ACC48
#undef SM90_ACC64
#undef SM90_REGS32
#undef SM90_REGS48
#undef SM90_REGS64

// ---- tensor maps (host) -------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that nothing links
// the driver library
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a 3-D map over a (mats, rows, d) bf16 tensor, boxes of 64 columns x
// box_rows rows x 1 in the 128-byte swizzle; rows past `rows` read as zero
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
                     int rows, int mats, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 1-D map over n fp32 values, boxes of `box` values, unswizzled. A box
// may start anywhere; values past the end read as zero
inline bool make_vec_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                         size_t n, int box) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // none at rank 1
  const cuuint32_t box_dims[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem_strides[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
                strides, box_dims, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
