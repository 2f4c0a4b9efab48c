// Pieces shared by the paged-decode kernels (paged_decode.cu,
// paged_decode_t1.cu, paged_decode_tile.cu): the pool's payload kinds and
// layouts, the widening of one payload element to fp32, the dequantization
// the TPU kernel forms, and the cp.async copies that stage pool blocks in
// shared memory. One definition, so that the sources cannot drift apart.
//
// The definitions sit in an unnamed namespace, so each source that
// includes this header gets its own internal copy, as when they were
// written in paged_decode.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cstdint>

namespace {

// payload kinds, as kernels/paged_attention.py KV_KINDS numbers them
enum KvKind : int { kBf16 = 0, kInt8 = 1, kE4m3 = 2, kE5m2 = 3 };

// The element layouts the split kernel is compiled for: the element type
// and the shared-memory carve differ between them. fp8 e4m3 and e5m2 share
// one layout and quant_mxu is one more flag: both are uniform over a launch
// and are read at run time.
enum Layout : int { kLayoutBf16 = 0, kLayoutInt8 = 1, kLayoutFp8 = 2 };

// One layout: its element type, the vector that holds 8 elements, and the
// widening of one element to fp32 (exact for every kind; e5m2 picks the
// fp8 interpretation).
template <int L>
struct Payload;

template <>
struct Payload<kLayoutBf16> {
  using T = __nv_bfloat16;
  using Vec = uint4;
  static __device__ float widen(T x, bool) { return __bfloat162float(x); }
};

template <>
struct Payload<kLayoutInt8> {
  using T = int8_t;
  using Vec = uint2;
  static __device__ float widen(T x, bool) { return static_cast<float>(x); }
};

__device__ __forceinline__ __nv_fp8_interpretation_t fp8_interp(bool e5m2) {
  return e5m2 ? __NV_E5M2 : __NV_E4M3;
}

template <>
struct Payload<kLayoutFp8> {
  using T = __nv_fp8_storage_t;
  using Vec = uint2;
  static __device__ float widen(T x, bool e5m2) {
    return __half2float(static_cast<__half>(__nv_cvt_fp8_to_halfraw(x, fp8_interp(e5m2))));
  }
};

// the dequantized value the TPU kernel forms: fp32 product, rounded to bf16
__device__ __forceinline__ float dequant(float payload, __half scale) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(payload, __half2float(scale))));
}

// 16 bytes from device memory into shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// returns once at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
