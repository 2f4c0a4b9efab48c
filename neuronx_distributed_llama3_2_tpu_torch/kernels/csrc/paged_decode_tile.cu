// Paged flash-decoding of a query tile (t > 1 fresh tokens per lane) over a
// block-pooled KV cache, on Hopper's tensor cores (sm_90a). The pool is
// bf16, or an int8 / fp8 (e4m3, e5m2) payload with one fp16 scale per (token
// row, kv head). The t = 1 decode goes to paged_decode_t1.cu; tiles wider
// than kMaxRows stay with paged_decode.cu; kernels/paged_attention.py
// (kernel_route) picks the source.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py
//   _decode_kernel (:73), launched by paged_flash_decode (:245, pallas_call
//   at :419), plus the LSE combine that function runs after the kernel
//   (:438-449), for t > 1: the block-causal tile (mode 2), the quantized
//   pool dequantized in the kernel (mode 3, :178-187 and :223-228),
//   row_live (mode 4, :90-97 and :131-133), tree_bits (mode 5, :195-209)
//   and quant_mxu, the q.k dot in the payload's precision (mode 6,
//   :139-176).
//
// What bounds it on the H100: bytes of K/V read from device memory. Each
// pool row of a kv head is 2 * D bf16 values of K and V (or 2 * D payload
// bytes and two scales) and serves the t * G tile rows of that head:
// 4 * D * t * G FLOPs for 4 * D bytes (bf16), at most 128 FLOPs a byte here
// (256 for a 1-byte payload), below the ~295 at which the tensor cores
// would bound it. At the served shapes (1-8 lanes, 32-128 tile rows,
// 512-1024 rows of context) the bytes take about 0.1-2 us; what a launch
// takes beyond that is latency: the walk of a split is a chain of
// dependent block steps.
//
// What the design does about it:
// - one thread block per (lane, kv head, split) owns all t * G <= kMaxRows
//   tile rows, one warp per 16 rows (ceil(t * G / 16) warps compute), so
//   each K/V pool block is read from device memory once per split and
//   serves every tile row of that head (the G query heads of the GQA group
//   and the t fresh tokens);
// - both products run on the tensor cores (mma.sync, fp32 accumulation):
//   per 16-row pool block a warp computes its 16 x 16 scores and adds
//   16 x D of P.V (D / 8 products of m16n8k16, bf16 in). The scores are
//   2 x D / 16 bf16 products of m16n8k16, or under quant_mxu 2 x D / 32
//   products of m16n8k32 on the 8-bit payload (int8 x int8 -> int32, or
//   fp8 x fp8 -> fp32). Each warp keeps its Q fragments (D / 16 x 4 words;
//   D / 32 x 4 words of 8-bit q under quant_mxu, with each row's int8 scale),
//   its D / 8 fp32 C tiles of output and the (m, l) of its thread's two
//   rows in registers for the whole walk; the softmax weights go from the
//   score accumulators into the A fragments of P.V without leaving
//   registers;
// - K and V blocks are staged into a ring of kStages shared-memory stages
//   by cp.async (16 bytes a thread, the block id read from the lane's
//   table), rows padded (kPad bf16, kPayloadPad bytes) so that the
//   fragment loads are free of bank conflicts. A quantized stage holds the
//   1-byte payload of K and V and the block's (bs, NKV) fp16 scale tiles,
//   which are contiguous. Blocks lb + 1 .. lb + kStages - 1 are in flight
//   while block lb is computed, and one __syncthreads() a block both
//   publishes a stage and frees the one the next copy refills;
// - a quantized block is dequantized once, by every thread of the block,
//   into one bf16 working stage shared by the warps (V always, K in mode
//   3), behind one more __syncthreads(). A quantized launch has kMaxWarps
//   warps whatever its tile: those past the tile's rows only stage and
//   dequantize, so that each thread converts one or two 8-value chunks a
//   block, all of its loads issued before its first conversion (one warp
//   converting the block alone is a chain of dependent instructions that
//   no other warp hides, PERF.md). The products then read the stage as
//   they read a bf16 stage. Under quant_mxu the score products read K's
//   payload from the ring as it landed: a B fragment of m16n8k32 is 4
//   consecutive bytes of one K row, one 32-bit shared load;
// - the walk is paged_decode.cu's: a split's blocks up to the one holding
//   pos + t - 1, and under row_live a break at the block holding the lane's
//   last live row (the loop keeps the t bound: bounding it by row_live made
//   paged_decode.cu's D = 64 instances slower on an H100, PERF.md). Every
//   block past the live frontier is fully masked for a live row (alpha 1,
//   p 0), so a live row is bitwise what it is without row_live; a chain's
//   tree_bits give the block-causal mask and so bitwise its result;
// - split-K over the sequence gives b * NKV * splits blocks; the per-split
//   (acc, m, l) go to an fp32 scratch in paged_decode.cu's layout, and a
//   second kernel merges them (log-sum-exp) into the (b, t, N, D) output,
//   one thread per output element.
// No TMA or wgmma: a 16-row pool block is one m16 tile per warp.
//
// Numerics (the plain version is paged_flash_decode_reference in
// kernels/paged_attention.py): scores are fp32 products of the bf16
// operands, scaled by D^-0.5 in fp32; masked by row <= pos + ti with
// ti = r / G for tile row r (under tree_bits: row < pos, or bit row - pos of
// node ti's mask); online softmax in fp32 with the m == -inf guards on p
// and on the rescale factor; p is rounded to bf16 for P.V (fp32
// accumulation) while the denominator sums the unrounded p. A quantized
// pool's K and V are dequantized as bf16(float(payload) * float(scale))
// (dequant in paged_common.cuh). Under quant_mxu an int8 pool's query rows
// are requantized once (scale = max(max|q|, 1e-6) / 127, divided, rounded
// half to even, clipped to +-127), the dot is exact in int32 and the score
// ((acc * q_scale) * k_scale) * sm_scale; an fp8 pool's q is cast to the
// payload's fp8 type without saturation (NaN or inf past its range, as the
// reference's cast), the fp8 products accumulate in fp32 (the k steps in
// one accumulator: starting each from zero moved neither the probe's
// agreement nor the time, PERF.md), and the score is (dot * k_scale) *
// sm_scale; p.V keeps the dequantized V. The products sum in another order
// than paged_decode.cu's scalar loops: the two agree within the kernel
// tolerance, not bitwise (except the int8 mode 6 scores, exact in both).

#include "flash_common.cuh"
#include "paged_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockRows = 16;                   // pool block size (rows per block)
constexpr int kMaxRows = 128;                    // tile rows one block owns
constexpr int kMaxWarps = kMaxRows / 16;         // one warp per 16 tile rows
constexpr int kStages = 4;                       // K/V ring depth
constexpr int kMaxTreeNodes = 32;                // tree_bits: one int32 mask per node
constexpr int kCombineThreads = 256;
constexpr int kPayloadPad = 16;                  // bytes of padding per staged payload row

// Pool block blk of kv head h, K and V, into one ring stage: 16 rows of D
// values each, one 16-byte cp.async per vector. This head's rows of the
// block are strided by NKV * D elements in the (num_blocks, bs, NKV, D) pool.
template <int D>
__device__ __forceinline__ void stage_block(bf16* k_dst, bf16* v_dst,
                                            const bf16* __restrict__ k_pool,
                                            const bf16* __restrict__ v_pool,
                                            size_t blk, int nkv, int h, int tid,
                                            int nthreads) {
  constexpr int kVecs = D / 8;
  constexpr int LD = D + kPad;
  for (int e = tid; e < kBlockRows * kVecs; e += nthreads) {
    const int r = e / kVecs, c = e % kVecs;
    const size_t src = ((blk * kBlockRows + r) * nkv + h) * D + c * 8;
    cp_async16(k_dst + r * LD + c * 8, k_pool + src);
    cp_async16(v_dst + r * LD + c * 8, v_pool + src);
  }
}

// One ring stage of a quantized pool, in bytes: K then V payload rows of
// one pool block and one kv head (D + kPayloadPad bytes a row: consecutive
// rows 4 banks apart, so that the 8 rows of a B fragment load hit 32
// distinct banks), then the block's K and V scale tiles of every kv head.
__host__ __device__ constexpr int quant_stage_bytes(int d, int nkv) {
  return 2 * kBlockRows * (d + kPayloadPad) + 2 * kBlockRows * nkv * 2;
}

// Pool block blk of kv head h into one ring stage of a quantized pool: K
// then V, 16 rows of D payload bytes each, then the block's (bs, NKV) K and
// V scales, which are contiguous.
template <int D>
__device__ __forceinline__ void stage_quant_block(unsigned char* dst,
                                                  const unsigned char* __restrict__ k_pool,
                                                  const unsigned char* __restrict__ v_pool,
                                                  const __half* __restrict__ k_scale,
                                                  const __half* __restrict__ v_scale,
                                                  size_t blk, int nkv, int h, int tid,
                                                  int nthreads) {
  constexpr int kChunks = D / 16;  // 16-byte chunks of a payload row
  constexpr int SP = D + kPayloadPad;
  constexpr int kPayload = kBlockRows * SP;
  for (int e = tid; e < 2 * kBlockRows * kChunks; e += nthreads) {
    const int tensor = e / (kBlockRows * kChunks);  // 0: K, 1: V
    const int r = (e / kChunks) % kBlockRows, c = e % kChunks;
    const unsigned char* src =
        (tensor ? v_pool : k_pool) + ((blk * kBlockRows + r) * nkv + h) * D + c * 16;
    cp_async16(dst + tensor * kPayload + r * SP + c * 16, src);
  }
  const int chunks = kBlockRows * nkv * 2 / 16;  // of one tensor's scale tile
  for (int e = tid; e < 2 * chunks; e += nthreads) {
    const int tensor = e / chunks, c = e % chunks;
    const __half* src = (tensor ? v_scale : k_scale) + blk * kBlockRows * nkv;
    cp_async16(dst + 2 * kPayload + tensor * kBlockRows * nkv * 2 + c * 16,
               reinterpret_cast<const unsigned char*>(src) + c * 16);
  }
}

// A ring stage's payload dequantized into the bf16 working stage (rows of
// D + kPad at dst: K then V), by the kMaxWarps * 32 threads of a quantized
// launch, 8 values a thread a step: V alone (kTensors 1, mode 6) or K and
// V (kTensors 2, mode 3). Every load a thread makes is issued before its
// first conversion. Each value is bf16(payload * scale), dequant's
// rounding, done once (the packing rounds); the fp8 flavour is fixed at
// compile time.
template <int D, int L, int kTensors, bool kE5m2>
__device__ __forceinline__ void dequant_stage(bf16* dst, const unsigned char* st,
                                              const __half* k_scales, int nkv, int h, int tid) {
  using P = Payload<L>;
  using T = typename P::T;
  constexpr int kThreads = kMaxWarps * 32;
  constexpr int kVecs = D / 8;                 // 8-byte chunks of a row
  constexpr int kChunks = kBlockRows * kVecs;  // of one tensor
  constexpr int kTotal = kTensors * kChunks;
  constexpr int kIter = (kTotal + kThreads - 1) / kThreads;
  constexpr int SP = D + kPayloadPad;
  constexpr int LD = D + kPad;
  constexpr int kFirst = 2 - kTensors;         // 0: K, 1: V
  uint2 raw[kIter];
  __half sc[kIter];
#pragma unroll
  for (int k = 0; k < kIter; ++k) {
    const int e = tid + k * kThreads;
    if (e < kTotal) {
      const int tensor = kFirst + e / kChunks, r = (e % kChunks) / kVecs, c = e % kVecs;
      raw[k] = *reinterpret_cast<const uint2*>(st + (tensor * kBlockRows + r) * SP + c * 8);
      sc[k] = k_scales[(tensor * kBlockRows + r) * nkv + h];
    }
  }
#pragma unroll
  for (int k = 0; k < kIter; ++k) {
    const int e = tid + k * kThreads;
    if (e < kTotal) {
      const int tensor = kFirst + e / kChunks, r = (e % kChunks) / kVecs, c = e % kVecs;
      const float s = __half2float(sc[k]);
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t word = (w < 2 ? raw[k].x : raw[k].y) >> (16 * (w & 1));
        ow[w] = pack_float(__fmul_rn(P::widen(static_cast<T>(word), kE5m2), s),
                           __fmul_rn(P::widen(static_cast<T>(word >> 8), kE5m2), s));
      }
      *reinterpret_cast<uint4*>(dst + (tensor * kBlockRows + r) * LD + c * 8) = o;
    }
  }
}

// x cast to fp8 without saturation, as the reference's cast: the
// hardware's satfinite conversion (of x twice, so that either byte is x's),
// and past the format's rounding edge NaN (e4m3) or inf (e5m2)
__device__ __forceinline__ unsigned char fp8_nosat(float x, bool e5m2) {
  unsigned short d;
  if (e5m2) {
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %1;\n" : "=h"(d) : "f"(x));
    return fabsf(x) >= 61440.f ? (signbit(x) ? 0xFC : 0x7C) : static_cast<unsigned char>(d);
  }
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %1;\n" : "=h"(d) : "f"(x));
  return fabsf(x) > 464.f ? 0x7F : static_cast<unsigned char>(d);
}

// c += a b, 8-bit operands (mma.sync m16n8k32; PTX ISA, "Matrix fragments
// for mma.m16n8k32"): with g = lane / 4, t = lane % 4, a[0] = A[g][4t..4t+3],
// a[1] = A[g+8][4t..4t+3], a[2] = A[g][4t+16..4t+19], a[3] =
// A[g+8][4t+16..4t+19]; b[0] = B[4t..4t+3][g], b[1] = B[4t+16..4t+19][g]
// (four values a register, the lower index in the low byte); C as m16n8k16.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_fp8(float c[4], const uint32_t a[4], const uint32_t b[2],
                                        bool e5m2) {
  if (e5m2) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e5m2.e5m2.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Four bytes, the lower index in the low byte.
__device__ __forceinline__ uint32_t pack_bytes(const unsigned char x[4]) {
  return static_cast<uint32_t>(x[0]) | (static_cast<uint32_t>(x[1]) << 8) |
         (static_cast<uint32_t>(x[2]) << 16) | (static_cast<uint32_t>(x[3]) << 24);
}

// L is the payload layout; kMxu (quantized pools only) selects mode 6, the
// q.k dot on the 8-bit payload. e5m2 picks the fp8 flavour, uniform over a
// launch.
template <int D, int L, bool kMxu>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_tile_kernel(
    const bf16* __restrict__ q,                         // (b, t, N, D)
    const typename Payload<L>::T* __restrict__ k_pool,  // (num_blocks, bs, NKV, D)
    const typename Payload<L>::T* __restrict__ v_pool,  // (num_blocks, bs, NKV, D)
    const __half* __restrict__ k_scale,                 // (num_blocks, bs, NKV) or null
    const __half* __restrict__ v_scale,                 // (num_blocks, bs, NKV) or null
    const int* __restrict__ tables,                     // (b, W)
    const int* __restrict__ positions,                  // (b,)
    const int* __restrict__ row_live,                   // (b,) or null
    const int* __restrict__ tree_bits,                  // (b, t) or null
    float* __restrict__ o_parts,                        // (b, NKV, S, t*G, D)
    float* __restrict__ m_parts,                        // (b, NKV, S, t*G)
    float* __restrict__ l_parts,                        // (b, NKV, S, t*G)
    int t, int n_heads, int nkv, int group, int w, int nblk, int splits, int bps,
    float sm_scale, bool e5m2) {
  constexpr bool kQuant = L != kLayoutBf16;
  static_assert(kQuant || !kMxu, "mode 6 needs an 8-bit payload");
  constexpr int LD = D + kPad;
  constexpr int SP = D + kPayloadPad;
  constexpr int kPayload = kBlockRows * SP;  // bytes of one staged payload tensor
  constexpr int kDt = D / 8;   // 8-wide C tiles across D
  constexpr int kDc = D / 16;  // 16-deep k chunks across D (bf16 products)
  constexpr int kDk = D / 32;  // 32-deep k steps across D (8-bit products)
  // bf16: the ring of K/V stages; quantized: the one dequantized working
  // stage, behind the payload ring in dynamic shared memory
  __shared__ __align__(16) bf16 kv_s[kQuant ? 1 : kStages][2][kBlockRows * LD];
  extern __shared__ __align__(16) unsigned char ring[];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int i = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int tg = t * group;
  const int t4 = lane & 3;
  const int pos = positions[i];
  const int stage = kQuant ? quant_stage_bytes(D, nkv) : 0;

  // the split's logical blocks, cut at the one holding pos + t - 1 (lb_stop)
  // and under row_live at the one holding pos + row_live[i] - 1 (live_stop,
  // none when that row lies before row 0); the loop keeps lb_stop as its
  // bound and breaks at live_stop
  const int lb_begin = s * bps;
  const int lb_stop = min(min((s + 1) * bps, nblk), (pos + t - 1) / kBlockRows + 1);
  const int live_stop = row_live != nullptr
      ? min(lb_stop, (pos + row_live[i] + kBlockRows - 1) / kBlockRows) : lb_stop;
  const int n_walk = live_stop - lb_begin;  // blocks staged (none when <= 0)
  const int* tbl = tables + static_cast<size_t>(i) * w;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_walk) {
      if constexpr (kQuant) {
        stage_quant_block<D>(ring + j * stage, reinterpret_cast<const unsigned char*>(k_pool),
                             reinterpret_cast<const unsigned char*>(v_pool), k_scale, v_scale,
                             static_cast<size_t>(tbl[lb_begin + j]), nkv, h, tid, nthreads);
      } else {
        stage_block<D>(kv_s[j][0], kv_s[j][1], k_pool, v_pool,
                       static_cast<size_t>(tbl[lb_begin + j]), nkv, h, tid, nthreads);
      }
    }
    cp_async_commit();  // one group per stage, empty or not: wait_group counts them
  }

  // this thread's two tile rows, r = ti * G + g holding q[i, ti, h * G + g, :];
  // rows at or past t * G are zero, fully masked and never written. The
  // A fragments of q: bf16 (kDc of them), or under quant_mxu the 8-bit q
  // (kDk of them; an int8 pool's rows with their scales in qscl)
  int rows[2], tis[2];
  unsigned bits[2] = {0u, 0u};
  uint32_t qf[kMxu ? kDk : kDc][4];
  float qscl[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + (lane >> 2) + 8 * half;
    rows[half] = r;
    tis[half] = r / group;
    const bool live = r < tg;
    if constexpr (!kMxu) {
      const bf16* qr = q + ((static_cast<size_t>(i) * t + tis[half]) * n_heads + h * group +
                            r % group) * D + 2 * t4;
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
        qf[dc][half] = live ? *reinterpret_cast<const uint32_t*>(qr + dc * 16) : 0u;
        qf[dc][2 + half] = live ? *reinterpret_cast<const uint32_t*>(qr + dc * 16 + 8) : 0u;
      }
    } else if (warp * 16 < tg) {  // a warp that only stages needs no q
      // columns 32 kk + 4 t4 + (0..3) and 32 kk + 16 + 4 t4 + (0..3) of the
      // row: the four lanes of a row hold all of its D values between them
      const bf16* qr = q + ((static_cast<size_t>(i) * t + tis[half]) * n_heads + h * group +
                            r % group) * D + 4 * t4;
      float x[kDk][2][4];
      float amax = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          uint2 raw = make_uint2(0u, 0u);
          if (live) raw = *reinterpret_cast<const uint2*>(qr + kk * 32 + hi * 16);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            x[kk][hi][k] = __bfloat162float(v[k]);
            amax = fmaxf(amax, fabsf(x[kk][hi][k]));
          }
        }
      }
      float scl = 0.f;
      if constexpr (L == kLayoutInt8) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        scl = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
        qscl[half] = scl;
      }
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          unsigned char b8[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if constexpr (L == kLayoutInt8) {
              const float v = rintf(__fdiv_rn(x[kk][hi][k], scl));
              b8[k] = static_cast<unsigned char>(
                  static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f)));
            } else {
              // the reference's unsaturated cast: out-of-range q is NaN
              // (e4m3) or inf (e5m2) and poisons its row, as there
              b8[k] = fp8_nosat(x[kk][hi][k], e5m2);
            }
          }
          qf[kk][2 * hi + half] = pack_bytes(b8);
        }
      }
    }
    if (live && tree_bits != nullptr) {
      bits[half] = static_cast<unsigned>(tree_bits[static_cast<size_t>(i) * t + tis[half]]);
    }
  }

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc[kDt][4] = {};

  for (int lb = lb_begin; lb < lb_stop; ++lb) {
    if (lb >= live_stop) break;
    const int j = lb - lb_begin;
    cp_async_wait<kStages - 2>();  // this thread's copies of block lb have landed
    __syncthreads();  // everyone's have, and every warp is done with block lb - 1
    if (j + kStages - 1 < n_walk) {
      // into the stage block lb - 1 used
      const int jn = j + kStages - 1;
      if constexpr (kQuant) {
        stage_quant_block<D>(ring + (jn % kStages) * stage,
                             reinterpret_cast<const unsigned char*>(k_pool),
                             reinterpret_cast<const unsigned char*>(v_pool), k_scale, v_scale,
                             static_cast<size_t>(tbl[lb_begin + jn]), nkv, h, tid, nthreads);
      } else {
        stage_block<D>(kv_s[jn % kStages][0], kv_s[jn % kStages][1], k_pool, v_pool,
                       static_cast<size_t>(tbl[lb_begin + jn]), nkv, h, tid, nthreads);
      }
    }
    cp_async_commit();
    const bf16* k_s = kv_s[kQuant ? 0 : j % kStages][0];
    const bf16* v_s = kv_s[kQuant ? 0 : j % kStages][1];
    // a quantized stage: K's payload and the block's K scale tile
    const unsigned char* kq_s = ring + (j % kStages) * stage;
    const __half* ks_s = reinterpret_cast<const __half*>(kq_s + 2 * kPayload);
    if constexpr (kQuant) {
      constexpr int kTensors = kMxu ? 1 : 2;  // mode 6 reads K's payload as it is
      if (L == kLayoutFp8 && e5m2) {
        dequant_stage<D, L, kTensors, true>(kv_s[0][0], kq_s, ks_s, nkv, h, tid);
      } else {
        dequant_stage<D, L, kTensors, false>(kv_s[0][0], kq_s, ks_s, nkv, h, tid);
      }
      __syncthreads();  // the working stage is ready
      if (warp * 16 >= tg) continue;  // a warp that only stages and dequantizes
    }

    // S = Q K^T: this warp's 16 rows x the block's 16 rows
    float sc[2][4] = {};
    if constexpr (!kMxu) {
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t b[2];
          load_b_t(b, k_s + nt * 8 * LD + dc * 16, LD, lane);
          mma_bf16(sc[nt], qf[dc], b);
        }
      }
    } else {
      // B(k, n) = K[n][k]: 4 consecutive payload bytes of K row n = g
      int sci[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const unsigned char* kr = kq_s + (nt * 8 + (lane >> 2)) * SP + kk * 32 + 4 * t4;
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                 *reinterpret_cast<const uint32_t*>(kr + 16)};
          if constexpr (L == kLayoutInt8) {
            mma_s8(sci[nt], qf[kk], b);
          } else {
            mma_fp8(sc[nt], qf[kk], b, e5m2);
          }
        }
      }
      if constexpr (L == kLayoutInt8) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[nt][c] = static_cast<float>(sci[nt][c]);
        }
      }
    }

    // scale, mask, and the block's row maxima; u is the column's offset
    // into the fresh block (negative in the committed prefix)
    float mb[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int half = c >> 1;
        const int u = lb * kBlockRows + nt * 8 + 2 * t4 + (c & 1) - pos;
        const bool ok = rows[half] < tg &&
            (tree_bits == nullptr ? u <= tis[half]  // block-causal
                                  : u < 0 || (u < t && ((bits[half] >> u) & 1u)));
        if constexpr (!kMxu) {
          sc[nt][c] = ok ? sc[nt][c] * sm_scale : -CUDART_INF_F;
        } else {
          // the k scale of the column's pool row
          const float ks = __half2float(ks_s[(nt * 8 + 2 * t4 + (c & 1)) * nkv + h]);
          float score;
          if constexpr (L == kLayoutInt8) {
            score = __fmul_rn(__fmul_rn(__fmul_rn(sc[nt][c], qscl[half]), ks), sm_scale);
          } else {
            score = __fmul_rn(__fmul_rn(sc[nt][c], ks), sm_scale);
          }
          sc[nt][c] = ok ? score : -CUDART_INF_F;
        }
        mb[half] = fmaxf(mb[half], sc[nt][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      const float m_new = fmaxf(m[r], mb[r]);
      // a row fully masked so far keeps m == -inf: its alpha and p are 0
      alpha[r] = (m[r] == -CUDART_INF_F) ? 0.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (sc[nt][c] == -CUDART_INF_F) ? 0.f : expf(sc[nt][c] - m[c >> 1]);
        sc[nt][c] = p;
        rs[c >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];  // the unrounded p
    }
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] *= alpha[c >> 1];
    }

    // acc += bf16(P) V: the 16 x 16 P is one A fragment (C tiles 0 and 1)
    const uint32_t pa[4] = {pack_float(sc[0][0], sc[0][1]), pack_float(sc[0][2], sc[0][3]),
                            pack_float(sc[1][0], sc[1][1]), pack_float(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      uint32_t b[2];
      load_b(b, v_s + dt * 8, LD, lane);
      mma_bf16(acc[dt], pa, b);
    }
  }
  cp_async_wait<0>();  // nothing is left in flight when the block exits

  // the split's raw (acc, m, l) for this thread's rows; a split with no
  // block leaves (0, -inf, 0), which the combine weighs 0
  const size_t part = ((static_cast<size_t>(i) * nkv + h) * splits + s) * tg;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= tg) continue;
    float* o = o_parts + (part + rows[half]) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      *reinterpret_cast<float2*>(o + dt * 8) =
          make_float2(acc[dt][2 * half], acc[dt][2 * half + 1]);
    }
    if (t4 == 0) {
      m_parts[part + rows[half]] = m[half];
      l_parts[part + rows[half]] = l[half];
    }
  }
}

// Log-sum-exp merge of the splits, normalize once, write (b, t, N, D) bf16:
// paged_decode.cu's combine (local to that file), with one thread per
// output element over a (t*G*D / kCombineThreads, NKV, b) grid. One block
// per (kv head, lane), as there, leaves 64 blocks of 32 elements a thread
// at 128 tile rows; that took 60-65 % of a launch on an H100 (PERF.md).
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
paged_decode_tile_combine_kernel(
    const float* __restrict__ o_parts, const float* __restrict__ m_parts,
    const float* __restrict__ l_parts, bf16* __restrict__ out,
    int t, int n_heads, int nkv, int group, int splits) {
  const int h = blockIdx.y;
  const int i = blockIdx.z;
  const int tg = t * group;
  const int e = blockIdx.x * kCombineThreads + threadIdx.x;
  if (e >= tg * D) return;
  const size_t base = (static_cast<size_t>(i) * nkv + h) * splits;
  const int r = e / D, d = e % D;
  float m_star = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, m_parts[(base + s) * tg + r]);
  float l_tot = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t pr = (base + s) * tg + r;
    const float m = m_parts[pr];
    const float wgt = (m == -CUDART_INF_F) ? 0.f : expf(m - m_star);
    l_tot += wgt * l_parts[pr];
    acc += wgt * o_parts[pr * D + d];
  }
  const float o = acc / (l_tot == 0.f ? 1.f : l_tot);
  const int ti = r / group, g = r % group;
  out[((static_cast<size_t>(i) * t + ti) * n_heads + h * group + g) * D + d] =
      __float2bfloat16(o);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* tables;
  const void* positions;
  const void* row_live;
  const void* tree_bits;
  void* o_parts;
  void* m_parts;
  void* l_parts;
  void* out;
  int b, t, n_heads, nkv, w, nblk, splits, bps;
  float sm_scale;
  cudaStream_t stream;
};

template <int D, int L, bool kMxu>
cudaError_t launch(const Args& a, bool e5m2) {
  using T = typename Payload<L>::T;
  const int group = a.n_heads / a.nkv;
  // a quantized launch takes every warp a block may have: those past the
  // tile's rows stage and dequantize beside the others
  const int warps = L == kLayoutBf16 ? (a.t * group + 15) / 16 : kMaxWarps;
  auto kernel = paged_decode_tile_kernel<D, L, kMxu>;
  // the payload ring of a quantized pool, beside the static working stage
  const int ring = L == kLayoutBf16 ? 0 : kStages * quant_stage_bytes(D, a.nkv);
  constexpr int kStatic = 2 * kBlockRows * (D + kPad) * static_cast<int>(sizeof(bf16));
  if (ring > 0 && ring + kStatic > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.splits, a.nkv, a.b), warps * 32, ring, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const __half*>(a.k_scale),
      static_cast<const __half*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<const int*>(a.row_live),
      static_cast<const int*>(a.tree_bits), static_cast<float*>(a.o_parts),
      static_cast<float*>(a.m_parts), static_cast<float*>(a.l_parts), a.t, a.n_heads,
      a.nkv, group, a.w, a.nblk, a.splits, a.bps, a.sm_scale, e5m2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int combine_blocks = (a.t * group * D + kCombineThreads - 1) / kCombineThreads;
  paged_decode_tile_combine_kernel<D>
      <<<dim3(combine_blocks, a.nkv, a.b), kCombineThreads, 0, a.stream>>>(
      static_cast<const float*>(a.o_parts), static_cast<const float*>(a.m_parts),
      static_cast<const float*>(a.l_parts), static_cast<bf16*>(a.out), a.t, a.n_heads,
      a.nkv, group, a.splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_kind(const Args& a, int kind, bool mxu) {
  switch (kind) {
    case kBf16:
      return mxu ? cudaErrorInvalidValue : launch<D, kLayoutBf16, false>(a, false);
    case kInt8:
      return mxu ? launch<D, kLayoutInt8, true>(a, false)
                 : launch<D, kLayoutInt8, false>(a, false);
    case kE4m3:
    case kE5m2:
      return mxu ? launch<D, kLayoutFp8, true>(a, kind == kE5m2)
                 : launch<D, kLayoutFp8, false>(a, kind == kE5m2);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors allocated by the caller (pool and scale pointers
// 16-byte aligned; the scales null for a bf16 pool; row_live null unless
// the caller passes per-lane live row counts, tree_bits null unless it
// passes per-node ancestor masks); kv_kind numbers the payload (0 bf16,
// 1 int8, 2 fp8 e4m3, 3 fp8 e5m2) and quant_mxu selects mode 6 for a
// quantized one; the stream is the caller's current CUDA stream. Takes
// 2 <= t, t * G <= 128, head_dim 64 or 128, block_size 16, and t <= 32
// under tree_bits. Returns a cudaError_t: 0 when both launches were
// accepted.
extern "C" int paged_decode_tile(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* positions, const void* row_live,
    const void* tree_bits, void* o_parts, void* m_parts, void* l_parts, void* out, int b,
    int t, int n_heads, int nkv, int head_dim, int block_size, int w, int nblk, int splits,
    int bps, int kv_kind, int quant_mxu, float sm_scale, void* stream) {
  const bool quantized = kv_kind != kBf16;
  if (block_size != kBlockRows || nkv <= 0 || n_heads % nkv != 0 || t < 2 ||
      t * (n_heads / nkv) > kMaxRows || (tree_bits != nullptr && t > kMaxTreeNodes) ||
      splits < 1 || bps < 1 || nblk > w || b < 1 ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, row_live,
               tree_bits, o_parts, m_parts, l_parts, out, b, t, n_heads, nkv, w, nblk,
               splits, bps, sm_scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_kind<64>(a, kv_kind, quant_mxu != 0));
    case 128:
      return static_cast<int>(launch_kind<128>(a, kv_kind, quant_mxu != 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
