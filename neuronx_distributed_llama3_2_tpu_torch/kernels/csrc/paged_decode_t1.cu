// Paged flash-decoding of one fresh query token per lane (t = 1, the step
// every served token goes through) over a block-pooled KV cache, for
// Hopper (sm_90a). The pool is bf16, or an int8 / fp8 (e4m3, e5m2) payload
// with one fp16 scale per (token row, kv head). Calls at t > 1 go to
// paged_decode_tile.cu (bf16) or paged_decode.cu (the quantized pools);
// kernels/paged_attention.py (kernel_route) picks the source.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py
//   _decode_kernel (:73), launched by paged_flash_decode (:245, pallas_call
//   at :419), plus the LSE combine that function runs after the kernel
//   (:438-449), at t == 1: mode 1, the quantized pool dequantized in the
//   kernel (mode 3, :178-187 and :223-228) and quant_mxu (mode 6,
//   :139-176); a row_live or tree_bits argument at t = 1 (modes 4 and 5)
//   only moves the walk's end and whether the query sees its own row.
//
// What bounds it on the H100: bytes, and the latency of the longest chain
// of dependent steps. Per K/V row of one kv head the call reads 4 D bytes
// (bf16) or 2 D + 4 (a 1-byte payload and two scales) and does 4 G D FLOPs:
// about G FLOPs a byte, against the ~295 at which the tensor cores would
// bound it, so tensor cores buy nothing. At the served calls (8 lanes, a
// few hundred rows each) the bytes take 1-2 us at 3.35 TB/s; a walk of 16
// pool blocks one after another, each a full round trip to device memory,
// takes ten times that. The TPU kernel's grid cuts each lane's kv_limit
// into four fixed splits, which costs nothing on a TPU, whose grid runs in
// order; here the first split of a short lane carried the whole lane.
//
// What the design does about it:
// - each lane's live blocks (the walk: up to the block holding its row,
//   nb = min(nblk, pos / 16 + 1), cut by row_live where given) are split
//   evenly over the launch's splits, in the kernel, from the device-resident
//   positions: split s walks blocks [s c, min((s + 1) c, nb)), c =
//   ceil(nb / splits). The splits past ceil(nb / c) walk nothing and exit at
//   once. The wrapper picks a split count that fills the card
//   (paged_attention.t1_num_splits) and mirrors the partition
//   (paged_attention.t1_split_ranges);
// - one thread block per (kv head, lane, split) serves the G query heads of
//   the GQA group from one read of each K/V row;
// - a split's pool blocks are issued at once, up to kStages of them (all
//   of them at the served calls: 16 splits of at most 64 blocks), into a
//   ring of shared-memory stages by cp.async (16 bytes a thread, the block
//   ids read from the lane's table first; on a quantized pool also the
//   block's fp16 scale rows of every kv head, one contiguous 32 NKV bytes
//   each for K and V), so that a split's walk costs one memory round trip,
//   not one a block. The payload
//   stays in its own type in shared memory and is widened where it is used.
//   One __syncthreads() a block step both publishes a stage and frees the
//   one the next copy refills;
// - the scores spread over all 128 threads: each warp takes its 4 rows of
//   each 16-row block, D / 8 lanes a row, 8 columns a lane, with the query
//   rows in shared memory (a layout whose float4 reads are free of bank
//   conflicts). The G dot products of a row are reduce-scattered over its
//   lanes, so that each lane ends with one (row, query head) score and the
//   softmax's exponentials are not repeated on every lane of the row. Each
//   warp keeps its own online softmax (m, l) of each query head; the rows'
//   bf16-rounded p and the heads' rescale factors go to every lane of the
//   warp through shared memory, and each lane accumulates p.V for D / 32
//   columns of every query head. The warps' (acc, m, l) are merged once, at
//   the end of the split, through shared memory that the ring no longer
//   needs. The group is padded to 4 or 8 query rows at compile time, so
//   that no loop over the heads branches;
// - the splits of a lane are merged in the same launch: each writes its
//   (acc, m, l) to a small fp32 scratch in paged_decode.cu's layout, and
//   one thread counts the block in a per-(lane, kv head) arrival counter
//   with one release-acquire atomic; the last to arrive merges them
//   (log-sum-exp: a warp per query head turns the splits' (m, l) into
//   weights, then every output's acc loads are issued together), writes
//   the (b, N, D) output and sets the counter back to 0 for the next
//   launch. A lane that one split covers writes its output directly. The
//   merge as a second launch read slower on an H100 (PERF.md).
//
// Numerics are paged_decode.cu's (the plain version is
// paged_flash_decode_reference in kernels/paged_attention.py): scores are
// fp32 dot products of the bf16 (or dequantized and bf16-rounded) operands,
// scaled by D^-0.5 in fp32; rows <= pos visible; online softmax in fp32
// with the m == -inf guards; p rounded to bf16 before p.V (fp32
// accumulation) while the denominator sums the unrounded p. A quantized
// pool's K and V are dequantized as bf16(float(payload) * float(scale)).
// Under quant_mxu an int8 pool's query rows are requantized (scale =
// max(max|q|, 1e-6) / 127, divided, rounded half to even, clipped to +-127),
// the dot accumulates int8 x int8 in int32 (__dp4a) and the score is ((acc *
// q_scale) * k_scale) * sm_scale; an fp8 pool's q is cast to the payload's
// fp8 type without saturation (NaN or inf past its range, as the
// reference's cast) and the score is (dot * k_scale) * sm_scale; p.V keeps
// the dequantized V. The sums run in another order than paged_decode.cu's:
// the two agree within the kernel tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = 16;  // pool block size (rows per block)
constexpr int kStages = 4;      // K/V ring depth: pool blocks in flight
constexpr int kMaxGroup = 8;    // query heads of one kv head (G)
constexpr int kVec = 8;         // columns of a K row one lane holds

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// Shared memory, in bytes, for a group padded to kG query rows, carved in
// this order: the q.k operand of the rows (fp32 [kG][D]; the padding rows
// 0), their int8 scales and values (mode 6 on an int8 pool), each warp's
// softmax weights of its rows of a block and rescale factors
// ([kWarps][4 + 1][kG]), then the ring,
// whose space the merges reuse after the walk: the warps' (acc, m, l), and
// in the last split to arrive the (m, l) of every split.
__host__ __device__ constexpr int q_bytes(int kg, int d) {
  return round16(kg * d * 4 + kg * 4 + kg * d) + kWarps * 5 * kg * 4;
}
// one stage: K and V payload rows of one pool block and one kv head, then
// (quantized) the block's K and V scale rows of every kv head
__host__ __device__ constexpr int stage_bytes(int d, int elem, bool quant, int nkv) {
  return 2 * kBlockRows * d * elem + (quant ? 2 * kBlockRows * nkv * 2 : 0);
}
__host__ __device__ constexpr int smem_bytes(int kg, int d, int elem, bool quant, int nkv,
                                             int splits) {
  return q_bytes(kg, d) + max_of(kStages * stage_bytes(d, elem, quant, nkv),
                                 max_of(kWarps * kg * (d + 2) * 4, 2 * splits * kg * 4));
}

// N elements of type T, as one aligned load
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Pool block blk of kv head h into one ring stage: K then V, 16 rows of D
// payload values each (this head's rows of the block are strided by NKV * D
// elements in the (num_blocks, bs, NKV, D) pool), then on a quantized pool
// the block's (bs, NKV) K and V scales, which are contiguous.
template <int D, int L>
__device__ __forceinline__ void stage_block(unsigned char* dst,
                                            const typename Payload<L>::T* __restrict__ k_pool,
                                            const typename Payload<L>::T* __restrict__ v_pool,
                                            const __half* __restrict__ k_scale,
                                            const __half* __restrict__ v_scale, size_t blk,
                                            int nkv, int h, int tid) {
  using T = typename Payload<L>::T;
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks of a row
  constexpr int kPayload = kBlockRows * D * static_cast<int>(sizeof(T));
  constexpr int kCopies = 2 * kBlockRows * kChunks;
  static_assert(kCopies % kThreads == 0, "a stage's copies split evenly over the threads");
#pragma unroll
  for (int j = 0; j < kCopies / kThreads; ++j) {
    const int e = tid + j * kThreads;
    const int tensor = e / (kBlockRows * kChunks);  // 0: K, 1: V
    const int r = (e / kChunks) % kBlockRows, c = e % kChunks;
    const T* src = (tensor ? v_pool : k_pool) + ((blk * kBlockRows + r) * nkv + h) * D;
    cp_async16(dst + tensor * kPayload + (r * D) * sizeof(T) + c * 16,
               reinterpret_cast<const unsigned char*>(src) + c * 16);
  }
  if constexpr (L != kLayoutBf16) {
    const int chunks = kBlockRows * nkv * 2 / 16;  // of one tensor's scale rows
    for (int e = tid; e < 2 * chunks; e += kThreads) {
      const int tensor = e / chunks, c = e % chunks;
      const __half* src = (tensor ? v_scale : k_scale) + blk * kBlockRows * nkv;
      cp_async16(dst + 2 * kPayload + tensor * kBlockRows * nkv * 2 + c * 16,
                 reinterpret_cast<const unsigned char*>(src) + c * 16);
    }
  }
}

// Sums of kG values over the kLanesPerRow lanes of a row (aligned lane
// groups), reduce-scattered: at each xor step o a lane keeps one half of
// its values and sends the other, so that after log2(kG) steps each lane
// holds one value, number scatter_index(lane), which the remaining steps
// sum over the whole row. kG - 1 + log2(kLanesPerRow / kG) shuffles where
// an all-reduce of every value takes kG log2(kLanesPerRow).
template <int N, int O, typename V>
__device__ __forceinline__ void reduce_scatter(V* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const V send = up ? v[k] : v[k + N / 2];
        const V keep = up ? v[k + N / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

template <int N, int O>
__device__ __forceinline__ int scatter_index(int lane) {
  if constexpr (O > 0 && N > 1) {
    return ((lane & O) ? N / 2 : 0) + scatter_index<N / 2, O / 2>(lane);
  } else {
    return 0;
  }
}

// one arrival at a (lane, kv head)'s counter: release of the block's
// partial results (ordered before by the __syncthreads() that precedes it)
// and acquire of the others' when it is the last; returns the old count
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// The n_live splits' (acc, m, l) of one (lane, kv head), from its first
// scratch row on, merged by log-sum-exp into its G output rows at o, by the
// kThreads threads of one block. Each warp turns the (m, l) of its query
// rows into each split's normalized weight, exp(m - m*) / l_tot, in shared
// memory (2 n_live G floats at ws), while the first batch of each
// thread's share of the splits' acc is loaded; then each output is the
// weighted sum, kBatch splits' loads in flight together (a load that waits
// for the one before costs a round trip to L2 per split).
template <int D, int kG>
__device__ __forceinline__ void merge_splits(const float* o_parts, const float* m_parts,
                                             const float* l_parts, size_t first, int n_live,
                                             int group, float* ws, __nv_bfloat16* o, int tid) {
  constexpr int kPer = kG * D / kThreads;  // outputs a thread owns
  constexpr int kBatch = 32 / kPer;
  const int lane = tid & 31, warp = tid >> 5;
  float* ls = ws + n_live * group;
  int gk[kPer];
  float a[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    gk[k] = min((tid + k * kThreads) / D, group - 1);
    a[k] = 0.f;
  }
  for (int u0 = 0; u0 < n_live; u0 += kBatch) {
    float ov[kBatch][kPer];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + k * kThreads;
        ov[j][k] = (u0 + j < n_live && e < group * D)
                       ? __ldcg(o_parts + (first + (u0 + j) * group) * D + e) : 0.f;
      }
    }
    if (u0 == 0) {
      for (int g = warp; g < group; g += kWarps) {
        float m_star = -CUDART_INF_F;
        for (int u = lane; u < n_live; u += 32) {
          const float mu = __ldcg(m_parts + first + u * group + g);
          ws[u * group + g] = mu;
          ls[u * group + g] = __ldcg(l_parts + first + u * group + g);
          m_star = fmaxf(m_star, mu);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m_star = fmaxf(m_star, __shfl_xor_sync(0xffffffffu, m_star, off));
        }
        float l_tot = 0.f;
        for (int u = lane; u < n_live; u += 32) {
          const float mu = ws[u * group + g];
          const float wgt = (mu == -CUDART_INF_F) ? 0.f : expf(mu - m_star);
          ws[u * group + g] = wgt;
          l_tot += wgt * ls[u * group + g];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          l_tot += __shfl_xor_sync(0xffffffffu, l_tot, off);
        }
        // a query row that sees no row has l_tot 0, and every acc 0
        const float inv = __fdividef(1.f, l_tot == 0.f ? 1.f : l_tot);
        for (int u = lane; u < n_live; u += 32) ws[u * group + g] *= inv;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (u0 + j >= n_live) break;
#pragma unroll
      for (int k = 0; k < kPer; ++k) a[k] += ws[(u0 + j) * group + gk[k]] * ov[j][k];
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    if (e < group * D) o[e] = __float2bfloat16(a[k]);
  }
}

// Blocks an SM a kernel instance asks ptxas to fit. Left to itself ptxas
// aims at a register count for occupancy and spilled a few values of the
// D = 128 instances held across the walk; 1 block lets them keep every
// value in registers (no spill), and the 1B's instances (D = 64, G <= 4,
// 72 registers) keep room for 6 blocks.
template <int D, int kG>
constexpr int kMinBlocks = D == 64 && kG == 4 ? 6 : 1;

template <int D, int L, int kG>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D, kG>)
paged_decode_t1_kernel(
    const __nv_bfloat16* __restrict__ q,                // (b, N, D)
    const typename Payload<L>::T* __restrict__ k_pool,  // (num_blocks, bs, NKV, D)
    const typename Payload<L>::T* __restrict__ v_pool,  // (num_blocks, bs, NKV, D)
    const __half* __restrict__ k_scale,                 // (num_blocks, bs, NKV) or null
    const __half* __restrict__ v_scale,                 // (num_blocks, bs, NKV) or null
    const int* __restrict__ tables,                     // (b, W)
    const int* __restrict__ positions,                  // (b,)
    const int* __restrict__ row_live,                   // (b,) or null
    const int* __restrict__ tree_bits,                  // (b, 1) or null
    float* o_parts,                                     // (b, NKV, S, G, D)
    float* m_parts,                                     // (b, NKV, S, G)
    float* l_parts,                                     // (b, NKV, S, G)
    __nv_bfloat16* __restrict__ out,                    // (b, N, D)
    int* __restrict__ arrivals,                         // (b, NKV), 0 between launches
    int n_heads, int nkv, int group, int w, int nblk, int splits, float sm_scale,
    bool mxu, bool e5m2) {
  using P = Payload<L>;
  using T = typename P::T;
  constexpr bool kQuant = L != kLayoutBf16;
  constexpr int kLanesPerRow = D / kVec;                           // 8 or 16
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;                  // 4 or 2
  constexpr int kPasses = kBlockRows / (kWarps * kRowsPerWarp);    // 1 or 2
  constexpr int kWarpRows = kPasses * kRowsPerWarp;                // 4: a warp's rows of a block
  constexpr int kCols = D / 32;                                    // p.V columns a lane owns
  constexpr int kPayload = kBlockRows * D * static_cast<int>(sizeof(T));
  constexpr int kPer = kG * D / kThreads;                          // q or output values a thread owns
  static_assert(kG % 4 == 0 && kG <= kLanesPerRow && kG * D % kThreads == 0,
                "kG rows of D split over the threads and over a row's lanes");
  const bool int8_mxu = L == kLayoutInt8 && mxu;
  const bool fp8_mxu = L == kLayoutFp8 && mxu;

  // the split varies slowest over the grid, so that blocks are handed out
  // in the order (kv head, lane) within split 0, 1, ...: the splits that
  // walk (the low ones) start first, those past a lane's blocks, which
  // exit at once, last
  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the group's query rows h * G + g (g < G), each thread's share, read
  // before anything waits on the lane's position
  const __nv_bfloat16* qg = q + (static_cast<size_t>(i) * n_heads + h * group) * D;
  __nv_bfloat16 qv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    qv[k] = e < group * D ? qg[e] : __float2bfloat16(0.f);
  }

  // the lane's walk: its blocks up to the one holding pos (under row_live
  // the one holding pos + row_live[i] - 1, none when that row lies before
  // row 0), split evenly; the query sees rows <= last (under tree_bits its
  // own row only when bit 0 of its mask is set)
  const int pos = positions[i];
  int nb = min(nblk, pos / kBlockRows + 1);
  if (row_live != nullptr) nb = min(nb, (pos + row_live[i] + kBlockRows - 1) / kBlockRows);
  nb = max(nb, 0);
  const int last = (tree_bits != nullptr && !(tree_bits[i] & 1)) ? pos - 1 : pos;
  const int per_split = (nb + splits - 1) / splits;
  const int n_live = nb > 0 ? (nb + per_split - 1) / per_split : 0;  // splits that walk
  __nv_bfloat16* o = out + (static_cast<size_t>(i) * n_heads + h * group) * D;  // [G][D]
  if (s >= n_live) {
    if (s == 0) {  // the walk reads no block: every query row sees nothing and gives 0
      for (int e = tid; e < group * D; e += kThreads) o[e] = __float2bfloat16(0.f);
    }
    return;
  }
  const int lb0 = s * per_split;
  const int n_walk = min(per_split, nb - lb0);
  const int* tbl = tables + static_cast<size_t>(i) * w;
  const int stage = stage_bytes(D, sizeof(T), kQuant, nkv);

  extern __shared__ __align__(16) unsigned char smem[];
  // q_s row g holds column d = 8 c + 4 hh + k at hh * D / 2 + 4 c + k, so
  // that the lanes of a row read their 8 columns as two conflict-free
  // float4 loads
  float* q_s = reinterpret_cast<float*>(smem);                     // [kG][D]
  float* qscl_s = q_s + kG * D;                                    // [kG]
  int8_t* qi_s = reinterpret_cast<int8_t*>(qscl_s + kG);           // [kG][D]
  float* p_s = reinterpret_cast<float*>(smem + round16(kG * D * 4 + kG * 4 + kG * D)) +
               warp * (kWarpRows + 1) * kG;  // this warp's p [4][kG], then its alpha [kG]
  float* alpha_s = p_s + kWarpRows * kG;
  unsigned char* ring = smem + q_bytes(kG, D);
  auto q_at = [](int d) { return (d & 4 ? D / 2 : 0) + (d >> 3) * 4 + (d & 3); };

  // every stage's copy in flight: one group per stage, empty or not, since
  // wait_group counts them; the block ids are read first, all at once
  int blk[kStages];
#pragma unroll
  for (int j = 0; j < kStages; ++j) blk[j] = j < n_walk ? tbl[lb0 + j] : 0;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n_walk) {
      stage_block<D, L>(ring + j * stage, k_pool, v_pool, k_scale, v_scale,
                        static_cast<size_t>(blk[j]), nkv, h, tid);
    }
    cp_async_commit();
  }

  // q as the q.k operand (0 past G)
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    float x = __bfloat162float(qv[k]);
    if constexpr (L == kLayoutFp8) {
      // the reference's unsaturated cast: out-of-range q is NaN (e4m3) or
      // inf (e5m2) and poisons its row, as there
      if (mxu) x = P::widen(__nv_cvt_float_to_fp8(x, __NV_NOSAT, fp8_interp(e5m2)), e5m2);
    }
    q_s[(e / D) * D + q_at(e % D)] = x;
  }
  __syncthreads();  // q_s is ready
  if (int8_mxu) {
    for (int g = warp; g < kG; g += kWarps) {
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(q_s[g * D + d]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float scl = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
      if (lane == 0) qscl_s[g] = scl;
      for (int d = lane; d < D; d += 32) {
        const float x = rintf(__fdiv_rn(q_s[g * D + q_at(d)], scl));
        qi_s[g * D + d] = static_cast<int8_t>(fminf(fmaxf(x, -127.f), 127.f));
      }
    }
    __syncthreads();  // qscl_s and qi_s are ready
  }

  // this lane: row sub of its warp's rows of a pass and columns d0 .. d0 +
  // 7 in the score step, after which it holds the score of query row my_g;
  // columns c0 .. c0 + kCols - 1 of every query row in p.V
  const int sub = lane / kLanesPerRow;
  const int c8 = lane % kLanesPerRow;
  const int d0 = c8 * kVec;
  const int c0 = lane * kCols;
  const int my_g = scatter_index<kG, kLanesPerRow / 2>(lane);
  const float my_qscl = int8_mxu ? qscl_s[my_g] : 0.f;
  float m = -CUDART_INF_F, l = 0.f;  // of query row my_g over the warp's rows
  float acc[kG][kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }

  // commit group j holds block j: the prologue's kStages groups, then one
  // group a step from step 1 on
  for (int j = 0; j < n_walk; ++j) {
    // this thread's copies of block j have landed
    if (j == 0) {
      cp_async_wait<kStages - 1>();
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // everyone's have, and every warp is done with block j - 1
    if (j >= 1) {
      if (j + kStages - 1 < n_walk) {
        // into the stage block j - 1 used
        stage_block<D, L>(ring + ((j - 1) % kStages) * stage, k_pool, v_pool, k_scale,
                          v_scale, static_cast<size_t>(tbl[lb0 + j + kStages - 1]), nkv, h,
                          tid);
      }
      cp_async_commit();
    }
    const unsigned char* st = ring + (j % kStages) * stage;
    const T* k_s = reinterpret_cast<const T*>(st);
    const T* v_s = reinterpret_cast<const T*>(st + kPayload);
    const __half* ks_s = reinterpret_cast<const __half*>(st + 2 * kPayload);
    const __half* vs_s = ks_s + kBlockRows * nkv;
    const int row0 = (lb0 + j) * kBlockRows;  // the block's first logical row

    // the score of (row, my_g) for each of the lane's rows
    float sc[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = (p * kWarps + warp) * kRowsPerWarp + sub;
      const typename P::Vec kv = *reinterpret_cast<const typename P::Vec*>(k_s + r * D + d0);
      const T* kb = reinterpret_cast<const T*>(&kv);
      __half ks = __float2half(0.f);
      if constexpr (kQuant) ks = ks_s[r * nkv + h];
      float score;
      if (int8_mxu) {
        int dot[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          dot[g] = 0;
          if constexpr (L == kLayoutInt8) {
            const uint2 qw = *reinterpret_cast<const uint2*>(qi_s + g * D + d0);
            dot[g] = __dp4a(static_cast<int>(qw.x), static_cast<int>(kv.x), 0);
            dot[g] = __dp4a(static_cast<int>(qw.y), static_cast<int>(kv.y), dot[g]);
          }
        }
        reduce_scatter<kG, kLanesPerRow / 2>(dot, lane);
        score = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot[0]), my_qscl),
                                    __half2float(ks)),
                          sm_scale);
      } else {
        float kf[kVec];
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          const float raw = P::widen(kb[x], e5m2);
          kf[x] = (kQuant && !mxu) ? dequant(raw, ks) : raw;
        }
        float dot[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + 4 * c8);
          const float4 qb = *reinterpret_cast<const float4*>(q_s + g * D + D / 2 + 4 * c8);
          dot[g] = qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                   qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
        }
        reduce_scatter<kG, kLanesPerRow / 2>(dot, lane);
        score = fp8_mxu ? __fmul_rn(__fmul_rn(dot[0], __half2float(ks)), sm_scale)
                        : dot[0] * sm_scale;
      }
      sc[p] = row0 + r <= last ? score : -CUDART_INF_F;
    }

    // the warp's online softmax of query row my_g over its rows of this
    // block; each row's bf16-rounded p and the rescale factor to the warp
    float mb = sc[0];
#pragma unroll
    for (int p = 1; p < kPasses; ++p) mb = fmaxf(mb, sc[p]);
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    const float m_new = fmaxf(m, mb);
    // a query row that has seen nothing keeps m == -inf: its alpha and p are 0
    const float alpha = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
    m = m_new;
    float rs = 0.f;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const float pv = (sc[p] == -CUDART_INF_F) ? 0.f : expf(sc[p] - m_new);
      rs += pv;
      p_s[(p * kRowsPerWarp + sub) * kG + my_g] = __bfloat162float(__float2bfloat16(pv));
    }
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    }
    l = l * alpha + rs;  // the unrounded p
    if (sub == 0) alpha_s[my_g] = alpha;
    __syncwarp();

    // acc = acc * alpha + bf16(p) V over the warp's rows
#pragma unroll
    for (int g = 0; g < kG; g += 4) {
      const float4 al = *reinterpret_cast<const float4*>(alpha_s + g);
      const float ag[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g + x][c] *= ag[x];
      }
    }
#pragma unroll
    for (int rr = 0; rr < kWarpRows; ++rr) {
      const int r = ((rr / kRowsPerWarp) * kWarps + warp) * kRowsPerWarp + rr % kRowsPerWarp;
      const Pack<T, kCols> pk = *reinterpret_cast<const Pack<T, kCols>*>(v_s + r * D + c0);
      __half vs = __float2half(0.f);
      if constexpr (kQuant) vs = vs_s[r * nkv + h];
      float vf[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float raw = P::widen(pk.v[c], e5m2);
        vf[c] = kQuant ? dequant(raw, vs) : raw;
      }
#pragma unroll
      for (int g = 0; g < kG; g += 4) {
        const float4 pb = *reinterpret_cast<const float4*>(p_s + rr * kG + g);
        const float pg[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[g + x][c] += pg[x] * vf[c];
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing is left in flight
  __syncthreads();     // every warp is done with the ring: the merges reuse it

  // the warps' (acc, m, l), merged into the split's
  float* mw = reinterpret_cast<float*>(ring);  // [kWarps][kG]
  float* lw = mw + kWarps * kG;                // [kWarps][kG]
  float* aw = lw + kWarps * kG;                // [kWarps][kG][D]
  if (sub == 0) {
    mw[warp * kG + my_g] = m;
    lw[warp * kG + my_g] = l;
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) aw[(warp * kG + g) * D + c0 + c] = acc[g][c];
  }
  __syncthreads();
  const size_t lane_head = static_cast<size_t>(i) * nkv + h;
  const size_t part = (lane_head * splits + s) * group;  // the split's first (lane, head, g) row
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    if (e >= group * D) break;  // e grows with k
    const int g = e / D, d = e % D;
    float m_star = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) m_star = fmaxf(m_star, mw[u * kG + g]);
    float l_tot = 0.f, a = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float mu = mw[u * kG + g];
      const float wgt = (mu == -CUDART_INF_F) ? 0.f : expf(mu - m_star);
      l_tot += wgt * lw[u * kG + g];
      a += wgt * aw[(u * kG + g) * D + d];
    }
    if (n_live == 1) {
      o[e] = __float2bfloat16(__fdividef(a, l_tot == 0.f ? 1.f : l_tot));
    } else {
      o_parts[part * D + e] = a;
      if (d == 0) {
        m_parts[part + g] = m_star;
        l_parts[part + g] = l_tot;
      }
    }
  }
  if (n_live == 1) return;

  // the last split of this (lane, kv head) to arrive merges them all
  __shared__ bool merges;
  __syncthreads();  // the block's partial results are written
  if (tid == 0) {
    merges = arrive(arrivals + lane_head) == n_live - 1;
    if (merges) arrivals[lane_head] = 0;  // every split has arrived: ready for the next launch
  }
  __syncthreads();
  if (!merges) return;
  merge_splits<D, kG>(o_parts, m_parts, l_parts, lane_head * splits * group, n_live, group,
                      reinterpret_cast<float*>(ring), o, tid);
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
  void* arrivals;
  int b, n_heads, nkv, w, nblk, splits;
  float sm_scale;
  cudaStream_t stream;
};

template <int D, int L, int kG>
cudaError_t launch(const Args& a, bool mxu, bool e5m2) {
  using T = typename Payload<L>::T;
  const int smem = smem_bytes(kG, D, sizeof(T), L != kLayoutBf16, a.nkv, a.splits);
  auto kernel = paged_decode_t1_kernel<D, L, kG>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.nkv, a.b, a.splits), kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const __half*>(a.k_scale),
      static_cast<const __half*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<const int*>(a.row_live),
      static_cast<const int*>(a.tree_bits), static_cast<float*>(a.o_parts),
      static_cast<float*>(a.m_parts), static_cast<float*>(a.l_parts),
      static_cast<__nv_bfloat16*>(a.out), static_cast<int*>(a.arrivals), a.n_heads, a.nkv,
      a.n_heads / a.nkv, a.w, a.nblk, a.splits, a.sm_scale, mxu, e5m2);
  return cudaGetLastError();
}

// the group padded to 4 query rows (the 1B and 3B, G = 4 and 3) or to 8
template <int D, int L>
cudaError_t launch_group(const Args& a, bool mxu, bool e5m2) {
  return a.n_heads / a.nkv <= 4 ? launch<D, L, 4>(a, mxu, e5m2) : launch<D, L, 8>(a, mxu, e5m2);
}

template <int D>
cudaError_t launch_kind(const Args& a, int kind, bool mxu) {
  switch (kind) {
    case kBf16:
      return mxu ? cudaErrorInvalidValue : launch_group<D, kLayoutBf16>(a, false, false);
    case kInt8:
      return launch_group<D, kLayoutInt8>(a, mxu, false);
    case kE4m3:
      return launch_group<D, kLayoutFp8>(a, mxu, false);
    case kE5m2:
      return launch_group<D, kLayoutFp8>(a, mxu, true);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors allocated by the caller (pool and scale pointers
// 16-byte aligned; the scales null for a bf16 pool; row_live and tree_bits
// null unless the caller passes them). arrivals is a (b, NKV) int32 buffer
// that is 0 when the launch starts and is left 0 when it ends; launches
// that share it must not run at the same time (one stream). kv_kind numbers
// the payload (0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2) and quant_mxu
// selects mode 6 for a quantized one; the stream is the caller's current
// CUDA stream. Takes head_dim 64 or 128, block_size 16, G <= 8. Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int paged_decode_t1(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* positions, const void* row_live,
    const void* tree_bits, void* o_parts, void* m_parts, void* l_parts, void* out,
    void* arrivals, int b, int n_heads, int nkv, int head_dim, int block_size, int w,
    int nblk, int splits, int kv_kind, int quant_mxu, float sm_scale, void* stream) {
  const bool quantized = kv_kind != kBf16;
  if (block_size != kBlockRows || nkv <= 0 || n_heads % nkv != 0 ||
      n_heads / nkv > kMaxGroup || n_heads < nkv || splits < 1 || nblk > w || b < 1 ||
      arrivals == nullptr || (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, row_live,
               tree_bits, o_parts, m_parts, l_parts, out, arrivals, b, n_heads, nkv, w,
               nblk, splits, sm_scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_kind<64>(a, kv_kind, quant_mxu != 0));
    case 128:
      return static_cast<int>(launch_kind<128>(a, kv_kind, quant_mxu != 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
