// Paged flash-decoding for Hopper (sm_90a): attention of t <= 8 fresh query
// tokens per lane over a block-pooled bf16 KV cache, read in place through
// a per-lane block table.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py
//   _decode_kernel (:73), launched by paged_flash_decode (:245, pallas_call
//   at :419), plus the LSE combine that function runs after the kernel
//   (:438-449). Modes ported: t == 1 and t <= 8 block-causal on a bf16 pool.
//   Quantized pools, row_live, tree_bits and quant_mxu are later work.
//
// What bounds it on the H100: bytes of K/V read from device memory. Every
// live pool row of a kv head is D bf16 values of K and of V, and it serves
// t*G query rows; that is about t*G FLOPs per byte read (at most 64 here),
// far below the ~295 FLOPs/byte at which the tensor cores would bound it.
//
// What the design does about it:
// - one thread block per (lane, kv head, split): each K/V pool row is read
//   from device memory once and serves all t*G query rows of that head
//   (the G query heads of the GQA group and the t fresh tokens) out of
//   shared memory, so no K/V is replicated or re-read per query head;
// - the block reads its own block-table entries and walks only the pool
//   blocks its split owns, stopping at the lane's frontier pos + t - 1:
//   nothing past a request's last written row is read, and no gathered
//   (b, kv_limit, NKV, D) copy of the cache is ever made;
// - K/V rows are loaded 16 bytes per thread (a head's D values are
//   contiguous in the pool), and the next pool block's loads are issued
//   into registers before the current block is computed, so one block's
//   memory latency overlaps the previous block's arithmetic;
// - split-K over the sequence gives b * NKV * splits blocks, enough to
//   spread a long context over the SMs when the decode batch is small;
// - the per-split (acc, m, l) go to a small fp32 scratch and a second
//   kernel merges them (log-sum-exp) and writes the (b, t, N, D) output.
//
// Numerics (the plain version is paged_flash_decode_reference in
// kernels/paged_attention.py): scores are fp32 dot products of the bf16
// operands, scaled by D^-0.5 in fp32; masked by row <= pos + ti with
// ti = r / G for tile row r; online softmax in fp32 with the m == -inf
// guard on the rescale factor; p is rounded to bf16 before the p.V product
// (fp32 accumulation), as the TPU kernel's p.astype(v.dtype) does, while
// the denominator sums the unrounded p.
//
// Simple first: CUDA-core fp32 arithmetic, no tensor cores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockRows = 16;     // pool block size (rows per block)
constexpr int kMaxTileRows = 64;   // t * G <= 8 * 8
constexpr int kCombineThreads = 256;

// One pool block of one kv head: kBlockRows rows of D bf16, loaded as
// 16-byte vectors (8 bf16 each), kVec vectors per thread per tensor.
template <int D>
struct BlockTile {
  static constexpr int kVecPerRow = D / 8;
  static constexpr int kVec = kBlockRows * kVecPerRow / kThreads;
  static_assert(kVec >= 1 && kBlockRows * kVecPerRow % kThreads == 0,
                "tile must split evenly over the threads");
  uint4 k[kVec];
  uint4 v[kVec];

  __device__ void load(const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool, size_t blk,
                       int nkv, int h, int tid) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int e = tid + j * kThreads;
      const int row = e / kVecPerRow, c = e % kVecPerRow;
      // this head's rows of the pool block are strided by NKV * D elements
      const size_t off = ((blk * kBlockRows + row) * nkv + h) * D + c * 8;
      k[j] = *reinterpret_cast<const uint4*>(k_pool + off);
      v[j] = *reinterpret_cast<const uint4*>(v_pool + off);
    }
  }

  __device__ void store(float* k_s, int k_stride, float* v_s, int tid) const {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int e = tid + j * kThreads;
      const int row = e / kVecPerRow, c = e % kVecPerRow;
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&k[j]);
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&v[j]);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        k_s[row * k_stride + c * 8 + x] = __bfloat162float(kb[x]);
        v_s[row * D + c * 8 + x] = __bfloat162float(vb[x]);
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,       // (b, t, N, D)
    const __nv_bfloat16* __restrict__ k_pool,  // (num_blocks, bs, NKV, D)
    const __nv_bfloat16* __restrict__ v_pool,  // (num_blocks, bs, NKV, D)
    const int* __restrict__ tables,            // (b, W)
    const int* __restrict__ positions,         // (b,)
    float* __restrict__ o_parts,               // (b, NKV, S, t*G, D)
    float* __restrict__ m_parts,               // (b, NKV, S, t*G)
    float* __restrict__ l_parts,               // (b, NKV, S, t*G)
    int t, int n_heads, int nkv, int group, int w, int nblk, int bps,
    float sm_scale) {
  constexpr int DP = D + 1;  // padded row stride: conflict-free row walks
  constexpr int kAcc = kMaxTileRows * D / kThreads;  // accumulator slots
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int i = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int tg = t * group;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [tg][DP]
  float* k_s = q_s + tg * DP;          // [bs][DP]
  float* v_s = k_s + kBlockRows * DP;  // [bs][D]
  float* p_s = v_s + kBlockRows * D;   // [tg][bs] softmax weights, bf16-rounded
  float* m_s = p_s + tg * kBlockRows;  // [tg] running max
  float* l_s = m_s + tg;               // [tg] running denominator
  float* a_s = l_s + tg;               // [tg] this block's rescale factor

  const int pos = positions[i];
  // the split's logical blocks, cut at the lane's deepest fresh row
  const int lb_begin = s * bps;
  const int lb_stop = min(min((s + 1) * bps, nblk), (pos + t - 1) / kBlockRows + 1);
  const int* tbl = tables + static_cast<size_t>(i) * w;

  BlockTile<D> tile;
  if (lb_begin < lb_stop) {
    tile.load(k_pool, v_pool, static_cast<size_t>(tbl[lb_begin]), nkv, h, tid);
  }

  // query tile row r = ti * G + g holds q[i, ti, h * G + g, :]
  for (int e = tid; e < tg * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int ti = r / group, g = r % group;
    const size_t src =
        ((static_cast<size_t>(i) * t + ti) * n_heads + h * group + g) * D + d;
    q_s[r * DP + d] = __bfloat162float(q[src]);
  }
  for (int r = tid; r < tg; r += kThreads) {
    m_s[r] = -CUDART_INF_F;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  const int n_sc = tg * kBlockRows;       // (row, column) scores per block
  const int n_pad = (n_sc + 31) & ~31;    // rounded up to whole warps

  for (int lb = lb_begin; lb < lb_stop; ++lb) {
    tile.store(k_s, DP, v_s, tid);
    __syncthreads();  // k_s / v_s (and, first time round, q_s) are ready
    if (lb + 1 < lb_stop) {
      // in flight while this block is computed
      tile.load(k_pool, v_pool, static_cast<size_t>(tbl[lb + 1]), nkv, h, tid);
    }
    // scores and the online-softmax update, one thread per (row, column):
    // a row's 16 columns sit on 16 neighbouring lanes of one warp, so its
    // max and sum are warp shuffles. The loop runs over whole warps (n_pad)
    // so that every lane of a warp takes part in the shuffles.
    for (int e = tid; e < n_pad; e += kThreads) {
      const int r = e / kBlockRows, c = e % kBlockRows;
      const bool live = e < n_sc;
      float sc = -CUDART_INF_F;
      if (live && lb * kBlockRows + c <= pos + r / group) {  // block-causal mask
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += q_s[r * DP + d] * k_s[c * DP + d];
        sc = dot * sm_scale;
      }
      const float m_prev = live ? m_s[r] : -CUDART_INF_F;
      float m_new = sc;
#pragma unroll
      for (int o = kBlockRows / 2; o > 0; o >>= 1) {
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o, kBlockRows));
      }
      m_new = fmaxf(m_new, m_prev);
      // a row fully masked so far keeps m == -inf: its p is 0, not NaN
      const float p = (sc == -CUDART_INF_F) ? 0.f : expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int o = kBlockRows / 2; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o, kBlockRows);
      }
      // every lane of the row has read m_s[r] before its c == 0 lane
      // overwrites it (shuffles order no memory)
      __syncwarp();
      if (live) {
        p_s[e] = __bfloat162float(__float2bfloat16(p));
        if (c == 0) {
          const float alpha = (m_prev == -CUDART_INF_F) ? 0.f : expf(m_prev - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + sum;
          a_s[r] = alpha;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kThreads;
      if (e >= tg * D) break;  // e grows with k: the rest lie past the tile
      const int r = e / D, d = e % D;
      float pv = 0.f;
#pragma unroll
      for (int c = 0; c < kBlockRows; ++c) pv += p_s[r * kBlockRows + c] * v_s[c * D + d];
      acc[k] = acc[k] * a_s[r] + pv;
    }
    __syncthreads();  // k_s / v_s / p_s are rewritten by the next block
  }

  // the split's raw (acc, m, l); a split with no live block leaves
  // (0, -inf, 0), which the combine weighs 0
  const size_t part = ((static_cast<size_t>(i) * nkv + h) * splits + s) * tg;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kThreads;
    if (e >= tg * D) break;
    o_parts[(part + e / D) * D + e % D] = acc[k];
  }
  __syncthreads();  // m_s / l_s were last written before the loop's final barrier
  for (int r = tid; r < tg; r += kThreads) {
    m_parts[part + r] = m_s[r];
    l_parts[part + r] = l_s[r];
  }
}

// Log-sum-exp merge of the splits, normalize once, write (b, t, N, D) bf16.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
paged_decode_combine_kernel(
    const float* __restrict__ o_parts, const float* __restrict__ m_parts,
    const float* __restrict__ l_parts, __nv_bfloat16* __restrict__ out,
    int t, int n_heads, int nkv, int group, int splits) {
  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int tg = t * group;
  const size_t base = (static_cast<size_t>(i) * nkv + h) * splits;
  for (int e = threadIdx.x; e < tg * D; e += kCombineThreads) {
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
}

template <int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* positions, void* o_parts,
                   void* m_parts, void* l_parts, void* out, int b, int t,
                   int n_heads, int nkv, int w, int nblk, int splits, int bps,
                   float sm_scale, cudaStream_t stream) {
  const int group = n_heads / nkv;
  const int tg = t * group;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(tg) * (D + 1) + kBlockRows * (D + 1) +
       kBlockRows * D + tg * kBlockRows + 3 * tg);
  auto split_kernel = paged_decode_split_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  split_kernel<<<dim3(splits, nkv, b), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      static_cast<float*>(o_parts), static_cast<float*>(m_parts),
      static_cast<float*>(l_parts), t, n_heads, nkv, group, w, nblk, bps,
      sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<D><<<dim3(nkv, b), kCombineThreads, 0, stream>>>(
      static_cast<const float*>(o_parts), static_cast<const float*>(m_parts),
      static_cast<const float*>(l_parts), static_cast<__nv_bfloat16*>(out), t,
      n_heads, nkv, group, splits);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors allocated by the caller (pool pointers 16-byte
// aligned); the stream is the caller's current CUDA stream. Returns a
// cudaError_t: 0 when both launches were accepted.
extern "C" int paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, void* o_parts, void* m_parts, void* l_parts,
    void* out, int b, int t, int n_heads, int nkv, int head_dim,
    int block_size, int w, int nblk, int splits, int bps, float sm_scale,
    void* stream) {
  if (block_size != kBlockRows || nkv <= 0 || n_heads % nkv != 0 || t < 1 ||
      t * (n_heads / nkv) > kMaxTileRows || splits < 1 || bps < 1 ||
      nblk > w || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k_pool, v_pool, tables, positions,
                                         o_parts, m_parts, l_parts, out, b, t,
                                         n_heads, nkv, w, nblk, splits, bps,
                                         sm_scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k_pool, v_pool, tables, positions,
                                          o_parts, m_parts, l_parts, out, b, t,
                                          n_heads, nkv, w, nblk, splits, bps,
                                          sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
