// Paged flash-decoding for Hopper (sm_90a): attention of t fresh query tokens
// per lane over a block-pooled KV cache, read in place through a per-lane
// block table. The pool is bf16, or an int8 / fp8 (e4m3, e5m2)
// payload with one fp16 scale per (token row, kv head).
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py
//   _decode_kernel (:73), launched by paged_flash_decode (:245, pallas_call
//   at :419), plus the LSE combine that function runs after the kernel
//   (:438-449). Modes ported: t == 1 and t > 1 block-causal (modes 1-2);
//   the quantized pool, dequantized in the kernel (mode 3, :178-187 and
//   :223-228); row_live, each lane's walk cut at its live frontier (mode 4,
//   :90-97 and :131-133); quant_mxu, the q.k dot in the payload's precision
//   (mode 6, :139-176); tree_bits, a per-node ancestor bitmask in place of the
//   block-causal mask within the fresh block (mode 5, :195-209, checks
//   :339-351).
//
// What bounds it on the H100: bytes of K/V read from device memory. Every
// live pool row of a kv head is D values of K and of V (bf16, or one byte
// each plus a 2-byte scale), and it serves t*G query rows; that is about
// t*G FLOPs per byte read (at most 64 here, 128 for a 1-byte pool), far
// below the ~295 FLOPs/byte at which the tensor cores would bound it (a
// wide tile, split into row chunks below, reads each block once per chunk).
//
// What the design does about it:
// - one thread block per (lane, kv head, split): each K/V pool row is read
//   from device memory once and serves all t*G query rows of that head
//   (the G query heads of the GQA group and the t fresh tokens) out of
//   shared memory, so no K/V is replicated or re-read per query head;
// - the block reads its own block-table entries and walks only the pool
//   blocks its split owns, stopping at the lane's frontier pos + t - 1, or
//   pos + row_live[i] - 1 when the caller passes per-lane live row counts
//   (a runtime pointer, null otherwise: no extra template instance): nothing
//   past a request's last live row is read, and no gathered
//   (b, kv_limit, NKV, D) copy of the cache is ever made. A live row's
//   output is bitwise what it is without row_live: every block past the
//   live frontier is fully masked for it (alpha 1, p 0), and a split left
//   with no block emits (0, -inf, 0) as a fully masked one does;
// - K/V rows are loaded as 8 values per thread (16 bytes of bf16, 8 bytes
//   of a 1-byte payload: a head's D values are contiguous in the pool, and
//   a 16-row block of one head is then one vector per thread at D = 64),
//   together with the rows' scales (the scales of a head are strided by
//   NKV in the (num_blocks, bs, NKV) arrays: one 2-byte load per row, at
//   the same table-dereferenced block id). The next pool block's loads are
//   issued into registers before the current block is computed, so one
//   block's memory latency overlaps the previous block's arithmetic;
// - split-K over the sequence gives b * NKV * splits blocks, enough to
//   spread a long context over the SMs when the decode batch is small;
// - a tile of more than kMaxTileRows query rows (t * G: 128 for a 32-node
//   tree at G = 4) is cut into row chunks of at most kMaxTileRows, one more
//   grid dimension: each thread keeps kMaxTileRows * D / kThreads
//   accumulators in registers, which bounds the rows one block can own
//   (the D = 128 instances already spill at 64). A chunk's walk stops at
//   the block holding its own deepest query token (or the live frontier,
//   if nearer): every block past it is fully masked for every row of the
//   chunk, under the block-causal mask and under tree_bits alike, since a
//   node's ancestors precede it. A launch of at most kMaxTileRows rows is
//   one chunk and computes what it did before chunks existed; a wider one
//   reads each K/V block once per chunk;
// - tree_bits, when the caller passes it (a runtime pointer, null
//   otherwise: no extra template instance), is staged per tile row in
//   shared memory; row u of the fresh block is visible to tile row r when
//   bit u of its node's mask is set, the committed prefix (u < 0) always;
// - the per-split (acc, m, l) go to a small fp32 scratch and a second
//   kernel merges them (log-sum-exp) and writes the (b, t, N, D) output.
//
// Numerics (the plain version is paged_flash_decode_reference in
// kernels/paged_attention.py): scores are fp32 dot products of the bf16
// operands, scaled by D^-0.5 in fp32; masked by row <= pos + ti with
// ti = r / G for tile row r (under tree_bits: row < pos, or bit row - pos
// of node ti's mask); online softmax in fp32 with the m == -inf
// guard on the rescale factor; p is rounded to bf16 before the p.V product
// (fp32 accumulation), as the TPU kernel's p.astype(v.dtype) does, while
// the denominator sums the unrounded p. A quantized pool's K and V are
// dequantized as bf16(float(payload) * float(scale)), rounded to bf16 as
// the TPU kernel's .astype(q.dtype) does, before any dot. Under quant_mxu
// the q.k dot keeps the payload: for int8 each query tile row is
// requantized once (scale = max(max|q|, 1e-6) / 127, divided, rounded half
// to even, clipped to +-127), the dot accumulates int8 x int8 in int32
// (__dp4a) and the score is ((acc * q_scale) * k_scale) * sm_scale; for
// fp8 q is cast to the payload's fp8 type without saturation (e4m3 past
// its range is NaN, e5m2 inf, as the reference's cast), the dot of the
// widened fp8 values is fp32 and the score (dot * k_scale) * sm_scale. p.V
// keeps the dequantized V in every quantized mode.
//
// Simple first: CUDA-core arithmetic (fp32, int32 dot products), no tensor
// cores, no TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockRows = 16;     // pool block size (rows per block)
constexpr int kMaxTileRows = 64;   // tile rows one block owns (a row chunk)
constexpr int kMaxTreeNodes = 32;  // tree_bits: one int32 ancestor mask per node
constexpr int kCombineThreads = 256;

// Shared memory of the split kernel, in 4-byte words, carved in this order,
// for a chunk of tr tile rows.
__host__ __device__ constexpr int q_words(int d) { return d / 4 + 1; }
__host__ __device__ constexpr size_t smem_words(int tr, int d, bool int8_mxu) {
  return static_cast<size_t>(tr) * (d + 1)        // q_s
         + kBlockRows * (d + 1)                    // k_s
         + kBlockRows * d                          // v_s
         + tr * kBlockRows                         // p_s
         + 3 * tr                                  // m_s, l_s, a_s
         + kBlockRows                              // ks_s
         + tr                                      // qscl_s
         + tr                                      // tb_s
         + (int8_mxu ? (tr + kBlockRows) * q_words(d) : 0);  // qw_s, kw_s
}

// One pool block of one kv head: kBlockRows rows of D values, loaded as
// vectors of 8 values, kVec vectors per thread per tensor, and the scale
// of each row a thread's vectors cover.
template <int L, int D>
struct BlockTile {
  using P = Payload<L>;
  using T = typename P::T;
  using Vec = typename P::Vec;
  static constexpr bool kQuant = L != kLayoutBf16;
  static constexpr int kVecPerRow = D / 8;
  static constexpr int kVec = kBlockRows * kVecPerRow / kThreads;
  static_assert(sizeof(Vec) == 8 * sizeof(T), "a vector holds 8 values");
  static_assert(kVec >= 1 && kBlockRows * kVecPerRow % kThreads == 0,
                "tile must split evenly over the threads");
  Vec k[kVec];
  Vec v[kVec];
  __half ks[kVec];
  __half vs[kVec];

  __device__ void load(const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                       const __half* __restrict__ k_scale,
                       const __half* __restrict__ v_scale, size_t blk, int nkv,
                       int h, int tid) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int e = tid + j * kThreads;
      const int row = e / kVecPerRow, c = e % kVecPerRow;
      // this head's rows of the pool block are strided by NKV * D elements
      const size_t srow = (blk * kBlockRows + row) * nkv + h;
      const size_t off = srow * D + c * 8;
      k[j] = *reinterpret_cast<const Vec*>(k_pool + off);
      v[j] = *reinterpret_cast<const Vec*>(v_pool + off);
      if constexpr (kQuant) {
        ks[j] = k_scale[srow];
        vs[j] = v_scale[srow];
      }
    }
  }

  // k_s holds the q.k operand: bf16 K, or dequantized K, or (fp8 under
  // quant_mxu) the widened payload; int8 under quant_mxu stores the raw
  // payload bytes in kw_s instead. v_s holds bf16 or dequantized V.
  __device__ void store(float* k_s, int k_stride, float* v_s, float* ks_s,
                        int8_t* kw_s, bool mxu, bool e5m2, int tid) const {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int e = tid + j * kThreads;
      const int row = e / kVecPerRow, c = e % kVecPerRow;
      const T* kb = reinterpret_cast<const T*>(&k[j]);
      const T* vb = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int d = c * 8 + x;
        if constexpr (!kQuant) {
          k_s[row * k_stride + d] = P::widen(kb[x], false);
          v_s[row * D + d] = P::widen(vb[x], false);
        } else {
          if (!mxu) {
            k_s[row * k_stride + d] = dequant(P::widen(kb[x], e5m2), ks[j]);
          } else if constexpr (L == kLayoutInt8) {
            kw_s[row * q_words(D) * 4 + d] = kb[x];
          } else {
            k_s[row * k_stride + d] = P::widen(kb[x], e5m2);
          }
          v_s[row * D + d] = dequant(P::widen(vb[x], e5m2), vs[j]);
        }
      }
      if constexpr (kQuant) {
        if (c == 0) ks_s[row] = __half2float(ks[j]);
      }
    }
  }
};

template <int D, int L>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,             // (b, t, N, D)
    const typename Payload<L>::T* __restrict__ k_pool,  // (num_blocks, bs, NKV, D)
    const typename Payload<L>::T* __restrict__ v_pool,  // (num_blocks, bs, NKV, D)
    const __half* __restrict__ k_scale,              // (num_blocks, bs, NKV) or null
    const __half* __restrict__ v_scale,              // (num_blocks, bs, NKV) or null
    const int* __restrict__ tables,                  // (b, W)
    const int* __restrict__ positions,               // (b,)
    const int* __restrict__ row_live,                // (b,) or null
    const int* __restrict__ tree_bits,               // (b, t) or null
    float* __restrict__ o_parts,                     // (b, NKV, S, t*G, D)
    float* __restrict__ m_parts,                     // (b, NKV, S, t*G)
    float* __restrict__ l_parts,                     // (b, NKV, S, t*G)
    int t, int n_heads, int nkv, int group, int w, int nblk, int splits, int bps,
    float sm_scale, bool mxu, bool e5m2) {
  // mode 6's two dots; mxu and e5m2 are the same for every block of a launch
  const bool int8_mxu = L == kLayoutInt8 && mxu;
  const bool fp8_mxu = L == kLayoutFp8 && mxu;
  constexpr int DP = D + 1;  // padded row stride: conflict-free row walks
  constexpr int QW = q_words(D);  // int8 rows as words, padded the same way
  constexpr int kAcc = kMaxTileRows * D / kThreads;  // accumulator slots
  const int s = blockIdx.x % splits;
  const int row0 = (blockIdx.x / splits) * kMaxTileRows;  // the chunk's first tile row
  const int h = blockIdx.y;
  const int i = blockIdx.z;
  const int tid = threadIdx.x;
  const int tg = t * group;
  const int tr = min(tg - row0, kMaxTileRows);  // the chunk's tile rows

  extern __shared__ float smem[];
  float* q_s = smem;                    // [tr][DP] the q.k operand of q
  float* k_s = q_s + tr * DP;           // [bs][DP]
  float* v_s = k_s + kBlockRows * DP;   // [bs][D]
  float* p_s = v_s + kBlockRows * D;    // [tr][bs] softmax weights, bf16-rounded
  float* m_s = p_s + tr * kBlockRows;   // [tr] running max
  float* l_s = m_s + tr;                // [tr] running denominator
  float* a_s = l_s + tr;                // [tr] this block's rescale factor
  float* ks_s = a_s + tr;               // [bs] this block's k scales
  float* qscl_s = ks_s + kBlockRows;    // [tr] int8 query scales
  int* tb_s = reinterpret_cast<int*>(qscl_s + tr);  // [tr] each row's ancestor mask
  int* qw_s = tb_s + tr;                            // [tr][QW] int8 query
  int* kw_s = qw_s + tr * QW;                       // [bs][QW] int8 K payload

  const int pos = positions[i];
  // the split's logical blocks, cut at the chunk's deepest fresh row
  // (lb_stop: pos + the token of its last tile row, pos + t - 1 for a
  // one-chunk tile), and under row_live at the lane's deepest live one
  // (live_stop: the blocks up to the one holding row pos + row_live[i] - 1,
  // none when that row lies before row 0). The loop keeps lb_stop as its
  // bound and breaks at live_stop: bounding it by live_stop directly made
  // the D = 64 instances slower on an H100 with row_live null (PERF.md)
  const int lb_begin = s * bps;
  const int ti_last = (row0 + tr - 1) / group;
  const int lb_stop = min(min((s + 1) * bps, nblk), (pos + ti_last) / kBlockRows + 1);
  const int live_stop = row_live != nullptr
      ? min(lb_stop, (pos + row_live[i] + kBlockRows - 1) / kBlockRows) : lb_stop;
  const int* tbl = tables + static_cast<size_t>(i) * w;

  BlockTile<L, D> tile;
  if (lb_begin < live_stop) {
    tile.load(k_pool, v_pool, k_scale, v_scale, static_cast<size_t>(tbl[lb_begin]),
              nkv, h, tid);
  }

  // query tile row r of the chunk, row0 + r = ti * G + g of the tile, holds
  // q[i, ti, h * G + g, :]
  for (int e = tid; e < tr * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int ti = (row0 + r) / group, g = (row0 + r) % group;
    const size_t src =
        ((static_cast<size_t>(i) * t + ti) * n_heads + h * group + g) * D + d;
    float x = __bfloat162float(q[src]);
    if (fp8_mxu) {
      // the reference's unsaturated cast: out-of-range q is NaN (e4m3) or
      // inf (e5m2) and poisons its row, as there
      x = Payload<L>::widen(__nv_cvt_float_to_fp8(x, __NV_NOSAT, fp8_interp(e5m2)), e5m2);
    }
    q_s[r * DP + d] = x;
  }
  if (tree_bits != nullptr) {
    for (int r = tid; r < tr; r += kThreads) {
      tb_s[r] = tree_bits[static_cast<size_t>(i) * t + (row0 + r) / group];
    }
  }
  if (int8_mxu) {
    __syncthreads();  // q_s is ready
    for (int r = tid; r < tr; r += kThreads) {
      float amax = 0.f;
      for (int d = 0; d < D; ++d) amax = fmaxf(amax, fabsf(q_s[r * DP + d]));
      qscl_s[r] = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
    }
    __syncthreads();  // qscl_s is ready
    int8_t* qb = reinterpret_cast<int8_t*>(qw_s);
    for (int e = tid; e < tr * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const float x = rintf(__fdiv_rn(q_s[r * DP + d], qscl_s[r]));
      qb[r * QW * 4 + d] = static_cast<int8_t>(fminf(fmaxf(x, -127.f), 127.f));
    }
  }
  for (int r = tid; r < tr; r += kThreads) {
    m_s[r] = -CUDART_INF_F;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  const int n_sc = tr * kBlockRows;       // (row, column) scores per block
  const int n_pad = (n_sc + 31) & ~31;    // rounded up to whole warps

  for (int lb = lb_begin; lb < lb_stop; ++lb) {
    if (lb >= live_stop) break;
    tile.store(k_s, DP, v_s, ks_s, reinterpret_cast<int8_t*>(kw_s), mxu, e5m2, tid);
    __syncthreads();  // k_s / v_s (and, first time round, the q tile and tb_s) are ready
    if (lb + 1 < live_stop) {
      // in flight while this block is computed
      tile.load(k_pool, v_pool, k_scale, v_scale, static_cast<size_t>(tbl[lb + 1]),
                nkv, h, tid);
    }
    // scores and the online-softmax update, one thread per (row, column):
    // a row's 16 columns sit on 16 neighbouring lanes of one warp, so its
    // max and sum are warp shuffles. The loop runs over whole warps (n_pad)
    // so that every lane of a warp takes part in the shuffles.
    for (int e = tid; e < n_pad; e += kThreads) {
      const int r = e / kBlockRows, c = e % kBlockRows;
      const bool live = e < n_sc;
      float sc = -CUDART_INF_F;
      const int u = lb * kBlockRows + c - pos;  // the row's offset into the fresh block
      if (live && (tree_bits == nullptr
                   ? u <= (row0 + r) / group  // block-causal
                   : u < 0 || (u < t && ((static_cast<unsigned>(tb_s[r]) >> u) & 1u)))) {
        if (int8_mxu) {
          int dot = 0;
#pragma unroll 16
          for (int x = 0; x < D / 4; ++x) dot = __dp4a(qw_s[r * QW + x], kw_s[c * QW + x], dot);
          sc = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), qscl_s[r]), ks_s[c]),
                         sm_scale);
        } else {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += q_s[r * DP + d] * k_s[c * DP + d];
          if (fp8_mxu) {
            sc = __fmul_rn(__fmul_rn(dot, ks_s[c]), sm_scale);
          } else {
            sc = dot * sm_scale;
          }
        }
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
      if (e >= tr * D) break;  // e grows with k: the rest lie past the chunk
      const int r = e / D, d = e % D;
      float pv = 0.f;
#pragma unroll
      for (int c = 0; c < kBlockRows; ++c) pv += p_s[r * kBlockRows + c] * v_s[c * D + d];
      acc[k] = acc[k] * a_s[r] + pv;
    }
    __syncthreads();  // k_s / v_s / p_s are rewritten by the next block
  }

  // the split's raw (acc, m, l) for the chunk's rows; a split with no live
  // block leaves (0, -inf, 0), which the combine weighs 0
  const size_t part = ((static_cast<size_t>(i) * nkv + h) * splits + s) * tg + row0;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kThreads;
    if (e >= tr * D) break;
    o_parts[(part + e / D) * D + e % D] = acc[k];
  }
  __syncthreads();  // m_s / l_s were last written before the loop's final barrier
  for (int r = tid; r < tr; r += kThreads) {
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

template <int D, int L>
cudaError_t launch(const Args& a, bool mxu, bool e5m2) {
  using T = typename Payload<L>::T;
  const int group = a.n_heads / a.nkv;
  const int tg = a.t * group;
  const int chunks = (tg + kMaxTileRows - 1) / kMaxTileRows;
  const size_t smem =
      sizeof(float) * smem_words(min(tg, kMaxTileRows), D, mxu && L == kLayoutInt8);
  auto split_kernel = paged_decode_split_kernel<D, L>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  split_kernel<<<dim3(a.splits * chunks, a.nkv, a.b), kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const __half*>(a.k_scale),
      static_cast<const __half*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<const int*>(a.row_live),
      static_cast<const int*>(a.tree_bits), static_cast<float*>(a.o_parts),
      static_cast<float*>(a.m_parts), static_cast<float*>(a.l_parts), a.t,
      a.n_heads, a.nkv, group, a.w, a.nblk, a.splits, a.bps, a.sm_scale, mxu, e5m2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<D><<<dim3(a.nkv, a.b), kCombineThreads, 0, a.stream>>>(
      static_cast<const float*>(a.o_parts), static_cast<const float*>(a.m_parts),
      static_cast<const float*>(a.l_parts), static_cast<__nv_bfloat16*>(a.out), a.t,
      a.n_heads, a.nkv, group, a.splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_kind(const Args& a, int kind, bool mxu) {
  switch (kind) {
    case kBf16:
      return mxu ? cudaErrorInvalidValue : launch<D, kLayoutBf16>(a, false, false);
    case kInt8:
      return launch<D, kLayoutInt8>(a, mxu, false);
    case kE4m3:
      return launch<D, kLayoutFp8>(a, mxu, false);
    case kE5m2:
      return launch<D, kLayoutFp8>(a, mxu, true);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors allocated by the caller (pool and scale pointers
// 16-byte aligned; the scales null for a bf16 pool; row_live null unless the
// caller passes per-lane live row counts, tree_bits null unless it passes
// per-node ancestor masks, which need t <= 32); kv_kind numbers the
// payload (0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2) and quant_mxu selects
// mode 6 for a quantized one; the stream is the caller's current CUDA
// stream. Returns a cudaError_t: 0 when both launches were accepted.
extern "C" int paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* positions,
    const void* row_live, const void* tree_bits, void* o_parts,
    void* m_parts, void* l_parts, void* out, int b, int t, int n_heads, int nkv,
    int head_dim, int block_size, int w, int nblk, int splits, int bps, int kv_kind,
    int quant_mxu, float sm_scale, void* stream) {
  const bool quantized = kv_kind != kBf16;
  if (block_size != kBlockRows || nkv <= 0 || n_heads % nkv != 0 || t < 1 ||
      (tree_bits != nullptr && t > kMaxTreeNodes) || splits < 1 || bps < 1 ||
      nblk > w || b < 1 || (quantized && (k_scale == nullptr || v_scale == nullptr))) {
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
