// Paged flash-decoding of a query tile (t > 1 fresh tokens per lane) over a
// bf16 block-pooled KV cache, on Hopper's tensor cores (sm_90a). The t = 1
// decode goes to paged_decode_t1.cu; the quantized pools at t > 1 and tiles
// wider than kMaxRows stay with paged_decode.cu; kernels/paged_attention.py
// (kernel_route) picks the source.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py
//   _decode_kernel (:73), launched by paged_flash_decode (:245, pallas_call
//   at :419), plus the LSE combine that function runs after the kernel
//   (:438-449), for a bf16 pool and t > 1: the block-causal tile (mode 2),
//   row_live (mode 4, :90-97 and :131-133) and tree_bits (mode 5, :195-209).
//
// What bounds it on the H100: bytes of K/V read from device memory. Each
// pool row of a kv head is 2 * D bf16 values of K and V and serves the
// t * G tile rows of that head: 4 * D * t * G FLOPs for 4 * D bytes, at most
// 128 FLOPs a byte here, below the ~295 at which the tensor cores would
// bound it. At the served shapes (8 lanes, 64-128 tile rows, 512-1024 rows
// of context) the bytes take about 2 us; what a launch takes beyond that is
// latency: the walk of a split is a chain of dependent block steps.
//
// What the design does about it:
// - one thread block per (lane, kv head, split) owns all t * G <= kMaxRows
//   tile rows, one warp per 16 rows (ceil(t * G / 16) warps), so each K/V
//   pool block is read from device memory once per split and serves every
//   tile row of that head (the G query heads of the GQA group and the t
//   fresh tokens);
// - both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulation): per 16-row pool block a warp computes its 16 x 16
//   scores (2 x D / 16 products) and adds 16 x D of P.V (D / 8 products).
//   Each warp keeps its Q fragments (D / 16 x 4 words), its D / 8 fp32
//   C tiles of output and the (m, l) of its thread's two rows in registers
//   for the whole walk; the softmax weights go from the score accumulators
//   into the A fragments of P.V without leaving registers;
// - K and V blocks are staged into a ring of kStages shared-memory stages
//   by cp.async (16 bytes a thread, the block id read from the lane's
//   table), rows padded by kPad so that the fragment loads are free of
//   bank conflicts. Blocks lb + 1 .. lb + kStages - 1 are in flight while
//   block lb is computed, and one __syncthreads() a block both publishes a
//   stage and frees the one the next copy refills;
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
// accumulation) while the denominator sums the unrounded p. The products
// sum in another order than paged_decode.cu's scalar loops: the two agree
// within the kernel tolerance, not bitwise.

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

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_tile_kernel(
    const bf16* __restrict__ q,          // (b, t, N, D)
    const bf16* __restrict__ k_pool,     // (num_blocks, bs, NKV, D)
    const bf16* __restrict__ v_pool,     // (num_blocks, bs, NKV, D)
    const int* __restrict__ tables,      // (b, W)
    const int* __restrict__ positions,   // (b,)
    const int* __restrict__ row_live,    // (b,) or null
    const int* __restrict__ tree_bits,   // (b, t) or null
    float* __restrict__ o_parts,         // (b, NKV, S, t*G, D)
    float* __restrict__ m_parts,         // (b, NKV, S, t*G)
    float* __restrict__ l_parts,         // (b, NKV, S, t*G)
    int t, int n_heads, int nkv, int group, int w, int nblk, int splits, int bps,
    float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int kDt = D / 8;   // 8-wide C tiles across D
  constexpr int kDc = D / 16;  // 16-deep k chunks across D
  __shared__ __align__(16) bf16 kv_s[kStages][2][kBlockRows * LD];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int i = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int tg = t * group;
  const int t4 = lane & 3;
  const int pos = positions[i];

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
      stage_block<D>(kv_s[j][0], kv_s[j][1], k_pool, v_pool,
                     static_cast<size_t>(tbl[lb_begin + j]), nkv, h, tid, nthreads);
    }
    cp_async_commit();  // one group per stage, empty or not: wait_group counts them
  }

  // this thread's two tile rows, r = ti * G + g holding q[i, ti, h * G + g, :];
  // rows at or past t * G are zero, fully masked and never written
  int rows[2], tis[2];
  unsigned bits[2] = {0u, 0u};
  uint32_t qf[kDc][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + (lane >> 2) + 8 * half;
    rows[half] = r;
    tis[half] = r / group;
    const bool live = r < tg;
    const bf16* qr = q + ((static_cast<size_t>(i) * t + tis[half]) * n_heads + h * group +
                          r % group) * D + 2 * t4;
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc) {
      qf[dc][half] = live ? *reinterpret_cast<const uint32_t*>(qr + dc * 16) : 0u;
      qf[dc][2 + half] = live ? *reinterpret_cast<const uint32_t*>(qr + dc * 16 + 8) : 0u;
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
      stage_block<D>(kv_s[jn % kStages][0], kv_s[jn % kStages][1], k_pool, v_pool,
                     static_cast<size_t>(tbl[lb_begin + jn]), nkv, h, tid, nthreads);
    }
    cp_async_commit();
    const bf16* k_s = kv_s[j % kStages][0];
    const bf16* v_s = kv_s[j % kStages][1];

    // S = Q K^T: this warp's 16 rows x the block's 16 rows
    float sc[2][4] = {};
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b[2];
        load_b_t(b, k_s + nt * 8 * LD + dc * 16, LD, lane);
        mma_bf16(sc[nt], qf[dc], b);
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
        sc[nt][c] = ok ? sc[nt][c] * sm_scale : -CUDART_INF_F;
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

template <int D>
cudaError_t launch(const Args& a) {
  const int group = a.n_heads / a.nkv;
  const int warps = (a.t * group + 15) / 16;
  paged_decode_tile_kernel<D><<<dim3(a.splits, a.nkv, a.b), warps * 32, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_pool),
      static_cast<const bf16*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<const int*>(a.row_live),
      static_cast<const int*>(a.tree_bits), static_cast<float*>(a.o_parts),
      static_cast<float*>(a.m_parts), static_cast<float*>(a.l_parts), a.t, a.n_heads,
      a.nkv, group, a.w, a.nblk, a.splits, a.bps, a.sm_scale);
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

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors allocated by the caller (the pools bf16 and 16-byte
// aligned; row_live null unless the caller passes per-lane live row counts,
// tree_bits null unless it passes per-node ancestor masks); the stream is
// the caller's current CUDA stream. Takes 2 <= t, t * G <= 128, head_dim 64
// or 128, block_size 16, and t <= 32 under tree_bits. Returns a
// cudaError_t: 0 when both launches were accepted.
extern "C" int paged_decode_tile(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, const void* row_live, const void* tree_bits, void* o_parts,
    void* m_parts, void* l_parts, void* out, int b, int t, int n_heads, int nkv,
    int head_dim, int block_size, int w, int nblk, int splits, int bps, float sm_scale,
    void* stream) {
  if (block_size != kBlockRows || nkv <= 0 || n_heads % nkv != 0 || t < 2 ||
      t * (n_heads / nkv) > kMaxRows || (tree_bits != nullptr && t > kMaxTreeNodes) ||
      splits < 1 || bps < 1 || nblk > w || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pool, v_pool, tables, positions, row_live, tree_bits, o_parts,
               m_parts, l_parts, out, b, t, n_heads, nkv, w, nblk, splits, bps,
               sm_scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(a));
    case 128:
      return static_cast<int>(launch<128>(a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
