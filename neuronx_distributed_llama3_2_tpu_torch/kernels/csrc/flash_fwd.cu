// Flash-attention forward for Hopper (sm_90a): o = softmax(s * Q K^T) V and
// its log-sum-exp, causal or full, grouped-query (q head h reads kv head
// h / G), bf16 in, bf16 o and fp32 lse out.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/pallas_flash_attention.py
//   _fwd_kernel (:44), launched by _flash_fwd (:145, pallas_call at :194).
//   Modes ported: causal and full masks with the padding mask to kv_len.
//   The segment_ids mode is later work (the wrapper raises on it).
//
// What bounds it on the H100: operations. A (q, kv) pair costs 4 * D FLOPs
// (Q K^T and P V, 2 * D each); at the training shape (B 12, N 32,
// S 2048, D 64, causal: S (S + 1) / 2 pairs per head) that is
// 2.06e11 FLOPs, 0.21 ms at 989 TFLOP/s. The bytes (q, k, v, o, lse:
// about 0.2 GB) take 0.06 ms at 3.35 TB/s.
//
// What the design does about it:
// - both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulation); the softmax weights go from the Q K^T accumulators
//   straight into the A fragments of P V, in registers, never through
//   shared or device memory;
// - one thread block per (batch, q head, 64-row q tile), four warps of 16
//   q rows; the TPU kernel's sequential kv grid axis becomes a loop over
//   64-row kv tiles inside the block, carrying (m, l, acc) in registers;
// - causal: the loop stops at the diagonal tile, and the q tiles are
//   launched heaviest (longest loop) first, so the short tiles fill the
//   tail of the grid;
// - K and V tiles are read from device memory once per q tile and shared
//   by its four warps through padded (conflict-free) shared memory;
// - GQA: the kv head is h / G; no K/V copy per q head.
// Simple first: loads are synchronous (no cp.async / TMA pipeline) and the
// product is mma.sync, not wgmma. Tiles: 64 q rows x 64 kv rows.
//
// Numerics (the plain version is flash_fwd_reference in
// kernels/flash_attention.py): scores are fp32 products of the bf16
// operands, times sm_scale in fp32; masked scores are -inf; online softmax
// with the m == -inf guards of the TPU kernel (:96-99, :115-118): a row
// with no key so far has alpha = 0 and p = 0, and a row with no key at all
// gets o = 0 and lse = -inf; p is rounded to bf16 before P V (:105) while
// the denominator l sums the unrounded p.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q,   // (B, N, Sq, D)
                 const bf16* __restrict__ k,   // (B, Nkv, Skv, D)
                 const bf16* __restrict__ v,   // (B, Nkv, Skv, D)
                 bf16* __restrict__ o,         // (B, N, Sq, D)
                 float* __restrict__ lse,      // (B, N, Sq)
                 int n_heads, int nkv, int sq, int skv, int causal,
                 float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int kDt = D / 8;   // 8-wide C tiles across D
  constexpr int kDc = D / 16;  // 16-deep k chunks across D
  const int bh = blockIdx.x;   // batch * N + q head
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = bh % n_heads, bi = bh / n_heads;
  const int kvh = h / (n_heads / nkv);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // rows row_lo, row_lo + 8

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* k_s = q_s + kTile * LD;                   // [kTile][LD]
  bf16* v_s = k_s + kTile * LD;                   // [kTile][LD]

  const size_t kv_off = (static_cast<size_t>(bi) * nkv + kvh) * skv * D;
  load_tile<D>(q_s, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
  const bf16* q_w = q_s + warp * 16 * LD;

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc[kDt][4] = {};
  const int n_kt = (skv + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous k_s / v_s
    load_tile<D>(k_s, k + kv_off, kv0, skv, tid);
    load_tile<D>(v_s, v + kv_off, kv0, skv, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[kNt][4] = {};
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc) {
      uint32_t a[4];
      load_a(a, q_w + dc * 16, LD, lane);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        uint32_t b[2];
        load_b_t(b, k_s + nt * 8 * LD + dc * 16, LD, lane);
        mma_bf16(s[nt], a, b);
      }
    }

    // scale, mask, and the tile's row maxima
    float mb[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row_lo + (c >> 1) * 8;
        const int col = kv0 + nt * 8 + 2 * t + (c & 1);
        const bool ok = col < skv && (!causal || col <= row);
        s[nt][c] = ok ? s[nt][c] * sm_scale : -CUDART_INF_F;
        mb[c >> 1] = fmaxf(mb[c >> 1], s[nt][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      const float m_new = fmaxf(m[r], mb[r]);
      alpha[r] = (m[r] == -CUDART_INF_F) ? 0.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    // p = exp(s - m); a masked score stays 0 even while m is -inf
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (s[nt][c] == -CUDART_INF_F) ? 0.f : expf(s[nt][c] - m[c >> 1]);
        s[nt][c] = p;
        rs[c >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] *= alpha[c >> 1];
    }

    // acc += bf16(P) V
    uint32_t pa[kKc][4];
    c_to_a(pa, s);
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) {
        uint32_t b[2];
        load_b(b, v_s + kc * 16 * LD + dt * 8, LD, lane);
        mma_bf16(acc[dt], pa[kc], b);
      }
    }
  }

  // o = acc / l (l == 0: no key, o = 0); lse = m + log(l), -inf without a key
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) safe[r] = (l[r] == 0.f) ? 1.f : l[r];
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] /= safe[c >> 1];
  }
  store_rows<D>(o + static_cast<size_t>(bh) * sq * D, acc, q0 + warp * 16, sq,
                1.f, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < sq) {
        lse[static_cast<size_t>(bh) * sq + row] =
            (m[r] == -CUDART_INF_F) ? -CUDART_INF_F : m[r] + logf(safe[r]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int n_heads, int nkv, int sq, int skv,
                   int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = 3ull * kTile * (D + kPad) * sizeof(bf16);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kTile - 1) / kTile;
  flash_fwd_kernel<D><<<dim3(b * n_heads, n_qt), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), n_heads, nkv, sq, skv, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous, 16-byte aligned tensors allocated by the caller; the stream
// is the caller's current CUDA stream. Returns a cudaError_t: 0 when the
// launch was accepted.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int n_heads, int nkv,
                              int sq, int skv, int head_dim, int causal,
                              float sm_scale, void* stream) {
  if (b < 1 || nkv < 1 || n_heads % nkv != 0 || sq < 1 || skv < 1 ||
      (sq + flash::kTile - 1) / flash::kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, lse, b, n_heads, nkv, sq,
                                         skv, causal, sm_scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, lse, b, n_heads, nkv, sq,
                                          skv, causal, sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
