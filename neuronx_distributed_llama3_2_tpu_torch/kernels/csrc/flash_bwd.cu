// Flash-attention backward for Hopper (sm_90a): two kernels, dq (K2) and
// dk/dv (K3), both rebuilding P = exp(s * Q K^T - lse) from the forward's
// log-sum-exp; causal or full, grouped-query, bf16 in and out.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/pallas_flash_attention.py
//   _bwd_dq_kernel (:230, pallas_call at :394) and _bwd_dkv_kernel (:285,
//   pallas_call at :433), both launched by _flash_bwd (:347), together with
//   the GQA group sum that _flash_bwd runs after the dk/dv kernel
//   (:466-468). delta = rowsum(o * do) stays a torch op outside (:353).
//   Modes ported: causal and full masks with the padding masks to q_len and
//   kv_len. The segment_ids mode is later work (the wrapper raises on it).
//
// What bounds them on the H100: operations. Per (q, kv) pair, K2 runs
// Q K^T, dO V^T and dS K (6 * D FLOPs), K3 runs K Q^T, V dO^T, P^T dO and
// dS^T Q (8 * D FLOPs). At the training shape (B 12, N 32, S 2048, D 64,
// causal) that is 3.1e11 and 4.1e11 FLOPs: 0.31 ms and 0.42 ms at
// 989 TFLOP/s. Their bytes (about 0.3 GB each) take under 0.1 ms at
// 3.35 TB/s.
//
// What the design does about it:
// - every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulation); P and dS go from accumulators straight into the A
//   fragments of the next product, in registers;
// - K2: one thread block per (batch, q head, 64-row q tile), heaviest
//   causal tiles first; the kv loop (the TPU kernel's sequential grid axis)
//   stops at the diagonal and dq accumulates in fp32 registers;
// - K3: one thread block per (batch, KV head, 64-row kv tile), warps of 16
//   kv rows. It loops over the G q heads of its group and over the q tiles
//   from the diagonal on, so the GQA sum happens in its fp32 registers: no
//   atomics, and none of the TPU path's (B, N, S, D) fp32 per-q-head dk/dv.
//   The products are taken transposed (S^T = K Q^T, dP^T = V dO^T), so
//   P^T and dS^T are already A fragments of dv += P^T dO and dk += dS^T Q;
// - tiles sit in padded (conflict-free) shared memory, loaded once per
//   tile and shared by the four warps.
// Simple first: synchronous loads, mma.sync rather than wgmma, 64 x 64
// tiles.
//
// Numerics (the plain version is flash_bwd_reference in
// kernels/flash_attention.py): scores in fp32 from the bf16 operands,
// sm_scale on the fp32 product; P is 0 off the mask; dS = P (dP - delta)
// is rounded to bf16 before the dq and dk products (:274, :335), P before
// the dv product (:326); dq, dk, dv accumulate in fp32, are scaled (dq, dk
// by sm_scale) and cast to bf16 once.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q,      // (B, N, Sq, D)
                    const bf16* __restrict__ k,      // (B, Nkv, Skv, D)
                    const bf16* __restrict__ v,      // (B, Nkv, Skv, D)
                    const bf16* __restrict__ dout,   // (B, N, Sq, D)
                    const float* __restrict__ lse,   // (B, N, Sq)
                    const float* __restrict__ delta, // (B, N, Sq)
                    bf16* __restrict__ dq,           // (B, N, Sq, D)
                    int n_heads, int nkv, int sq, int skv, int causal,
                    float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int kDt = D / 8;
  constexpr int kDc = D / 16;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = bh % n_heads, bi = bh / n_heads;
  const int kvh = h / (n_heads / nkv);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // rows row_lo, row_lo + 8

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile * LD;
  bf16* k_s = do_s + kTile * LD;
  bf16* v_s = k_s + kTile * LD;

  const size_t q_off = static_cast<size_t>(bh) * sq * D;
  const size_t kv_off = (static_cast<size_t>(bi) * nkv + kvh) * skv * D;
  load_tile<D>(q_s, q + q_off, q0, sq, tid);
  load_tile<D>(do_s, dout + q_off, q0, sq, tid);
  const bf16* q_w = q_s + warp * 16 * LD;
  const bf16* do_w = do_s + warp * 16 * LD;

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const bool in = row < sq;
    lse_r[r] = in ? lse[static_cast<size_t>(bh) * sq + row] : 0.f;
    delta_r[r] = in ? delta[static_cast<size_t>(bh) * sq + row] : 0.f;
  }

  float acc[kDt][4] = {};
  const int n_kt = (skv + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();
    load_tile<D>(k_s, k + kv_off, kv0, skv, tid);
    load_tile<D>(v_s, v + kv_off, kv0, skv, tid);
    __syncthreads();

    float s[kNt][4] = {};   // Q K^T
    float dp[kNt][4] = {};  // dO V^T
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc) {
      uint32_t a[4], ado[4];
      load_a(a, q_w + dc * 16, LD, lane);
      load_a(ado, do_w + dc * 16, LD, lane);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        uint32_t b[2];
        load_b_t(b, k_s + nt * 8 * LD + dc * 16, LD, lane);
        mma_bf16(s[nt], a, b);
        load_b_t(b, v_s + nt * 8 * LD + dc * 16, LD, lane);
        mma_bf16(dp[nt], ado, b);
      }
    }
    // dS = P (dP - delta), P = exp(s * QK - lse) on the mask, 0 off it
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row_lo + (c >> 1) * 8;
        const int col = kv0 + nt * 8 + 2 * t + (c & 1);
        const bool ok = row < sq && col < skv && (!causal || col <= row);
        const float p = ok ? expf(s[nt][c] * sm_scale - lse_r[c >> 1]) : 0.f;
        s[nt][c] = p * (dp[nt][c] - delta_r[c >> 1]);
      }
    }
    // dq += bf16(dS) K
    uint32_t dsa[kKc][4];
    c_to_a(dsa, s);
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) {
        uint32_t b[2];
        load_b(b, k_s + kc * 16 * LD + dt * 8, LD, lane);
        mma_bf16(acc[dt], dsa[kc], b);
      }
    }
  }
  store_rows<D>(dq + q_off, acc, q0 + warp * 16, sq, sm_scale, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q,      // (B, N, Sq, D)
                     const bf16* __restrict__ k,      // (B, Nkv, Skv, D)
                     const bf16* __restrict__ v,      // (B, Nkv, Skv, D)
                     const bf16* __restrict__ dout,   // (B, N, Sq, D)
                     const float* __restrict__ lse,   // (B, N, Sq)
                     const float* __restrict__ delta, // (B, N, Sq)
                     bf16* __restrict__ dk,           // (B, Nkv, Skv, D)
                     bf16* __restrict__ dv,           // (B, Nkv, Skv, D)
                     int n_heads, int nkv, int sq, int skv, int causal,
                     float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int kDt = D / 8;
  constexpr int kDc = D / 16;
  const int bkv = blockIdx.x;  // batch * Nkv + kv head
  // causal: kv tile 0 meets every q tile, so the natural order launches the
  // heaviest tiles first
  const int kt = blockIdx.y;
  const int kvh = bkv % nkv, bi = bkv / nkv;
  const int group = n_heads / nkv;
  const int kv0 = kt * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row_lo = kv0 + warp * 16 + (lane >> 2);  // kv rows row_lo, +8

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * LD;
  bf16* q_s = v_s + kTile * LD;
  bf16* do_s = q_s + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * LD);  // [kTile]
  float* delta_s = lse_s + kTile;                               // [kTile]

  const size_t kv_off = static_cast<size_t>(bkv) * skv * D;
  load_tile<D>(k_s, k + kv_off, kv0, skv, tid);
  load_tile<D>(v_s, v + kv_off, kv0, skv, tid);
  const bf16* k_w = k_s + warp * 16 * LD;
  const bf16* v_w = v_s + warp * 16 * LD;

  float dk_acc[kDt][4] = {};
  float dv_acc[kDt][4] = {};
  const int n_qt = (sq + kTile - 1) / kTile;
  // q tile qt reaches kv tile kt under the causal mask iff qt >= kt
  const int qt_begin = causal ? kt : 0;
  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = static_cast<size_t>(bi) * n_heads + kvh * group + gi;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D>(q_s, q + bh * sq * D, q0, sq, tid);
      load_tile<D>(do_s, dout + bh * sq * D, q0, sq, tid);
      for (int i = tid; i < kTile; i += kThreads) {
        const bool in = q0 + i < sq;
        lse_s[i] = in ? lse[bh * sq + q0 + i] : 0.f;
        delta_s[i] = in ? delta[bh * sq + q0 + i] : 0.f;
      }
      __syncthreads();

      float s[kNt][4] = {};   // S^T = K Q^T: 16 kv rows x 64 q columns
      float dp[kNt][4] = {};  // dP^T = V dO^T
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
        uint32_t ak[4], av[4];
        load_a(ak, k_w + dc * 16, LD, lane);
        load_a(av, v_w + dc * 16, LD, lane);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          uint32_t b[2];
          load_b_t(b, q_s + nt * 8 * LD + dc * 16, LD, lane);
          mma_bf16(s[nt], ak, b);
          load_b_t(b, do_s + nt * 8 * LD + dc * 16, LD, lane);
          mma_bf16(dp[nt], av, b);
        }
      }
      // P^T and dS^T = P^T (dP^T - delta), masked by q < Sq, kv < Skv and
      // kv <= q when causal
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = row_lo + (c >> 1) * 8;
          const int il = nt * 8 + 2 * t + (c & 1);
          const int i = q0 + il;
          const bool ok = i < sq && j < skv && (!causal || j <= i);
          const float p = ok ? expf(s[nt][c] * sm_scale - lse_s[il]) : 0.f;
          s[nt][c] = p;
          dp[nt][c] = p * (dp[nt][c] - delta_s[il]);
        }
      }
      uint32_t fa[kKc][4];
      c_to_a(fa, s);  // bf16(P^T): dv += P^T dO
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
        for (int dt = 0; dt < kDt; ++dt) {
          uint32_t b[2];
          load_b(b, do_s + kc * 16 * LD + dt * 8, LD, lane);
          mma_bf16(dv_acc[dt], fa[kc], b);
        }
      }
      c_to_a(fa, dp);  // bf16(dS^T): dk += dS^T Q
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
        for (int dt = 0; dt < kDt; ++dt) {
          uint32_t b[2];
          load_b(b, q_s + kc * 16 * LD + dt * 8, LD, lane);
          mma_bf16(dk_acc[dt], fa[kc], b);
        }
      }
    }
  }
  store_rows<D>(dk + kv_off, dk_acc, kv0 + warp * 16, skv, sm_scale, lane);
  store_rows<D>(dv + kv_off, dv_acc, kv0 + warp * 16, skv, 1.f, lane);
}

template <int D>
size_t tiles_smem(int tiles, int floats) {
  return static_cast<size_t>(tiles) * kTile * (D + kPad) * sizeof(bf16) +
         static_cast<size_t>(floats) * sizeof(float);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, int n_heads, int nkv, int sq, int skv,
                      int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = tiles_smem<D>(4, 0);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kTile - 1) / kTile;
  flash_bwd_dq_kernel<D><<<dim3(b * n_heads, n_qt), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), n_heads, nkv, sq, skv, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int n_heads, int nkv, int sq,
                       int skv, int causal, float sm_scale,
                       cudaStream_t stream) {
  const size_t smem = tiles_smem<D>(4, 2 * kTile);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (skv + kTile - 1) / kTile;
  flash_bwd_dkv_kernel<D><<<dim3(b * nkv, n_kt), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_heads, nkv, sq, skv,
      causal, sm_scale);
  return cudaGetLastError();
}

bool valid(int b, int n_heads, int nkv, int sq, int skv) {
  return b >= 1 && nkv >= 1 && n_heads % nkv == 0 && sq >= 1 && skv >= 1 &&
         (sq + flash::kTile - 1) / flash::kTile <= 65535 &&
         (skv + flash::kTile - 1) / flash::kTile <= 65535;
}

}  // namespace

// C entry points, bound with ctypes. Pointers are device pointers of
// contiguous, 16-byte aligned tensors allocated by the caller; the stream
// is the caller's current CUDA stream. Each returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b,
                                 int n_heads, int nkv, int sq, int skv,
                                 int head_dim, int causal, float sm_scale,
                                 void* stream) {
  if (!valid(b, n_heads, nkv, sq, skv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dq<64>(q, k, v, dout, lse, delta, dq, b,
                                            n_heads, nkv, sq, skv, causal,
                                            sm_scale, st));
    case 128:
      return static_cast<int>(launch_dq<128>(q, k, v, dout, lse, delta, dq, b,
                                             n_heads, nkv, sq, skv, causal,
                                             sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int n_heads, int nkv, int sq, int skv,
                                  int head_dim, int causal, float sm_scale,
                                  void* stream) {
  if (!valid(b, n_heads, nkv, sq, skv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv,
                                             b, n_heads, nkv, sq, skv, causal,
                                             sm_scale, st));
    case 128:
      return static_cast<int>(launch_dkv<128>(q, k, v, dout, lse, delta, dk,
                                              dv, b, n_heads, nkv, sq, skv,
                                              causal, sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
