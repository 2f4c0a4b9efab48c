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
//   kv_len, and the segment_ids mode (packed documents, :263 and :320): a
//   (q, kv) pair attends only where seg[b, q] == seg[b, kv].
//
// What bounds them on the H100: operations. Per (q, kv) pair, K2 runs
// Q K^T, dO V^T and dS K (6 * D FLOPs), K3 runs K Q^T, V dO^T, P^T dO and
// dS^T Q (8 * D FLOPs). At the training shape (B 12, N 32, S 2048, D 64,
// causal) that is 3.1e11 and 4.1e11 FLOPs: 0.31 ms and 0.42 ms at
// 989 TFLOP/s. Their bytes (about 0.3 GB each) take under 0.1 ms at
// 3.35 TB/s.
//
// What the design does about it (K1's, flash_fwd.cu; the PTX pieces are in
// sm90.cuh):
// - every product runs on wgmma, the warpgroup product that reaches the
//   tensor cores' full rate. The two score products of a tile (S and dP,
//   or their transposes in K3) read both operands from shared memory, both
//   K-major; the gradient products read P or dS from registers (the score
//   accumulator rounded to bf16 is already an A operand) and the other
//   operand MN-major from shared memory, so P and dS never leave the
//   registers;
// - a block has two consumer warpgroups of 64 rows each. What the block
//   owns (K2: Q and dO of 128 q rows; K3: K and V of 128 kv rows) is loaded
//   once, by TMA, and stays in shared memory for the whole walk; what it
//   walks over streams through a ring of stages filled by TMA (one thread
//   issues a stage; the hardware writes the 128-byte swizzle the wgmma
//   descriptors read, zero-fills rows past the end, and signals one
//   mbarrier a stage). The issuing thread refills a stage one tile after
//   its own release of it, so the copies of the next tiles run beside this
//   tile's products;
// - K2 (dq): one block per (batch, q head, 128 q rows); it walks the kv
//   tiles of 64 rows (the TPU kernel's sequential kv grid axis) up to the
//   diagonal, heaviest causal q tiles first; dq accumulates in fp32
//   registers, its lse and delta (lse in log2 units) stay in registers;
// - K3 (dk, dv): one block per (batch, kv head, 128 kv rows); it walks the
//   G q heads of its group and, under the causal mask, the q tiles from
//   the first that reaches its rows (j <= i), so the GQA sum happens in its
//   fp32 registers: no atomics, and none of the TPU path's (B, N, S, D)
//   fp32 per-q-head dk/dv. Each stage holds a q tile's Q, dO, lse and delta
//   (the last two through a 1-D map over all of B N Sq: a box may start at
//   any q row, and what it reads past the head's Sq is masked). The
//   products are taken transposed (S^T = K Q^T, dP^T = V dO^T), so P^T and
//   dS^T are the A operands of dv += P^T dO and dk += dS^T Q. kv block 0
//   meets every q tile under the causal mask: the natural block order
//   launches the heaviest first;
// - masks only where needed: the causal compare on tiles that cross the
//   warpgroup's diagonal, the ragged compare (kv >= Skv in K2, q >= Sq in
//   K3; the other side's rows past the end are dropped at the store) on the
//   last tile; a tile wholly outside the causal mask is skipped. With
//   segment ids the id compare runs on every tile (any tile may hold a
//   document boundary; ids are compared, never assumed contiguous): each
//   thread reads the ids of its two rows once and those of its columns of
//   each tile from global memory (L1 / L2) beside the TMA stage, the reads
//   past S guarded. Every real q row sees at least its own key, so its lse
//   is finite and a masked score gives P = 2^-inf = 0. The mode is a
//   compile-time instance of each kernel (SEG), so the causal and full
//   masks run the same code as without it;
// - P = 2^(s * scale * log2 e - lse * log2 e), one FMA and ex2.approx.ftz.
// Tiles, chosen by what the card measured: K2 walks 64-row kv tiles through
// three stages, two blocks an SM at D = 64 (122 registers); K3 streams q
// tiles of 64 rows through three stages, one block an SM (dk and dv, 64 x D
// fp32 each a warpgroup, live across the walk: 168 registers at D = 64, 230
// at D = 128). Neither instance of either kernel spills. D = 96
// (gpt-neox-20b) takes D = 128's layout, two 64-column boxes a row, the
// second one's columns 96-127 zero-filled by the copy (flash_fwd.cu): the
// score products run 6 k-steps, the gradient products are wgmma of n = 96
// (dq 12 C tiles, dk and dv 12 each), one block an SM (K2 146-156, K3
// 202-206 registers over the instances with and without segment ids, no
// spill). In K2 the
// exponentials of a tile run while its dP product does; the same overlap in
// K3 measured no faster.
//
// Numerics (the plain version is flash_bwd_reference in
// kernels/flash_attention.py): scores in fp32 from the bf16 operands,
// sm_scale on the fp32 product; P is 0 off the mask (the masked score is
// -inf, 2^-inf = 0), and below 2^-126 flushed to 0; dS = P (dP - delta)
// is rounded to bf16 before the dq and dk products (:274, :335), P before
// the dv product (:326); dq, dk, dv accumulate in fp32, are scaled (dq, dk
// by sm_scale) and cast to bf16 once.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int kWgRows = 64;              // rows of a consumer warpgroup
constexpr int kBlockRows = 2 * kWgRows;  // q rows of a K2 block, kv rows of K3's
constexpr int kBwdThreads = 2 * 128;     // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// K2's tile geometry and shared-memory layout for head dim D: from a
// 1024-byte aligned base, Q and dO (ceil(D / 64) boxes of 128 rows each),
// then STAGES x (K tile, V tile) (ceil(D / 64) boxes of KV rows each), then
// the mbarriers.
template <int D>
struct Dq {
  static constexpr int kKv = 64;  // kv rows of a tile
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // blocks an SM
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kQBox = kBlockRows * kRowBytes;  // bytes of a Q or dO box
  static constexpr int kKvBox = kKv * kRowBytes;        // bytes of a K or V box
  static constexpr int kQBytes = kBoxes * kQBox;        // Q (or dO)
  static constexpr int kTileBytes = kBoxes * kKvBox;    // one K (or V) tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  // + 1024 bytes of room to align the base; barriers: Q and dO, full[], empty[]
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// K3's: K and V (ceil(D / 64) boxes of 128 rows each), then STAGES x (Q
// tile, dO tile (ceil(D / 64) boxes of QT rows each), lse, delta (QT fp32
// each)), each stage rounded up to 1024 bytes, then the mbarriers.
template <int D>
struct Dkv {
  static constexpr int kQt = 64;  // q rows of a streamed tile
  static constexpr int kStages = 3;
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kKvBox = kBlockRows * kRowBytes;  // bytes of a K or V box
  static constexpr int kKvBytes = kBoxes * kKvBox;       // K (or V)
  static constexpr int kQBox = kQt * kRowBytes;          // bytes of a Q or dO box
  static constexpr int kTileBytes = kBoxes * kQBox;      // one Q (or dO) tile
  static constexpr int kVecBytes = kQt * 4;              // its lse (or delta)
  static constexpr int kLoadBytes = 2 * kTileBytes + 2 * kVecBytes;
  static constexpr int kStageBytes = round_up(kLoadBytes, 1024);
  static constexpr int kBarOffset = 2 * kKvBytes + kStages * kStageBytes;
  // + 1024 bytes of room to align the base; barriers: K and V, full[], empty[]
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// SEG: the segment_ids mode, a compile-time instance of its own in both
// kernels, so that the causal and full masks run the same code with or
// without it
template <int D, bool SEG>
__global__ void __launch_bounds__(kBwdThreads, Dq<D>::kMinBlocks)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,   // (B N, Sq, D)
                    const __grid_constant__ CUtensorMap k_map,   // (B Nkv, Skv, D)
                    const __grid_constant__ CUtensorMap v_map,   // (B Nkv, Skv, D)
                    const __grid_constant__ CUtensorMap do_map,  // (B N, Sq, D)
                    const float* __restrict__ lse,               // (B, N, Sq)
                    const float* __restrict__ delta,             // (B, N, Sq)
                    bf16* __restrict__ dq,                       // (B, N, Sq, D)
                    const int* __restrict__ seg,  // (B, S) ids (SEG only)
                    int n_heads, int nkv, int sq, int skv, int causal,
                    float sm_scale, float scale_log2) {
  using F = Dq<D>;
  constexpr int KV = F::kKv, STAGES = F::kStages;
  constexpr int kNs = KV / 8;  // 8-column accumulator tiles of S and dP
  constexpr int kNo = D / 8;   // and of dq
  const int bh = blockIdx.x;   // batch * N + q head
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = bh % n_heads, bi = bh / n_heads;
  const int kv_mat = bi * nkv + h / (n_heads / nkv);  // K/V maps' outer index
  const int q0 = qt * kBlockRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int wq0 = q0 + wg * kWgRows;  // the warpgroup's first q row
  const int t = lane & 3;
  const int row_lo = wq0 + (warp & 3) * 16 + (lane >> 2);  // rows row_lo, + 8
  // segment mode (sq == skv): the batch row's ids, and those of the
  // thread's two q rows (rows past S are not stored: any id will do)
  const int* seg_b = SEG ? seg + static_cast<size_t>(bi) * skv : nullptr;
  int seg_r[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      seg_r[r] = row < sq ? __ldg(seg_b + row) : -1;
    }
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + F::kQBytes;
  const uint32_t kv_s = base + 2 * F::kQBytes;
  const uint32_t q_bar = base + F::kBarOffset;
  const uint32_t full_bar = q_bar + 8;               // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // + 8 s: stage s free

  const int n_kt = (skv + KV - 1) / KV;
  const int kt_end = causal ? min(n_kt, (q0 + kBlockRows - 1) / KV + 1) : n_kt;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kBwdThreads / 32);  // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0: K and V tile kt into its stage
  auto load_kv = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t k_dst = kv_s + s * F::kStageBytes;
    mbar_expect_tx(full_bar + 8 * s, F::kStageBytes);
#pragma unroll
    for (int bx = 0; bx < F::kBoxes; ++bx) {
      tma_load_3d(k_dst + bx * F::kKvBox, &k_map, full_bar + 8 * s, bx * kBoxCols,
                  kt * KV, kv_mat);
      tma_load_3d(k_dst + F::kTileBytes + bx * F::kKvBox, &v_map, full_bar + 8 * s,
                  bx * kBoxCols, kt * KV, kv_mat);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * F::kQBytes);
#pragma unroll
    for (int bx = 0; bx < F::kBoxes; ++bx) {
      tma_load_3d(q_s + bx * F::kQBox, &q_map, q_bar, bx * kBoxCols, q0, bh);
      tma_load_3d(do_s + bx * F::kQBox, &do_map, q_bar, bx * kBoxCols, q0, bh);
    }
    for (int kt = 0; kt < min(STAGES, kt_end); ++kt) load_kv(kt);
  }
  __syncwarp();

  // the thread's two rows: -lse in log2 units, and delta (0 past Sq, where
  // Q and dO read as zero and the rows are not stored)
  float neg_lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const bool in = row < sq;
    neg_lse[r] = in ? -lse[static_cast<size_t>(bh) * sq + row] * kLog2e : 0.f;
    dlt[r] = in ? delta[static_cast<size_t>(bh) * sq + row] : 0.f;
  }

  float acc[kNo][4] = {};  // dq, in the wgmma accumulator layout
  const uint32_t q_wg = q_s + wg * kWgRows * kRowBytes;
  const uint32_t do_wg = do_s + wg * kWgRows * kRowBytes;
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int s = kt % STAGES;
    const int kv0 = kt * KV;
    const uint32_t k_s = kv_s + s * F::kStageBytes;
    const uint32_t v_s = k_s + F::kTileBytes;
    mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);

    // a tile wholly above the warpgroup's diagonal adds nothing
    if (!causal || kv0 <= wq0 + kWgRows - 1) {
      // S = Q K^T and dP = dO V^T: 64 rows x KV columns, D / 16 k steps each
      float sc[kNs][4], dp[kNs][4];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t at = (kc / 4) * F::kQBox + (kc % 4) * 32;
        const uint32_t bt = (kc / 4) * F::kKvBox + (kc % 4) * 32;
        wgmma_ss(sc, desc_sw128(q_wg + at, 16, 1024), desc_sw128(k_s + bt, 16, 1024),
                 kc > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t at = (kc / 4) * F::kQBox + (kc % 4) * 32;
        const uint32_t bt = (kc / 4) * F::kKvBox + (kc % 4) * 32;
        wgmma_ss(dp, desc_sw128(do_wg + at, 16, 1024), desc_sw128(v_s + bt, 16, 1024),
                 kc > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S is in; P is computed while dP runs
      fence_acc(sc);

      // masks: the causal compare only where the tile crosses the
      // warpgroup's diagonal, the Skv compare only on a ragged last tile,
      // the segment compare on every tile
      if (SEG || (causal && kv0 + KV - 1 > wq0) || kv0 + KV > skv) {
#pragma unroll
        for (int j = 0; j < kNs; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row_lo + (c >> 1) * 8;
            const int col = kv0 + j * 8 + 2 * t + (c & 1);
            if (col >= skv || (causal && col > row) ||
                (SEG && __ldg(seg_b + col) != seg_r[c >> 1])) {
              sc[j][c] = -CUDART_INF_F;
            }
          }
        }
      }
      // P = 2^(s c - lse log2 e) into sc, then dS = P (dP - delta) into dp
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[j][c] = exp2_ftz(fmaf(sc[j][c], scale_log2, neg_lse[c >> 1]));
        }
      }
      wgmma_wait<0>();
      fence_acc(dp);
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[j][c] = sc[j][c] * (dp[j][c] - dlt[c >> 1]);
      }

      // dq += bf16(dS) K: KV / 16 k steps, K MN-major
      uint32_t da[KV / 16][4];
#pragma unroll
      for (int part = 0; part < KV / 64; ++part) c_to_a(da + 4 * part, dp + 8 * part);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KV / 16; ++kc) {
        wgmma_rs_t(acc, da[kc], desc_sw128(k_s + kc * 16 * kRowBytes, F::kKvBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }

    // release the stage; thread 0 refills the previous tile's stage, which
    // the other warpgroup has most likely released by now
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    const int done = kt - 1;
    if (tid == 0 && done >= 0 && done + STAGES < kt_end) {
      mbar_wait(empty_bar + 8 * (done % STAGES), (done / STAGES) & 1);
      load_kv(done + STAGES);
    }
    __syncwarp();
  }

  store_rows<D>(dq + static_cast<size_t>(bh) * sq * D, acc, wq0 + (warp & 3) * 16, sq,
                sm_scale, lane);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map,      // (B Nkv, Skv, D)
                     const __grid_constant__ CUtensorMap v_map,      // (B Nkv, Skv, D)
                     const __grid_constant__ CUtensorMap q_map,      // (B N, Sq, D)
                     const __grid_constant__ CUtensorMap do_map,     // (B N, Sq, D)
                     const __grid_constant__ CUtensorMap lse_map,    // (B N Sq)
                     const __grid_constant__ CUtensorMap delta_map,  // (B N Sq)
                     bf16* __restrict__ dk,                          // (B, Nkv, Skv, D)
                     bf16* __restrict__ dv,                          // (B, Nkv, Skv, D)
                     const int* __restrict__ seg,  // (B, S) ids (SEG only)
                     int n_heads, int nkv, int sq, int skv, int causal,
                     float sm_scale, float scale_log2) {
  using F = Dkv<D>;
  constexpr int QT = F::kQt, STAGES = F::kStages;
  constexpr int kNs = QT / 8;  // 8-column accumulator tiles of S^T and dP^T
  constexpr int kNo = D / 8;   // and of dk, dv
  const int bkv = blockIdx.x;  // batch * Nkv + kv head
  const int group = n_heads / nkv;
  const int kv0 = blockIdx.y * kBlockRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int wk0 = kv0 + wg * kWgRows;  // the warpgroup's first kv row
  const int t = lane & 3;
  const int row_lo = wk0 + (warp & 3) * 16 + (lane >> 2);  // kv rows row_lo, + 8
  // segment mode (sq == skv): the batch row's ids, and those of the
  // thread's two kv rows (rows past S are not stored: any id will do)
  const int* seg_b = SEG ? seg + static_cast<size_t>(bkv / nkv) * skv : nullptr;
  int seg_r[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      seg_r[r] = row < skv ? __ldg(seg_b + row) : -1;
    }
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + F::kKvBytes;
  const uint32_t ring = base + 2 * F::kKvBytes;
  const uint32_t kv_bar = base + F::kBarOffset;
  const uint32_t full_bar = kv_bar + 8;              // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // + 8 s: stage s free
  // the ring as a generic pointer, for the lse and delta reads
  const unsigned char* ring_p = smem_raw + (ring - raw);

  // the walk: q head gi of the group, q tile qt_begin + n; q tile qt reaches
  // kv row kv0 under the causal mask iff qt QT + QT - 1 >= kv0
  const int n_qt = (sq + QT - 1) / QT;
  const int qt_begin = causal ? min(kv0 / QT, n_qt) : 0;
  const int n_q = n_qt - qt_begin;
  const int n_walk = group * n_q;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kBwdThreads / 32);  // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0: Q, dO, lse and delta of walk step w into its stage
  auto load_q = [&](int w) {
    const int s = w % STAGES;
    const int bh = bkv * group + w / n_q;  // batch * N + q head
    const int q0 = (qt_begin + w % n_q) * QT;
    const uint32_t dst = ring + s * F::kStageBytes;
    mbar_expect_tx(full_bar + 8 * s, F::kLoadBytes);
#pragma unroll
    for (int bx = 0; bx < F::kBoxes; ++bx) {
      tma_load_3d(dst + bx * F::kQBox, &q_map, full_bar + 8 * s, bx * kBoxCols, q0, bh);
      tma_load_3d(dst + F::kTileBytes + bx * F::kQBox, &do_map, full_bar + 8 * s,
                  bx * kBoxCols, q0, bh);
    }
    tma_load_1d(dst + 2 * F::kTileBytes, &lse_map, full_bar + 8 * s, bh * sq + q0);
    tma_load_1d(dst + 2 * F::kTileBytes + F::kVecBytes, &delta_map, full_bar + 8 * s,
                bh * sq + q0);
  };
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * F::kKvBytes);
#pragma unroll
    for (int bx = 0; bx < F::kBoxes; ++bx) {
      tma_load_3d(k_s + bx * F::kKvBox, &k_map, kv_bar, bx * kBoxCols, kv0, bkv);
      tma_load_3d(v_s + bx * F::kKvBox, &v_map, kv_bar, bx * kBoxCols, kv0, bkv);
    }
    for (int w = 0; w < min(STAGES, n_walk); ++w) load_q(w);
  }
  __syncwarp();

  float dk_acc[kNo][4] = {};  // in the wgmma accumulator layout
  float dv_acc[kNo][4] = {};
  const uint32_t k_wg = k_s + wg * kWgRows * kRowBytes;
  const uint32_t v_wg = v_s + wg * kWgRows * kRowBytes;
  mbar_wait(kv_bar, 0);

  int qt = qt_begin;
  for (int w = 0; w < n_walk; ++w) {
    const int s = w % STAGES;
    const int q0 = qt * QT;
    const uint32_t q_t = ring + s * F::kStageBytes;
    const uint32_t do_t = q_t + F::kTileBytes;
    const float* lse_t =
        reinterpret_cast<const float*>(ring_p + s * F::kStageBytes + 2 * F::kTileBytes);
    const float* dlt_t = lse_t + QT;
    mbar_wait(full_bar + 8 * s, (w / STAGES) & 1);

    // a q tile wholly before the warpgroup's first kv row adds nothing
    if (!causal || q0 + QT - 1 >= wk0) {
      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x QT q columns
      float sc[kNs][4], dp[kNs][4];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t at = (kc / 4) * F::kKvBox + (kc % 4) * 32;
        const uint32_t bt = (kc / 4) * F::kQBox + (kc % 4) * 32;
        wgmma_ss(sc, desc_sw128(k_wg + at, 16, 1024), desc_sw128(q_t + bt, 16, 1024),
                 kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t at = (kc / 4) * F::kKvBox + (kc % 4) * 32;
        const uint32_t bt = (kc / 4) * F::kQBox + (kc % 4) * 32;
        wgmma_ss(dp, desc_sw128(v_wg + at, 16, 1024), desc_sw128(do_t + bt, 16, 1024),
                 kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // masks (rows are kv positions j, columns q positions i; causal keeps
      // j <= i): the causal compare only where the tile crosses the
      // warpgroup's diagonal, the Sq compare only on a ragged last q tile,
      // the segment compare on every tile
      if (SEG || (causal && q0 < wk0 + kWgRows - 1) || q0 + QT > sq) {
#pragma unroll
        for (int j = 0; j < kNs; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row_lo + (c >> 1) * 8;
            const int col = q0 + j * 8 + 2 * t + (c & 1);
            if (col >= sq || (causal && row > col) ||
                (SEG && __ldg(seg_b + col) != seg_r[c >> 1])) {
              sc[j][c] = -CUDART_INF_F;
            }
          }
        }
      }
      // P^T = 2^(s c - lse log2 e) into sc, dS^T = P^T (dP^T - delta) into dp
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + j * 8 + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + j * 8 + 2 * t);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2_ftz(fmaf(sc[j][c], scale_log2, nl[c & 1]));
          sc[j][c] = p;
          dp[j][c] = p * (dp[j][c] - dl[c & 1]);
        }
      }

      // dv += bf16(P^T) dO and dk += bf16(dS^T) Q: QT / 16 k steps each,
      // dO and Q MN-major
      uint32_t pa[QT / 16][4], da[QT / 16][4];
      c_to_a(pa, sc);
      c_to_a(da, dp);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) {
        wgmma_rs_t(dv_acc, pa[kc], desc_sw128(do_t + kc * 16 * kRowBytes, F::kQBox, 1024),
                   1);
      }
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) {
        wgmma_rs_t(dk_acc, da[kc], desc_sw128(q_t + kc * 16 * kRowBytes, F::kQBox, 1024),
                   1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
    }

    // release the stage; thread 0 refills the previous step's stage, which
    // the other warpgroup has most likely released by now
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    const int done = w - 1;
    if (tid == 0 && done >= 0 && done + STAGES < n_walk) {
      mbar_wait(empty_bar + 8 * (done % STAGES), (done / STAGES) & 1);
      load_q(done + STAGES);
    }
    __syncwarp();
    if (++qt == n_qt) qt = qt_begin;
  }

  const size_t kv_off = static_cast<size_t>(bkv) * skv * D;
  store_rows<D>(dk + kv_off, dk_acc, wk0 + (warp & 3) * 16, skv, sm_scale, lane);
  store_rows<D>(dv + kv_off, dv_acc, wk0 + (warp & 3) * 16, skv, 1.f, lane);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const int* seg, int b, int n_heads, int nkv, int sq,
                      int skv, int causal, float sm_scale, cudaStream_t stream) {
  using F = Dq<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!make_map(encode, &q_map, q, D, sq, b * n_heads, kBlockRows) ||
      !make_map(encode, &k_map, k, D, skv, b * nkv, F::kKv) ||
      !make_map(encode, &v_map, v, D, skv, b * nkv, F::kKv) ||
      !make_map(encode, &do_map, dout, D, sq, b * n_heads, kBlockRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = seg != nullptr ? flash_bwd_dq_kernel<D, true> : flash_bwd_dq_kernel<D, false>;
  cudaError_t err = allow_smem(kernel, F::kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBlockRows - 1) / kBlockRows;
  kernel<<<dim3(b * n_heads, n_qt), kBwdThreads, F::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), seg, n_heads, nkv, sq,
      skv, causal, sm_scale, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const int* seg, int b, int n_heads,
                       int nkv, int sq, int skv, int causal, float sm_scale,
                       cudaStream_t stream) {
  using F = Dkv<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap k_map, v_map, q_map, do_map, lse_map, delta_map;
  const size_t n_vec = static_cast<size_t>(b) * n_heads * sq;
  if (!make_map(encode, &k_map, k, D, skv, b * nkv, kBlockRows) ||
      !make_map(encode, &v_map, v, D, skv, b * nkv, kBlockRows) ||
      !make_map(encode, &q_map, q, D, sq, b * n_heads, F::kQt) ||
      !make_map(encode, &do_map, dout, D, sq, b * n_heads, F::kQt) ||
      !make_vec_map(encode, &lse_map, lse, n_vec, F::kQt) ||
      !make_vec_map(encode, &delta_map, delta, n_vec, F::kQt)) {
    return cudaErrorInvalidValue;
  }
  auto kernel =
      seg != nullptr ? flash_bwd_dkv_kernel<D, true> : flash_bwd_dkv_kernel<D, false>;
  cudaError_t err = allow_smem(kernel, F::kSmem);
  if (err != cudaSuccess) return err;
  const int n_kb = (skv + kBlockRows - 1) / kBlockRows;
  kernel<<<dim3(b * nkv, n_kb), kBwdThreads, F::kSmem, stream>>>(
      k_map, v_map, q_map, do_map, lse_map, delta_map, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), seg, n_heads, nkv, sq, skv, causal, sm_scale,
      sm_scale * kLog2e);
  return cudaGetLastError();
}

// grid extents within 65535; the 1-D lse/delta coordinates (b N Sq plus a
// tile) within an int; segment ids only with Sq == Skv
bool valid(const int* seg, int b, int n_heads, int nkv, int sq, int skv) {
  return b >= 1 && nkv >= 1 && n_heads % nkv == 0 && sq >= 1 && skv >= 1 &&
         (seg == nullptr || sq == skv) &&
         (sq + kBlockRows - 1) / kBlockRows <= 65535 &&
         (skv + kBlockRows - 1) / kBlockRows <= 65535 &&
         static_cast<long long>(b) * n_heads * sq + kBlockRows <= 0x7fffffffLL;
}

}  // namespace

// C entry points, bound with ctypes. Pointers are device pointers of
// contiguous, 16-byte aligned tensors allocated by the caller; seg is a
// contiguous (B, S) int32 array of segment ids (S = Sq = Skv), or null for
// no segments. The stream is the caller's current CUDA stream. Each
// returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, const int* seg,
                                 int b, int n_heads, int nkv, int sq, int skv,
                                 int head_dim, int causal, float sm_scale,
                                 void* stream) {
  if (!valid(seg, b, n_heads, nkv, sq, skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dq<64>(q, k, v, dout, lse, delta, dq, seg,
                                            b, n_heads, nkv, sq, skv, causal,
                                            sm_scale, st));
    case 96:
      return static_cast<int>(launch_dq<96>(q, k, v, dout, lse, delta, dq, seg,
                                            b, n_heads, nkv, sq, skv, causal,
                                            sm_scale, st));
    case 128:
      return static_cast<int>(launch_dq<128>(q, k, v, dout, lse, delta, dq, seg,
                                             b, n_heads, nkv, sq, skv, causal,
                                             sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const int* seg, int b, int n_heads, int nkv,
                                  int sq, int skv, int head_dim, int causal,
                                  float sm_scale, void* stream) {
  if (!valid(seg, b, n_heads, nkv, sq, skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv,
                                             seg, b, n_heads, nkv, sq, skv,
                                             causal, sm_scale, st));
    case 96:
      return static_cast<int>(launch_dkv<96>(q, k, v, dout, lse, delta, dk, dv,
                                             seg, b, n_heads, nkv, sq, skv,
                                             causal, sm_scale, st));
    case 128:
      return static_cast<int>(launch_dkv<128>(q, k, v, dout, lse, delta, dk,
                                              dv, seg, b, n_heads, nkv, sq, skv,
                                              causal, sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
