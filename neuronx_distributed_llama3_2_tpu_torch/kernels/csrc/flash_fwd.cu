// Flash-attention forward for Hopper (sm_90a): o = softmax(s * Q K^T) V and
// its log-sum-exp, causal or full, grouped-query (q head h reads kv head
// h / G), bf16 in, bf16 o and fp32 lse out.
//
// Replaces: neuronx_distributed_llama3_2_tpu/kernels/pallas_flash_attention.py
//   _fwd_kernel (:44), launched by _flash_fwd (:145, pallas_call at :194).
//   Modes ported: causal and full masks with the padding mask to kv_len,
//   and the segment_ids mode (packed documents, :88-90): a (q, kv) pair
//   attends only where seg[b, q] == seg[b, kv].
//
// What bounds it on the H100: operations. A (q, kv) pair costs 4 * D FLOPs
// (Q K^T and P V, 2 * D each); at the training shape (B 12, N 32,
// S 2048, D 64, causal: S (S + 1) / 2 pairs per head) that is
// 2.06e11 FLOPs, 0.21 ms at 989 TFLOP/s. The bytes (q, k, v, o, lse:
// about 0.2 GB) take 0.06 ms at 3.35 TB/s.
//
// What the design does about it (the PTX pieces are in sm90.cuh):
// - both products run on wgmma, the warpgroup product that reaches the
//   tensor cores' full rate: S = Q K^T (m64 nKV k16, Q and K from shared
//   memory) and O += P V (m64 nD k16, P from registers: S's accumulator
//   rounded to bf16 is already an A operand, so the softmax weights never
//   leave the registers);
// - one block per (batch, q head, 128-row q tile): two warpgroups of 64 q
//   rows, each carrying (m, l, O) for its rows in registers over a loop of
//   kv tiles (the TPU kernel's sequential kv grid axis); the softmax of
//   one warpgroup runs beside the other's products;
// - Q is loaded once, by TMA, and stays in shared memory for the walk;
// - K and V tiles come through a ring of three stages in shared memory,
//   filled by TMA (one thread issues a tile; the hardware writes the
//   128-byte swizzle the wgmma descriptors read, and zero-fills rows past
//   Skv) and signalled by one mbarrier a stage; the issuing thread refills
//   a stage one tile after its own release of it, by when the other
//   warpgroup has most likely released it too, so the copies of the next
//   two tiles run beside the products of this one;
// - masks only where needed: the causal compare on kv tiles that cross the
//   warpgroup's diagonal, the Skv compare on the last kv tile; a tile
//   wholly above the warpgroup's diagonal is skipped; the causal loop ends
//   at the diagonal, and the heaviest q tiles launch first, so the short
//   ones fill the grid's tail. With segment ids every tile may hold a
//   document boundary, so the id compare runs on every tile: each thread
//   reads its two q rows' ids once and its columns' ids of each tile from
//   global memory (L1 / L2; 4 bytes a row beside K's and V's 128 or 256),
//   the reads past S guarded. The ids are compared, not assumed
//   contiguous: an id may come back after another one. The mode is a
//   compile-time instance of its own (SEG), so the causal and full masks
//   run the same code as without it: a runtime test of the id pointer on
//   every tile cost the unsegmented K1 3.6 % and K3 6 % in turns on the
//   card. Skipping tiles by segment range is later work;
// - the exponentials run on the special-function unit with subnormal
//   results flushed (exp2_ftz), which saves exp2f's three-instruction
//   rescale around each: the softmax, not the products, takes most of a
//   tile's issue slots at D = 64;
// - GQA: the kv head is h / G; no K/V copy per q head.
// Tiles, chosen by what the card measured: at D = 64, 64 kv rows, 64 KB of
// shared memory and 100 registers, so that two blocks share an SM and
// one's loads and epilogue run beside the other's tiles (128 kv rows took
// 155 registers, one block an SM, and 13 % longer at the train shape); at
// D = 128, 128 kv rows, 225 KB and 182 registers, one block an SM. Neither
// spills. D = 96 (gpt-neox-20b) is no multiple of the 64-column swizzled
// box: its rows are D = 128's two boxes, the second one's columns 96-127
// zero-filled by the copy (the map's inner extent is 96), so it takes
// D = 128's tiles, 128 kv rows and 225 KB; S = Q K^T runs 6 k-steps, the
// last two in the second box, and O += P V is one wgmma of n = 96 whose
// last 32 columns are the second box's first 32 (173 registers, 175 with
// segment ids, no spill). No operand is padded in device memory. A producer warp of its own (setmaxnreg) and scheduling the two
// warpgroups' products in turns are later work; running S of tile kt
// beside P V of tile kt - 1 in one warpgroup measured slower.
//
// Numerics (the plain version is flash_fwd_reference in
// kernels/flash_attention.py): scores are fp32 products of the bf16
// operands; the softmax runs in base 2 with sm_scale * log2(e) folded into
// one FMA (2^(s * c - m)), the same as the natural-base softmax up to fp32
// rounding and the flush of p below 2^-126 (which bf16 P cannot hold as a
// normal number either); masked scores are -inf; the m == -inf guards of
// the TPU kernel (:96-99, :115-118): a row with no key so far has alpha = 0
// and p = 0 (its max enters the FMA as 0, so 2^-inf = 0), and a row with no
// key at all gets o = 0 and lse = -inf (under segment ids a row sees no
// key in each kv tile before its document starts, causal or not); p is
// rounded to bf16 before P V
// (:105) while the denominator l sums the unrounded p; lse = m + log(l) in
// natural log.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int kWgRows = 64;                // q rows of a consumer warpgroup
constexpr int kQRows = 2 * kWgRows;        // q rows of a block
constexpr int kFwdThreads = 2 * 128;       // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// tile geometry and shared-memory layout for head dim D: from a 1024-byte
// aligned base, Q (ceil(D / 64) boxes of 128 rows), then STAGES x (K tile,
// V tile) (ceil(D / 64) boxes of KV rows each), then the mbarriers.
template <int D>
struct Fwd {
  static constexpr int kKv = D == 64 ? 64 : 128;        // kv rows of a tile
  static constexpr int kStages = 3;
  // boxes of 64 columns: at D = 96 the second one's last 32 are zero
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kQBox = kQRows * kRowBytes;      // bytes of a Q box
  static constexpr int kKvBox = kKv * kRowBytes;        // bytes of a K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKvBox;    // one K (or V) tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 1024 bytes of room to align the base; barriers: Q, full[], empty[]
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// SEG: the segment_ids mode, a compile-time instance of its own, so that
// the causal and full masks run the same code with or without it
template <int D, bool SEG>
__global__ void __launch_bounds__(kFwdThreads, D == 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,  // (B N, Sq, D)
                 const __grid_constant__ CUtensorMap k_map,  // (B Nkv, Skv, D)
                 const __grid_constant__ CUtensorMap v_map,  // (B Nkv, Skv, D)
                 bf16* __restrict__ o,                       // (B, N, Sq, D)
                 float* __restrict__ lse,                    // (B, N, Sq)
                 const int* __restrict__ seg,  // (B, S) ids (SEG only)
                 int n_heads, int nkv, int sq, int skv, int causal,
                 float scale_log2) {
  using F = Fwd<D>;
  constexpr int KV = F::kKv, STAGES = F::kStages;
  constexpr int kNs = KV / 8;  // 8-column accumulator tiles of S
  constexpr int kNo = D / 8;   // and of O
  const int bh = blockIdx.x;   // batch * N + q head
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = bh % n_heads, bi = bh / n_heads;
  const int kv_mat = bi * nkv + h / (n_heads / nkv);  // K/V maps' outer index
  const int q0 = qt * kQRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int wq0 = q0 + wg * kWgRows;  // the warpgroup's first q row
  const int t = lane & 3;
  const int row_lo = wq0 + (warp & 3) * 16 + (lane >> 2);  // rows row_lo, + 8
  // segment mode (sq == skv): the batch row's ids, and those of the
  // thread's two q rows (rows past S are not stored: any id will do)
  const int* seg_b = SEG ? seg + static_cast<size_t>(bi) * skv : nullptr;
  int seg_q[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      seg_q[r] = row < sq ? __ldg(seg_b + row) : -1;
    }
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + F::kQBytes;
  const uint32_t q_bar = base + F::kBarOffset;
  const uint32_t full_bar = q_bar + 8;               // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // + 8 s: stage s free

  const int n_kt = (skv + KV - 1) / KV;
  const int kt_end = causal ? min(n_kt, (q0 + kQRows - 1) / KV + 1) : n_kt;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kFwdThreads / 32);  // one arrival a warp
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
    mbar_expect_tx(q_bar, F::kQBytes);
#pragma unroll
    for (int bx = 0; bx < F::kBoxes; ++bx) {
      tma_load_3d(q_s + bx * F::kQBox, &q_map, q_bar, bx * kBoxCols, q0, bh);
    }
    for (int kt = 0; kt < min(STAGES, kt_end); ++kt) load_kv(kt);
  }
  __syncwarp();

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
  float l[2] = {0.f, 0.f};  // this lane's share of the running sum
  float acc[kNo][4] = {};   // O, in the wgmma accumulator layout
  const uint32_t q_wg = q_s + wg * kWgRows * kRowBytes;
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int s = kt % STAGES;
    const int kv0 = kt * KV;
    const uint32_t k_s = kv_s + s * F::kStageBytes;
    const uint32_t v_s = k_s + F::kTileBytes;
    mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);

    // a tile wholly above the warpgroup's diagonal adds nothing
    if (!causal || kv0 <= wq0 + kWgRows - 1) {
      // S = Q K^T: 64 rows x KV columns, D / 16 k steps
      float sc[kNs][4];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t at = (kc / 4) * F::kQBox + (kc % 4) * 32;
        const uint32_t bt = (kc / 4) * F::kKvBox + (kc % 4) * 32;
        wgmma_ss(sc, desc_sw128(q_wg + at, 16, 1024), desc_sw128(k_s + bt, 16, 1024),
                 kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
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
                (SEG && __ldg(seg_b + col) != seg_q[c >> 1])) {
              sc[j][c] = -CUDART_INF_F;
            }
          }
        }
      }

      // the tile's row maxima, then the running max in log2 units
      float mb[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) mb[c >> 1] = fmaxf(mb[c >> 1], sc[j][c]);
      }
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
        const float m_new = fmaxf(m[r], mb[r] * scale_log2);
        alpha[r] = (m[r] == -CUDART_INF_F) ? 0.f : exp2_ftz(m[r] - m_new);
        m[r] = m_new;
        // a row with no key yet has only -inf scores: p = 2^-inf = 0
        neg_m[r] = (m_new == -CUDART_INF_F) ? 0.f : -m_new;
      }
      // p = 2^(s c - m); l sums the unrounded p
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2_ftz(fmaf(sc[j][c], scale_log2, neg_m[c >> 1]));
          sc[j][c] = p;
          rs[c >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < kNo; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c >> 1];
      }

      // O += bf16(P) V: KV / 16 k steps; P's A operands straight from S
      uint32_t pa[KV / 16][4];
#pragma unroll
      for (int part = 0; part < KV / 64; ++part) c_to_a(pa + 4 * part, sc + 8 * part);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KV / 16; ++kc) {
        wgmma_rs_t(acc, pa[kc], desc_sw128(v_s + kc * 16 * kRowBytes, F::kKvBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }

    // release the stage. Thread 0 refills the previous tile's stage, which
    // the other warpgroup has most likely released by now: the warpgroups
    // may drift up to a tile apart, and one's softmax run beside the
    // other's products
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    const int done = kt - 1;
    if (tid == 0 && done >= 0 && done + STAGES < kt_end) {
      mbar_wait(empty_bar + 8 * (done % STAGES), (done / STAGES) & 1);
      load_kv(done + STAGES);
    }
    __syncwarp();
  }

  // l over the row's four lanes; o = acc / l (l == 0: no key, o = 0);
  // lse = m ln 2 + log(l), -inf without a key
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    safe[r] = (l[r] == 0.f) ? 1.f : l[r];
  }
#pragma unroll
  for (int j = 0; j < kNo; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] /= safe[c >> 1];
  }
  store_rows<D>(o + static_cast<size_t>(bh) * sq * D, acc, wq0 + (warp & 3) * 16, sq,
                1.f, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < sq) {
        lse[static_cast<size_t>(bh) * sq + row] =
            (m[r] == -CUDART_INF_F) ? -CUDART_INF_F : m[r] * kLn2 + logf(safe[r]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const int* seg, int b, int n_heads, int nkv, int sq, int skv,
                   int causal, float sm_scale, cudaStream_t stream) {
  using F = Fwd<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(encode, &q_map, q, D, sq, b * n_heads, kQRows) ||
      !make_map(encode, &k_map, k, D, skv, b * nkv, F::kKv) ||
      !make_map(encode, &v_map, v, D, skv, b * nkv, F::kKv)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = seg != nullptr ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
  cudaError_t err = allow_smem(kernel, F::kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kQRows - 1) / kQRows;
  kernel<<<dim3(b * n_heads, n_qt), kFwdThreads, F::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seg, n_heads,
      nkv, sq, skv, causal, sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers of
// contiguous, 16-byte aligned tensors allocated by the caller; seg is a
// contiguous (B, S) int32 array of segment ids (S = Sq = Skv), or null for
// no segments. The stream is the caller's current CUDA stream. Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const int* seg, int b,
                              int n_heads, int nkv, int sq, int skv,
                              int head_dim, int causal, float sm_scale,
                              void* stream) {
  if (b < 1 || nkv < 1 || n_heads % nkv != 0 || sq < 1 || skv < 1 ||
      (sq + kQRows - 1) / kQRows > 65535 || (seg != nullptr && sq != skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, lse, seg, b, n_heads, nkv,
                                         sq, skv, causal, sm_scale, st));
    case 96:
      return static_cast<int>(launch<96>(q, k, v, o, lse, seg, b, n_heads, nkv,
                                         sq, skv, causal, sm_scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, lse, seg, b, n_heads, nkv,
                                          sq, skv, causal, sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
