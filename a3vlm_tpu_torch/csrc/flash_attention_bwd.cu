// Flash-attention backward for Hopper (sm_90a): K9a (dq) and K9b (dk, dv).
//
// Replaces a3vlm_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:358)
// and ::_flash_bwd_dkv_kernel (:414), reached through _flash_backward_bhsd.
// Inputs: q, do [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] bf16; lse (the
// forward's natural-log log-sum-exp, flash_attention.cu) and
// delta = rowsum(do * o) [B, Hq, Sq] f32. Outputs dq [B, Hq, Sq, D] and
// dk, dv [B, Hkv, Skv, D] bf16, the GQA group already summed. The mask is
// K2's: row r sees key c iff c < skv_actual and, when causal,
// c <= r + skv_actual - sq_actual; a row with lse = -inf (no visible key)
// contributes nothing.
//
// Per visible (row, key) pair both kernels recompute the score s = q.k,
// p = exp2(s * scale * log2 e - lse * log2 e), dp = do.v and
// ds = p (dp - delta) scale, rounding p and ds to bf16 before the products
// that consume them, as the TPU kernels do (:385, :440, :450). Blocks run
// unordered, so the TPU grid's carried accumulators become loops inside the
// block, and each output element is owned by one thread and written once:
// no atomics, so the result is the same bit for bit from run to run.
//
// K9a, what bounds it on an H100: operations, three products of 2 D flops
// per visible pair (129 GFLOP at the training shape, B 2, H 40, S 2048,
// D 128) against 126 MB of operands, so the bf16 tensor-core rate sets the
// floor. The design feeds the tensor cores as K2's does
// (attention_mma.cuh): a block of one warpgroup owns 64 query rows, holds
// their Q and dO tiles in shared memory as bf16 (cp.async, once) and
// lse * log2 e and delta in registers, and streams K and V through a ring
// of 64-key tiles that one thread asks the TMA to fill (an mbarrier per
// stage reports arrival) while the previous tile's products run. Per tile
// S = Q K^T and dP = dO V^T are wgmma m64n64k16 over shared-memory operands
// (both tiles are K-major B operands as they lie), p and ds are formed in
// registers on the accumulator layout, and dQ += ds K takes ds from
// registers as the A operand and the same K tile a second time as an
// MN-major B operand (transpose flag). Only tiles that the diagonal or the
// ragged end crosses are masked; the key loop stops at the causal limit of
// the block's last row; within a batch element every head's heaviest query
// tile is launched first (K2's order); dq leaves through the block's Q tile
// in 16-byte pieces. D % 8 != 0 takes the slow load path (plain loads).
//
// K9b, what bounds it: operations as well, four products of 2 D flops per
// visible pair (172 GFLOP at the training shape) against 252 MB of
// operands. The design is K9a's turned around, keys being the M dimension:
// a block of two warpgroups owns 128 keys of one (batch, kv head), 64 a
// warpgroup, and holds their K and V tiles in shared memory (one TMA
// request). The Q and dO tiles (64 rows) of every q head of the GQA group
// stream through a three-stage ring that both warpgroups share, one thread
// asking the TMA for them, an mbarrier per stage, from the first row tile
// that can see the block's keys; lse * log2 e and delta of each tile's 64
// rows are staged beside it in shared memory (loaded a stage ahead, so the
// load's latency hides behind the products). Per tile and warpgroup:
// S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
// K-major as they lie; P^T and dS^T are formed on the accumulator layout
// (lse and delta per column), P^T while dP^T is still on the tensor cores
// (with the third stage, ~5% faster than two stages and waiting for both);
// dV += P^T dO and dK += dS^T Q take P^T and dS^T from registers as A
// fragments and the dO and Q tiles as MN-major B operands (transpose
// flag). The GQA group's sum the TPU caller does over a [B, Hq, Skv, D]
// buffer (:615-617) stays in the f32 accumulators. A warpgroup skips a
// tile that no row of it sees; only tiles that the diagonal or the ragged
// ends cross are masked. Within a (batch, kv head) the earliest key tiles,
// which see the most rows, launch first and the head's Q and dO (1 MB a q
// head at S 2048) stay in L2 for all its key tiles. dk and dv leave
// through the K and V tiles in 16-byte pieces. D % 8 != 0 takes the slow
// load path (plain loads).

#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace mm = a3mma;

template <int DP, int STAGES>
struct DqCfg {
  static constexpr int BM = mm::WG_ROWS;  // one warpgroup per block
  static constexpr int BN = 64;           // keys per tile
  static constexpr int ROW_BYTES = BM * DP * 2;     // the Q tile, the dO tile
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int SMEM =
      mm::SWIZZLE_ALIGN + 2 * ROW_BYTES + STAGES * 2 * KV_BYTES;
};

template <int DP, int STAGES>
__global__ void __launch_bounds__(mm::WG_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
                    int skv_actual, float scale_log2, float scale,
                    int causal_i) {
  using C = DqCfg<DP, STAGES>;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];  // tile t's bytes landed
  uint8_t* qs = mm::align_smem(smem_raw);
  uint8_t* dos = qs + C::ROW_BYTES;
  uint8_t* ring = dos + C::ROW_BYTES;  // tile t: K at 2 (t % STAGES), V after

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const bool causal = causal_i != 0;
  const bool vec = (D & 7) == 0;  // TMA and 16-byte copies; else plain loads

  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // heaviest first
  const int h = blockIdx.x, b = blockIdx.z;
  const long row0 = ((long)b * Hq + h) * Sq;
  const int kv_head = b * Hkv + h / (Hq / Hkv);
  const int offset = skv_actual - sq_actual;
  const int kv_end =
      mm::visible_end(q0, C::BM, Sq, skv_actual, offset, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mm::mbar_init(mm::smem_u32(&full[s]), 1);
    mm::mbar_fence_init();
  }
  __syncthreads();

  // Tile t into its stage: one thread asks the TMA for the K and V boxes
  // (rows past skv_actual arrive as zeros), or, on the slow path, all
  // threads fill the stage with plain loads before the next barrier.
  auto load_kv = [&](int t) {
    uint8_t* dst = ring + (2 * (t % STAGES)) * C::KV_BYTES;
    if (vec) {
      if (tid == 0) {
        const uint32_t bar = mm::smem_u32(&full[t % STAGES]);
        mm::mbar_expect_tx(bar, 2 * C::KV_BYTES);
        mm::tma_load_tile<BN, DP>(dst, &k_map, bar, t * BN, kv_head);
        mm::tma_load_tile<BN, DP>(dst + C::KV_BYTES, &v_map, bar, t * BN,
                                  kv_head);
      }
    } else {
      const long at = ((long)kv_head * Skv + (long)t * BN) * D;
      mm::load_tile<BN, DP, mm::WG_THREADS>(dst, k + at, skv_actual - t * BN,
                                            D, false, tid);
      mm::load_tile<BN, DP, mm::WG_THREADS>(dst + C::KV_BYTES, v + at,
                                            skv_actual - t * BN, D, false,
                                            tid);
    }
  };

  mm::load_tile<C::BM, DP, mm::WG_THREADS>(qs, q + (row0 + q0) * D, Sq - q0,
                                           D, vec, tid);
  mm::load_tile<C::BM, DP, mm::WG_THREADS>(dos, dout + (row0 + q0) * D,
                                           Sq - q0, D, vec, tid);
  mm::cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t)
    if (t < n_tiles) load_kv(t);

  // rows of this thread: r_lo and r_lo + 8. A dead row (past Sq, or
  // lse = -inf: no visible key) gets lse2 = +inf, so that its p is 0.
  const int r_lo = q0 + warp * 16 + gq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    const float l = r < Sq ? lse[row0 + r] : -INFINITY;
    const bool live = l > -INFINITY;
    lse2[hh] = live ? l * mm::LOG2E : INFINITY;
    dlt[hh] = live ? delta[row0 + r] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  // Q and dO (and, on the slow path, the first tiles) have landed and are
  // visible to the products
  mm::cp_async_wait<0>();
  mm::fence_proxy_async();
  __syncthreads();

  const uint32_t qs_u = mm::smem_u32(qs), dos_u = mm::smem_u32(dos);
  for (int it = 0; it < n_tiles; ++it) {
    // every warp is done with tile it - 1, whose stage the next copy
    // overwrites (on the slow path the barrier also publishes tile it)
    if (it > 0) {
      if (!vec) mm::fence_proxy_async();
      __syncthreads();
    }
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    if (vec) mm::mbar_wait(mm::smem_u32(&full[it % STAGES]), (it / STAGES) & 1);

    const int kt = it * BN;
    const uint32_t ks_u =
        mm::smem_u32(ring + (2 * (it % STAGES)) * C::KV_BYTES);
    const uint32_t vs_u = ks_u + C::KV_BYTES;

    float s[32], dp[32];
    mm::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      mm::wgmma_ss_n64(s, mm::desc_kmajor(qs_u, C::BM, 0, ks),
                       mm::desc_kmajor(ks_u, BN, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      mm::wgmma_ss_n64(dp, mm::desc_kmajor(dos_u, C::BM, 0, ks),
                       mm::desc_kmajor(vs_u, BN, 0, ks), ks > 0);
    mm::wgmma_commit();
    mm::wgmma_wait<0>();
    mm::fence_regs(s);
    mm::fence_regs(dp);

    const bool need_mask =
        kt + BN > skv_actual || (causal && kt + BN - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float p = mm::fast_exp2(fmaf(s[i], scale_log2, -lse2[hh]));
      if (need_mask) {
        const int c = kt + 8 * (i >> 2) + 2 * cq + (i & 1);
        const int r = r_lo + 8 * hh;
        p = (c < skv_actual && (!causal || c <= r + offset)) ? p : 0.f;
      }
      s[i] = p * (dp[i] - dlt[hh]) * scale;  // ds; rounded by pack_a (:385)
    }
    uint32_t ds[4][4];
    mm::pack_a(s, ds);
    mm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mm::wgmma_rs_tb(acc, ds[kk], mm::desc_mnmajor(ks_u, BN, kk));
    mm::wgmma_commit();
    mm::wgmma_wait<0>();
    mm::fence_regs(acc);
    mm::fence_frags(ds);
  }
  mm::store_rows<C::BM, DP>(qs, 0, acc, 1.f, 1.f, dq + (row0 + q0) * D, D,
                            Sq - q0, D, vec, 0, tid);
}

template <int DP, int STAGES>
struct DkvCfg {
  static constexpr int NWG = 2;
  static constexpr int BK = mm::WG_ROWS * NWG;  // keys per block
  static constexpr int BM = 64;                 // query rows per tile
  static constexpr int THREADS = mm::WG_THREADS * NWG;
  static constexpr int ROW_BYTES = BM * DP * 2;  // a Q tile, a dO tile
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int SMEM =
      mm::SWIZZLE_ALIGN + 2 * KV_BYTES + STAGES * 2 * ROW_BYTES;
};

template <int DP, int STAGES>
__global__ void __launch_bounds__(DkvCfg<DP, STAGES>::THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                     int D, int sq_actual, int skv_actual, float scale_log2,
                     float scale, int causal_i) {
  static_assert(STAGES >= 2, "a tile is loaded a stage ahead");
  using C = DkvCfg<DP, STAGES>;
  constexpr int BM = C::BM, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];  // tile t's Q and dO landed
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ float2 rowv[STAGES][BM];  // (lse * log2 e, delta) of the rows
  uint8_t* ks = mm::align_smem(smem_raw);
  uint8_t* vs = ks + C::KV_BYTES;
  uint8_t* ring = vs + C::KV_BYTES;  // tile t: Q at 2 (t % STAGES), dO after

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / mm::WG_THREADS, 0);
  const int tid_wg = tid % mm::WG_THREADS;
  const int warp = tid_wg >> 5, lane = tid_wg & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const bool causal = causal_i != 0;
  const bool vec = (D & 7) == 0;  // TMA; else plain loads

  const int k0 = blockIdx.x * BK, b = blockIdx.z;
  const int kv_head = b * Hkv + blockIdx.y;
  const int group = Hq / Hkv;
  const int head0 = b * Hq + blockIdx.y * group;  // first q head of the group
  const int offset = skv_actual - sq_actual;
  // a key gets gradient only from rows r >= c - offset (causal), and none
  // at all past skv_actual
  const int r_begin = causal ? max(0, k0 - offset) : 0;
  const int rt_begin = r_begin / BM * BM;
  const int n_rt = k0 < skv_actual && rt_begin < Sq
                       ? (Sq - rt_begin + BM - 1) / BM : 0;
  const int n_tiles = group * n_rt;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mm::mbar_init(mm::smem_u32(&full[s]), 1);
    mm::mbar_init(mm::smem_u32(&kv_full), 1);
    mm::mbar_fence_init();
  }
  __syncthreads();

  // tile t: q head head0 + t / n_rt, rows from rt_begin + (t % n_rt) BM
  auto tile_head = [&](int t) { return head0 + t / n_rt; };
  auto tile_row = [&](int t) { return rt_begin + (t % n_rt) * BM; };
  auto load_rows_of = [&](int t) {
    uint8_t* dst = ring + (2 * (t % STAGES)) * C::ROW_BYTES;
    const int hq = tile_head(t), rt = tile_row(t);
    if (vec) {
      if (tid == 0) {
        const uint32_t bar = mm::smem_u32(&full[t % STAGES]);
        mm::mbar_expect_tx(bar, 2 * C::ROW_BYTES);
        mm::tma_load_tile<BM, DP>(dst, &q_map, bar, rt, hq);
        mm::tma_load_tile<BM, DP>(dst + C::ROW_BYTES, &do_map, bar, rt, hq);
      }
    } else {
      const long at = ((long)hq * Sq + rt) * D;
      mm::load_tile<BM, DP, C::THREADS>(dst, q + at, Sq - rt, D, false, tid);
      mm::load_tile<BM, DP, C::THREADS>(dst + C::ROW_BYTES, dout + at,
                                        Sq - rt, D, false, tid);
    }
  };
  // (lse * log2 e, delta) of row tid of tile t; a dead row (past Sq, or
  // lse = -inf: no visible key) gets +inf, so that its p is 0
  auto row_values = [&](int t) {
    const int r = tile_row(t) + tid;
    const long at = (long)tile_head(t) * Sq + r;
    const float l = r < Sq ? lse[at] : -INFINITY;
    return l > -INFINITY ? make_float2(l * mm::LOG2E, delta[at])
                         : make_float2(INFINITY, 0.f);
  };

  if (vec) {
    if (tid == 0 && n_tiles > 0) {
      const uint32_t bar = mm::smem_u32(&kv_full);
      mm::mbar_expect_tx(bar, 2 * C::KV_BYTES);
      mm::tma_load_tile<BK, DP>(ks, &k_map, bar, k0, kv_head);
      mm::tma_load_tile<BK, DP>(vs, &v_map, bar, k0, kv_head);
    }
  } else {
    const long at = ((long)kv_head * Skv + k0) * D;
    mm::load_tile<BK, DP, C::THREADS>(ks, k + at, skv_actual - k0, D, false,
                                      tid);
    mm::load_tile<BK, DP, C::THREADS>(vs, v + at, skv_actual - k0, D, false,
                                      tid);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) {
      load_rows_of(t);
      if (tid < BM) rowv[t][tid] = row_values(t);
    }
  }

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  const int kw = k0 + wg * mm::WG_ROWS;  // this warpgroup's first key
  const int c_lo = kw + warp * 16 + gq;   // keys of this thread: c_lo, + 8
  const uint32_t ks_u = mm::smem_u32(ks), vs_u = mm::smem_u32(vs);

  // the first tiles (and, on the slow path, K and V) are visible
  if (!vec) mm::fence_proxy_async();
  __syncthreads();
  if (vec && n_tiles > 0) mm::mbar_wait(mm::smem_u32(&kv_full), 0);
  for (int it = 0; it < n_tiles; ++it) {
    // every warp is done with tile it - 1, whose stage the next copy
    // overwrites (on the slow path the barrier also publishes tile it)
    if (it > 0) {
      if (!vec) mm::fence_proxy_async();
      __syncthreads();
    }
    const int nt = it + STAGES - 1;
    float2 ahead = make_float2(0.f, 0.f);
    if (nt < n_tiles) {
      load_rows_of(nt);
      if (tid < BM) ahead = row_values(nt);
    }
    const int st = it % STAGES;
    if (vec) mm::mbar_wait(mm::smem_u32(&full[st]), (it / STAGES) & 1);

    const int rt = tile_row(it);
    // some row of the tile sees this warpgroup's first key
    const bool sees = kw < skv_actual && (!causal || rt + BM - 1 + offset >= kw);
    if (sees) {
      const uint32_t qs_u = mm::smem_u32(ring + 2 * st * C::ROW_BYTES);
      const uint32_t dos_u = qs_u + C::ROW_BYTES;
      float s[32], dp[32];
      mm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mm::wgmma_ss_n64(s, mm::desc_kmajor(ks_u, BK, wg * mm::WG_ROWS, kk),
                         mm::desc_kmajor(qs_u, BM, 0, kk), kk > 0);
      mm::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mm::wgmma_ss_n64(dp, mm::desc_kmajor(vs_u, BK, wg * mm::WG_ROWS, kk),
                         mm::desc_kmajor(dos_u, BM, 0, kk), kk > 0);
      mm::wgmma_commit();
      // P^T while dP^T is still on the tensor cores
      mm::wgmma_wait<1>();
      mm::fence_regs(s);
      const bool need_mask = kw + mm::WG_ROWS > skv_actual ||
                             (causal && kw + mm::WG_ROWS - 1 > rt + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * cq + (i & 1);  // row rt + col
        float p = mm::fast_exp2(fmaf(s[i], scale_log2, -rowv[st][col].x));
        if (need_mask) {
          const int c = c_lo + 8 * ((i >> 1) & 1);
          p = (c < skv_actual && (!causal || c <= rt + col + offset)) ? p
                                                                      : 0.f;
        }
        s[i] = p;  // rounded by pack_a (:440)
      }
      mm::wgmma_wait<0>();
      mm::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * cq + (i & 1);
        dp[i] = s[i] * (dp[i] - rowv[st][col].y) * scale;  // ds (:450)
      }
      uint32_t pf[4][4], dsf[4][4];
      mm::pack_a(s, pf);
      mm::pack_a(dp, dsf);
      mm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mm::wgmma_rs_tb(dva, pf[kk], mm::desc_mnmajor(dos_u, BM, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mm::wgmma_rs_tb(dka, dsf[kk], mm::desc_mnmajor(qs_u, BM, kk));
      mm::wgmma_commit();
      mm::wgmma_wait<0>();
      mm::fence_regs(dva);
      mm::fence_regs(dka);
      mm::fence_frags(pf);
      mm::fence_frags(dsf);
    }
    if (nt < n_tiles && tid < BM) rowv[nt % STAGES][tid] = ahead;
  }
  // each warpgroup's K and V rows are read by its own products only
  mm::store_rows<BK, DP>(ks, wg * mm::WG_ROWS, dka, 1.f, 1.f,
                         dk + ((long)kv_head * Skv + kw) * D, D, Skv - kw, D,
                         vec, wg, tid_wg);
  mm::store_rows<BK, DP>(vs, wg * mm::WG_ROWS, dva, 1.f, 1.f,
                         dv + ((long)kv_head * Skv + kw) * D, D, Skv - kw, D,
                         vec, wg, tid_wg);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, int D, int sq_actual, int skv_actual,
              float scale_log2, float scale, int causal, cudaStream_t s) {
  using C = DqCfg<DP, 2>;
  auto kernel = flash_bwd_dq_kernel<DP, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap k_map = {}, v_map = {};
  if (D % 8 == 0) {
    int e = mm::make_kv_map(&k_map, k, D, skv_actual, Skv, B * Hkv, C::BN);
    if (e == 0)
      e = mm::make_kv_map(&v_map, v, D, skv_actual, Skv, B * Hkv, C::BN);
    if (e != 0) return e;
  }
  dim3 grid(Hq, (Sq + C::BM - 1) / C::BM, B);
  kernel<<<grid, mm::WG_THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), k_map, v_map,
      static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Hq, Hkv, Sq, Skv, D, sq_actual, skv_actual,
      scale_log2, scale, causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
               int skv_actual, float scale_log2, float scale, int causal,
               cudaStream_t s) {
  using C = DkvCfg<DP, 3>;
  auto kernel = flash_bwd_dkv_kernel<DP, 3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_map = {}, do_map = {}, k_map = {}, v_map = {};
  if (D % 8 == 0) {
    int e = mm::make_kv_map(&q_map, q, D, Sq, Sq, B * Hq, C::BM);
    if (e == 0) e = mm::make_kv_map(&do_map, dout, D, Sq, Sq, B * Hq, C::BM);
    if (e == 0)
      e = mm::make_kv_map(&k_map, k, D, skv_actual, Skv, B * Hkv, C::BK);
    if (e == 0)
      e = mm::make_kv_map(&v_map, v, D, skv_actual, Skv, B * Hkv, C::BK);
    if (e != 0) return e;
  }
  dim3 grid((Skv + C::BK - 1) / C::BK, Hkv, B);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), q_map,
      do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Hq, Hkv, Sq, Skv, D, sq_actual, skv_actual,
      scale_log2, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// K9a. scale = D^-0.5, scale_log2 = scale * log2 e. Head dims up to 64 use
// 64-wide tiles, up to 128 128-wide tiles.
extern "C" int a3_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int Hq,
                               int Hkv, int Sq, int Skv, int D, int sq_actual,
                               int skv_actual, float scale_log2, float scale,
                               int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,
                         D, sq_actual, skv_actual, scale_log2, scale, causal,
                         s);
  return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, D,
                        sq_actual, skv_actual, scale_log2, scale, causal, s);
}

// K9b: dk, dv per kv head, the GQA group summed. Head dims up to 64 use
// 64-wide tiles, up to 128 128-wide tiles.
extern "C" int a3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Hq, int Hkv, int Sq, int Skv, int D,
                                int sq_actual, int skv_actual,
                                float scale_log2, float scale, int causal,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                          Skv, D, sq_actual, skv_actual, scale_log2, scale,
                          causal, s);
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                         Skv, D, sq_actual, skv_actual, scale_log2, scale,
                         causal, s);
}
