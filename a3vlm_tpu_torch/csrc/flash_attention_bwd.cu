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
// K9b, what bounds it: the same products (8 D flops per pair), run here on
// the SIMT units far below the tensor-core rate; device memory is not the
// limit, since every staged tile is reused by 32 rows or keys from shared
// memory and no score leaves the SM. One block per (b, kv head, 32-key
// tile), 4 keys per warp; the block loops over the q heads of the GQA group
// and over 32-row query tiles (one row per lane) from the first row that
// can see the tile, so the group sum the TPU caller does over a
// [B, Hq, Skv, D] buffer (:615-617) happens in registers. wgmma for K9b's
// products is later work.

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = a3::AT_WARPS * 32;
constexpr int KPW = 4;                    // K9b: keys per warp
constexpr int KV_BK = a3::AT_WARPS * KPW; // K9b: keys per block
constexpr int KV_BQ = 32;                 // K9b: query rows per tile
constexpr int DMAX = a3::AT_DMAX;
constexpr int DPAD = DMAX + 1;            // row stride of lane-indexed tiles

constexpr size_t DKV_SMEM =
    sizeof(float) * (2 * KV_BQ * DPAD + 2 * KV_BK * DMAX);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
  mm::store_rows<C::BM, DP>(qs, 0, acc, 1.f, 1.f, dq + (row0 + q0) * D,
                            Sq - q0, D, vec, 0, tid);
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                     int D, int sq_actual, int skv_actual, float scale_log2,
                     float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [KV_BQ][DPAD], row j of the q tile
  float* dos = qs + KV_BQ * DPAD;    // [KV_BQ][DPAD]
  float* ks = dos + KV_BQ * DPAD;    // [KV_BK][DMAX], read as a broadcast
  float* vs = ks + KV_BK * DMAX;     // [KV_BK][DMAX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * KV_BK;
  const int group = Hq / Hkv;
  const long kv0 = ((long)b * Hkv + kvh) * Skv;
  const int offset = skv_actual - sq_actual;

  for (int i = tid; i < KV_BK * DMAX; i += THREADS) {
    const int j = i / DMAX, d = i % DMAX;
    float kv = 0.f, vv = 0.f;
    if (k0 + j < skv_actual && d < D) {
      kv = __bfloat162float(k[(kv0 + k0 + j) * D + d]);
      vv = __bfloat162float(v[(kv0 + k0 + j) * D + d]);
    }
    ks[i] = kv;
    vs[i] = vv;
  }

  float dka[KPW][NC], dva[KPW][NC];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dka[kk][cc] = dva[kk][cc] = 0.f;

  // a key tile gets gradient only from rows r >= c - offset (causal), and
  // none at all when it lies wholly in the padding
  const int r_begin = causal ? max(0, k0 - offset) : 0;
  const int rt_begin = k0 < skv_actual ? r_begin / KV_BQ * KV_BQ : Sq;
  const float* kw = ks + warp * KPW * DMAX;
  const float* vw = vs + warp * KPW * DMAX;

  for (int g = 0; g < group; ++g) {
    const long row0 = ((long)b * Hq + kvh * group + g) * Sq;
    for (int rt = rt_begin; rt < Sq; rt += KV_BQ) {
      __syncthreads();  // the previous tile (and, first time, ks/vs) settled
      for (int i = tid; i < KV_BQ * DMAX; i += THREADS) {
        const int j = i / DMAX, d = i % DMAX;
        float qv = 0.f, gv = 0.f;
        if (rt + j < Sq && d < D) {
          const long at = (row0 + rt + j) * D + d;
          qv = __bfloat162float(q[at]);
          gv = __bfloat162float(dout[at]);
        }
        qs[j * DPAD + d] = qv;
        dos[j * DPAD + d] = gv;
      }
      __syncthreads();

      const int r = rt + lane;
      const float l = r < Sq ? lse[row0 + r] : -INFINITY;
      const bool live = l > -INFINITY;
      const float l2 = live ? l * a3::AT_LOG2E : 0.f;
      const float dl = live ? delta[row0 + r] : 0.f;

      float s[KPW], dp[KPW];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) s[kk] = dp[kk] = 0.f;
      const float* qr = qs + lane * DPAD;
      const float* gr = dos + lane * DPAD;
      for (int d = 0; d < D; ++d) {
        const float qv = qr[d], gv = gr[d];
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          s[kk] = fmaf(qv, kw[kk * DMAX + d], s[kk]);
          dp[kk] = fmaf(gv, vw[kk * DMAX + d], dp[kk]);
        }
      }
      float pb[KPW], dsb[KPW];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        const int c = k0 + warp * KPW + kk;
        const bool ok = live && c < skv_actual && (!causal || c <= r + offset);
        const float p = ok ? exp2f(s[kk] * scale_log2 - l2) : 0.f;
        pb[kk] = bf16_round(p);
        dsb[kk] = bf16_round(p * (dp[kk] - dl) * scale);
      }

#pragma unroll 4
      for (int j = 0; j < KV_BQ; ++j) {
        float qj[NC], gj[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          qj[cc] = qs[j * DPAD + lane + 32 * cc];
          gj[cc] = dos[j * DPAD + lane + 32 * cc];
        }
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const float pj = __shfl_sync(0xffffffffu, pb[kk], j);
          const float dsj = __shfl_sync(0xffffffffu, dsb[kk], j);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            dva[kk][cc] = fmaf(pj, gj[cc], dva[kk][cc]);
            dka[kk][cc] = fmaf(dsj, qj[cc], dka[kk][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int c = k0 + warp * KPW + kk;
    if (c >= Skv) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) {
        dk[(kv0 + c) * D + d] = __float2bfloat16_rn(dka[kk][cc]);
        dv[(kv0 + c) * D + d] = __float2bfloat16_rn(dva[kk][cc]);
      }
    }
  }
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

template <int NC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
               int skv_actual, float scale_log2, float scale, int causal,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + KV_BK - 1) / KV_BK, Hkv, B);
  flash_bwd_dkv_kernel<NC><<<grid, THREADS, DKV_SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq, Hkv, Sq, Skv, D,
      sq_actual, skv_actual, scale_log2, scale, causal);
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

// K9b: dk, dv per kv head.
extern "C" int a3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Hq, int Hkv, int Sq, int Skv, int D,
                                int sq_actual, int skv_actual,
                                float scale_log2, float scale, int causal,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv<2>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                         Skv, D, sq_actual, skv_actual, scale_log2, scale,
                         causal, s);
  if (D <= 96)
    return launch_dkv<3>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                         Skv, D, sq_actual, skv_actual, scale_log2, scale,
                         causal, s);
  return launch_dkv<4>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Skv,
                       D, sq_actual, skv_actual, scale_log2, scale, causal, s);
}
