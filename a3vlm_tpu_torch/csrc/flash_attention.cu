// Causal flash-attention forward for Hopper (sm_90a), K2.
//
// Replaces a3vlm_tpu/ops/flash_attention.py::_flash_kernel (reached through
// flash_attention_bhsd). q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] bf16 ->
// o [B, Hq, Sq, D] bf16, with the right-aligned causal mask over the actual
// lengths (row r sees key c iff c < skv_actual and
// r - sq_actual >= c - skv_actual) and GQA as kv_head = h / (Hq / Hkv). A
// row with no visible key writes zeros. Training also asks for the
// natural-log log-sum-exp of each row's scaled scores (the TPU kernel's
// ``return_lse``, flash_attention.py:184-187), which the backward kernels
// (flash_attention_bwd.cu) consume: ``lse`` [B, Hq, Sq] f32 (-inf for an
// empty row), written when the pointer is not null. Serving passes null.
//
// What bounds it on an H100: operations. The two products are 4 D flops per
// visible (row, key) pair (90.6 GFLOP at the decoder prefill, B 4, H 40,
// S 1487, D 128) against 122 MB of q, k, v and o, so the card's bf16
// tensor-core rate sets the floor ten times above its memory rate. The
// design is therefore about keeping the tensor cores fed (attention_mma.cuh
// has the tile layout, the descriptors and the fragment layouts):
// - both products run as wgmma over 128-key tiles, m64n128k16 for
//   S = Q K^T with both operands read from shared memory and m64nDk16 for
//   O += P V with P as the A operand in registers: P goes from the S
//   accumulator to A fragments without leaving the registers. K tiles are
//   K-major B operands as they lie, V tiles MN-major ones through the
//   transpose flag. P enters the value product as a high and a low part,
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), two products over the same V
//   tile, so the weights keep ~16 bits where the TPU kernel rounds them to
//   bf16 (:148): with 8 bits, a few near-zero outputs of a long row (1500
//   keys) left the bound the plain f32 version is held to. The row sum
//   adds the f32 weights. (With
//   64-key tiles the n = 64 products read as many bytes of A as of B and
//   shared memory could not feed them; Q in registers cured that but cost
//   the registers the wider tile needs, and the wider tile was faster.)
// - a block owns 64 * NWG query rows (one warpgroup per 64) and streams K
//   and V as bf16 tiles through a ring of STAGES stages. One thread asks
//   the TMA for a tile's boxes (tensor maps encoded per call on the host,
//   128-byte swizzle, rows past skv_actual zero-filled) and an mbarrier per
//   stage reports their arrival, so no thread spends instructions or stalls
//   on the copy; a copy is in flight while the tile before it is worked on.
//   One __syncthreads per tile frees a stage. (A first version filled the
//   ring with cp.async from all threads and spent a large part of each
//   tile's time issuing the copies.)
// - S of tile i and O += P V of tile i - 1 are issued together, and the
//   softmax of tile i runs as soon as S is there, beside the second product.
//   P is packed into its A fragments only after that product has retired:
//   defining them earlier makes ptxas serialize the products (C7513);
// - the softmax stays in registers on the accumulator layout, in base 2 and
//   f32: the row maximum and sum are shared by a quad (two shuffles), the
//   scale is folded into the exponent (one FFMA and one ex2 per score), the
//   row sum is kept per lane and reduced once at the end;
// - only the tiles the diagonal or the ragged end crosses are masked, the
//   key loop stops at the causal limit of the block's last row, and a
//   warpgroup skips a tile that lies wholly above its own rows;
// - launch order: within a batch element every head's heaviest query tile
//   comes first (grid x = head, y = query tile from the last one down,
//   z = batch), so no long block starts late, while one element's K and V
//   (30 MB at S 1487, 42 MB at S 2048) stay in L2 for all its tiles; against
//   head-major order this helps most at batch 1;
// - the output leaves through the block's Q tile in shared memory, so the
//   stores to device memory are whole 16-byte pieces of a row.
// Head dims up to 64 use 64-wide tiles, up to 128 128-wide tiles, the
// columns past D zero. Where D % 8 != 0 a row is no multiple of 16 bytes,
// which TMA and cp.async need: the same kernel then fills its tiles with
// plain loads from all threads (the slow load path; no second route).

#include "attention_mma.cuh"

namespace {

using namespace a3mma;

template <int DP, int NWG, int STAGES>
struct FwdCfg {
  static constexpr int BM = WG_ROWS * NWG;
  static constexpr int BN = 128;  // keys per tile
  static constexpr int NS = BN / 2;  // scores of a tile that a thread holds
  static constexpr int THREADS = WG_THREADS * NWG;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int SMEM = SWIZZLE_ALIGN + Q_BYTES + STAGES * 2 * KV_BYTES;
};

template <int DP, int NWG, int STAGES>
__global__ void __launch_bounds__(WG_THREADS * NWG)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 bf16* __restrict__ o, float* __restrict__ lse, int Hq,
                 int Hkv, int Sq, int Skv, int D, int sq_actual,
                 int skv_actual, float scale_log2, int causal_i) {
  static_assert(STAGES >= 3, "K of tile i and V of tile i - 1 are both live");
  using C = FwdCfg<DP, NWG, STAGES>;
  constexpr int BN = C::BN, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];  // tile t's bytes landed
  uint8_t* qs = align_smem(smem_raw);
  uint8_t* ring = qs + C::Q_BYTES;  // tile t: K at 2 (t % STAGES), V after it

  const int tid = threadIdx.x;
  // the shuffle tells the compiler that a warp agrees on its warpgroup, so
  // that branches on it do not count as divergent around the products
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int tid_wg = tid % WG_THREADS;
  const int warp = tid_wg >> 5, lane = tid_wg & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const bool causal = causal_i != 0;
  const bool vec = (D & 7) == 0;  // TMA and 16-byte copies; else plain loads

  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // heaviest first
  const int h = blockIdx.x, b = blockIdx.z;
  const long row0 = ((long)b * Hq + h) * Sq;
  const int kv_head = b * Hkv + h / (Hq / Hkv);
  const int offset = skv_actual - sq_actual;
  const int kv_end = visible_end(q0, C::BM, Sq, skv_actual, offset, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Tile t into its stage: one thread asks the TMA for the K and V boxes
  // (rows past skv_actual arrive as zeros), or, on the slow path, all
  // threads fill the stage with plain loads before the next barrier.
  auto load_kv = [&](int t) {
    uint8_t* dst = ring + (2 * (t % STAGES)) * C::KV_BYTES;
    if (vec) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&full[t % STAGES]);
        mbar_expect_tx(bar, 2 * C::KV_BYTES);
        tma_load_tile<BN, DP>(dst, &k_map, bar, t * BN, kv_head);
        tma_load_tile<BN, DP>(dst + C::KV_BYTES, &v_map, bar, t * BN,
                              kv_head);
      }
    } else {
      const long at = ((long)kv_head * Skv + (long)t * BN) * D;
      load_tile<BN, DP, C::THREADS>(dst, k + at, skv_actual - t * BN, D,
                                    false, tid);
      load_tile<BN, DP, C::THREADS>(dst + C::KV_BYTES, v + at,
                                    skv_actual - t * BN, D, false, tid);
    }
  };
  auto wait_kv = [&](int t) {
    if (vec) mbar_wait(smem_u32(&full[t % STAGES]), (t / STAGES) & 1);
  };

  load_tile<C::BM, DP, C::THREADS>(qs, q + (row0 + q0) * D, Sq - q0, D, vec,
                                   tid);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t)
    if (t < n_tiles) load_kv(t);

  // rows of this thread: r_lo and r_lo + 8. The warpgroup visits tiles
  // [0, n_wg): a tile wholly above its last row adds nothing to it.
  const int wg_row0 = q0 + wg * WG_ROWS;
  const int r_lo = wg_row0 + warp * 16 + gq;
  const int wg_last = wg_row0 + WG_ROWS - 1 + offset;  // last visible key
  const int n_wg =
      !causal ? n_tiles : (wg_last < 0 ? 0 : min(n_tiles, wg_last / BN + 1));
  float m_i[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l_i[2] = {0.f, 0.f};              // this lane's share of the row sum
  float alpha[2];
  float acc[DP / 2], s[NS];
  uint32_t p[NS / 8][4], p_lo[NS / 8][4];  // P's high and low parts
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  const uint32_t qs_u = smem_u32(qs), ring_u = smem_u32(ring);
  auto k_tile = [&](int t) { return ring_u + (2 * (t % STAGES)) * C::KV_BYTES; };
  auto masked = [&](int kt) {
    return kt + BN > skv_actual || (causal && kt + BN - 1 > wg_row0 + offset);
  };
  auto scores = [&](int t) {  // S = Q K_t^T, issued, not waited for
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wgmma_ss_n128(s, desc_kmajor(qs_u, C::BM, wg * WG_ROWS, ks),
                    desc_kmajor(k_tile(t), BN, 0, ks), ks > 0);
    wgmma_commit();
  };
  auto values = [&](int t) {  // O += (P_hi + P_lo) V_t, issued, not waited for
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb(acc, p[kk], desc_mnmajor(k_tile(t) + C::KV_BYTES, BN, kk));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb(acc, p_lo[kk], desc_mnmajor(k_tile(t) + C::KV_BYTES, BN, kk));
    wgmma_commit();
  };
  auto fence_p = [&] {
    fence_frags(p);
    fence_frags(p_lo);
  };

  // Q (and, on the slow path, the first tiles) has landed and is visible
  // to the products
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  if (n_wg > 0) {
    wait_kv(0);
    wgmma_fence();
    scores(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m_i, l_i, alpha, 0, r_lo, cq, offset, skv_actual, causal,
                 masked(0), scale_log2);
    pack_a_split(s, p, p_lo);
  }
  for (int it = 1; it < n_tiles; ++it) {
    // tile ``it`` has landed (waited for here, where the wait hides behind
    // the barrier), and every warpgroup is done with tile it - 2, whose
    // stage the next copy overwrites (on the slow path the barrier also
    // publishes tile it)
    if (it < n_wg) wait_kv(it);
    if (!vec) fence_proxy_async();
    __syncthreads();
    if (it + STAGES - 2 < n_tiles) load_kv(it + STAGES - 2);
    if (it < n_wg) {
      // S of this tile and O += P V of the previous one run on the tensor
      // cores while the softmax of this tile runs beside the second; the
      // weights become A fragments only once the previous ones are free
      wgmma_fence();
      scores(it);
      values(it - 1);
      wgmma_wait<1>();
      fence_regs(s);
      softmax_tile(s, m_i, l_i, alpha, it * BN, r_lo, cq, offset, skv_actual,
                   causal, masked(it * BN), scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_a_split(s, p, p_lo);
    } else if (it == n_wg && n_wg > 0) {
      wgmma_fence();
      values(it - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p();
    }
  }
  if (n_wg == n_tiles && n_wg > 0) {
    wgmma_fence();
    values(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_p();
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = quad_sum(l_i[hh]);
    inv[hh] = 1.f / (l == 0.f ? 1.f : l);
    const int r = r_lo + 8 * hh;
    if (lse != nullptr && cq == 0 && r < Sq)
      lse[row0 + r] =
          l == 0.f ? -INFINITY : m_i[hh] * scale_log2 * LN2 + logf(l);
  }
  // (the block's last warpgroup visits every tile, so no copy into the
  // ring is in flight once it gets here)
  store_rows<C::BM, DP>(qs, wg * WG_ROWS, acc, inv[0], inv[1],
                        o + (row0 + wg_row0) * D, D, Sq - wg_row0, D, vec, wg,
                        tid_wg);
}

template <int DP, int NWG, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
           int skv_actual, float scale_log2, int causal, cudaStream_t s) {
  using C = FwdCfg<DP, NWG, STAGES>;
  auto kernel = flash_fwd_kernel<DP, NWG, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap k_map = {}, v_map = {};
  if (D % 8 == 0) {
    int e = make_kv_map(&k_map, k, D, skv_actual, Skv, B * Hkv, C::BN);
    if (e == 0) e = make_kv_map(&v_map, v, D, skv_actual, Skv, B * Hkv, C::BN);
    if (e != 0) return e;
  }
  dim3 grid(Hq, (Sq + C::BM - 1) / C::BM, B);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), k_map, v_map, static_cast<bf16*>(o),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, D, sq_actual, skv_actual,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// ``lse`` may be null (serving); otherwise [B, Hq, Sq] f32. A block is two
// warpgroups, 128 query rows that share every K and V tile.
extern "C" int a3_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Hq, int Hkv,
                            int Sq, int Skv, int D, int sq_actual,
                            int skv_actual, float scale_log2, int causal,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64, 2, 3>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                            sq_actual, skv_actual, scale_log2, causal, s);
  return launch<128, 2, 3>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, sq_actual,
                           skv_actual, scale_log2, causal, s);
}
