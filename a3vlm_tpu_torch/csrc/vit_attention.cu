// Non-causal attention for the vision towers, for Hopper (sm_90a), K10.
//
// Replaces a3vlm_tpu/ops/vit_attention.py::_kernel (reached through
// vit_attention). q, k, v are [B, S, H, D] bf16 read in place: rows lie
// ld elements apart (3W when they are the three views of one [B, S, 3W]
// projection, as the tower blocks make them), heads D apart, batches
// S * ld apart. o is [B, S, H, D] contiguous. The CLIP, EVA and DINOv2
// towers give S = 257 with (H, D) = (16, 64), (16, 88) and (24, 64), over
// 5 crops per image.
//
// What bounds it on an H100: bytes. Per (crop, head) the two products are
// 4 S^2 D flops on 4 S D bf16 of q, k, v and o (42 MB and 5.4 GFLOP at 20
// crops, H 16, D 64: 0.0126 ms of memory against 0.0055 ms of bf16 tensor
// cores), so q, k and v must be read once and the f32 scores must never
// leave the SM, which was the TPU kernel's point too. The design
// (attention_mma.cuh has the tiles, descriptors and fragment layouts):
// - a block holds K and V of one (crop, head) whole in shared memory,
//   ceil(S / 64) boxes of 64 keys each (320 keys, 80 KB at D 64 and 160 KB
//   at the 128-wide tile, for S 257), brought in once by the TMA straight
//   from the strided views, an mbarrier per 128 keys so the first products
//   start before the rest has landed; keys past S arrive as zeros;
// - each warpgroup walks 64-row query tiles (its Q tile a TMA box too):
//   S = Q K^T as wgmma m64n128k16 over shared-memory operands, an online
//   softmax in f32 on the accumulator layout, O += P V with P from
//   registers as a high and a low bf16 part (p_hi = bf16(p), p_lo =
//   bf16(p - p_hi), two products over the same V tile, as K2 carries it;
//   the TPU kernel rounds P to bf16 once, :44-46, which leaves outputs
//   that cancel near zero outside the plain version's bound) and V as an
//   MN-major B operand; the product of one 128-key chunk runs beside the
//   softmax of the next, as in K2. The ragged end (one key at S 257) takes
//   16-key steps (m64n16k16), the only masked ones;
// - D 88 takes the 128-wide tile with 6 k16 steps for S = Q K^T (KS), the
//   columns past D zero;
// - one block a (crop, head), its two warpgroups taking query tiles in
//   turn (at S 257 three and two, the fifth tile one row). Splitting a
//   (crop, head)'s tiles over several blocks, each with its own copy of K
//   and V, was measured at 5 crops and lost as often as it won, so the
//   grid is (head, crop);
// - the output leaves through the warpgroup's Q tile in 16-byte pieces.
// D % 8 != 0 or a row stride that is no multiple of 8 elements takes plain
// loads into the same tiles (the slow load path; same kernel).

#include "attention_mma.cuh"

namespace {

using namespace a3mma;

constexpr int NWG = 2;  // warpgroups a block
constexpr int BM = WG_ROWS * NWG;
constexpr int THREADS = WG_THREADS * NWG;
constexpr int BN = 128;  // keys of a chunk
constexpr int MAX_GROUPS = 8;  // 128-key barriers: S <= 1024

template <int DP>
constexpr int smem_bytes(int kv_rows) {
  return SWIZZLE_ALIGN + BM * DP * 2 + 2 * kv_rows * DP * 2;
}

template <int DP, int KS>
__global__ void __launch_bounds__(THREADS)
vit_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                bf16* __restrict__ o, int S, int H, int D, long ldq,
                long ldk, long ldv, int kv_rows, float scale_log2,
                int vec_i) {
  static_assert(KS * 16 <= DP, "k16 steps past the tile");
  constexpr int NS = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full[MAX_GROUPS];  // keys [128 g, +128)
  __shared__ __align__(8) uint64_t q_full[NWG];
  uint8_t* qs = align_smem(smem_raw);  // [BM][DP], 64 rows a warpgroup
  uint8_t* ks = qs + BM * DP * 2;      // [kv_rows][DP]
  uint8_t* vs = ks + kv_rows * DP * 2;

  const int tid = threadIdx.x;
  // warp-uniform for the compiler, so branches on it do not count as
  // divergent around the products
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int tid_wg = tid % WG_THREADS;
  const int warp = tid_wg >> 5, lane = tid_wg & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const bool vec = vec_i != 0;
  const int h = blockIdx.x, b = blockIdx.y;
  const int boxes = kv_rows / 64, groups = (boxes + 1) / 2;

  if (tid == 0) {
    for (int g = 0; g < groups; ++g) mbar_init(smem_u32(&kv_full[g]), 1);
#pragma unroll
    for (int w = 0; w < NWG; ++w) mbar_init(smem_u32(&q_full[w]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (vec) {
    if (tid == 0) {
      for (int g = 0; g < groups; ++g) {
        const uint32_t bar = smem_u32(&kv_full[g]);
        const int n = min(2, boxes - 2 * g);
        mbar_expect_tx(bar, n * 2 * 64 * DP * 2);
        for (int x = 2 * g; x < 2 * g + n; ++x) {
#pragma unroll
          for (int p = 0; p < DP / 64; ++p) {
            const int off = p * kv_rows * 128 + x * 64 * 128;
            tma_load_4d(smem_u32(ks) + off, &k_map, bar, 64 * p, h, 64 * x, b);
            tma_load_4d(smem_u32(vs) + off, &v_map, bar, 64 * p, h, 64 * x, b);
          }
        }
      }
    }
  } else {
    load_rows<DP>(ks, kv_rows, 0, kv_rows, k + (long)b * S * ldk + h * D,
                  ldk, S, D, tid, THREADS);
    load_rows<DP>(vs, kv_rows, 0, kv_rows, v + (long)b * S * ldv + h * D,
                  ldv, S, D, tid, THREADS);
    fence_proxy_async();
    __syncthreads();
  }
  auto wait_keys = [&](int key) {
    if (vec) mbar_wait(smem_u32(&kv_full[key / BN]), 0);
  };

  const uint32_t qs_u = smem_u32(qs), ks_u = smem_u32(ks), vs_u = smem_u32(vs);
  const int n_full = S / BN;  // whole 128-key chunks; then 16-key steps
  const int n_qt = (S + WG_ROWS - 1) / WG_ROWS;
  uint32_t q_phase = 0;
  for (int qt = wg; qt < n_qt; qt += NWG) {
    const int row0 = qt * WG_ROWS;
    if (vec) {
      if (tid_wg == 0) {
        const uint32_t bar = smem_u32(&q_full[wg]);
        mbar_expect_tx(bar, WG_ROWS * DP * 2);
#pragma unroll
        for (int p = 0; p < DP / 64; ++p)
          tma_load_4d(qs_u + p * BM * 128 + wg * WG_ROWS * 128, &q_map, bar,
                      64 * p, h, row0, b);
      }
      mbar_wait(smem_u32(&q_full[wg]), q_phase);
      q_phase ^= 1;
    } else {
      load_rows<DP>(qs, BM, wg * WG_ROWS, WG_ROWS,
                    q + ((long)b * S + row0) * ldq + h * D, ldq, S - row0, D,
                    tid_wg, WG_THREADS);
      fence_proxy_async();
      warpgroup_sync(wg);
    }

    const int r_lo = row0 + warp * 16 + gq;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float alpha[2];
    float acc[DP / 2], s[NS];
    uint32_t p[NS / 8][4], p_lo[NS / 8][4];  // P's high and low parts
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    auto scores = [&](int c) {  // S = Q K_c^T, issued, not waited for
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss_n128(s, desc_kmajor(qs_u, BM, wg * WG_ROWS, kk),
                      desc_kmajor(ks_u, kv_rows, c * BN, kk), kk > 0);
      wgmma_commit();
    };
    auto values = [&](int c) {  // O += P V_c, issued, not waited for
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb(acc, p[kk], desc_mnmajor(vs_u, kv_rows, c * BN / 16 + kk));
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb(acc, p_lo[kk],
                    desc_mnmajor(vs_u, kv_rows, c * BN / 16 + kk));
      wgmma_commit();
    };

    if (n_full > 0) {
      wait_keys(0);
      wgmma_fence();
      scores(0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m_i, l_i, alpha, 0, r_lo, cq, 0, S, false, false,
                   scale_log2);
      pack_a_split(s, p, p_lo);
    }
    for (int c = 1; c < n_full; ++c) {
      wait_keys(c * BN);
      wgmma_fence();
      scores(c);
      values(c - 1);
      wgmma_wait<1>();
      fence_regs(s);
      softmax_tile(s, m_i, l_i, alpha, c * BN, r_lo, cq, 0, S, false, false,
                   scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(p);
      fence_frags(p_lo);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_a_split(s, p, p_lo);
    }
    if (n_full > 0) {
      wgmma_fence();
      values(n_full - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(p);
      fence_frags(p_lo);
    }
    // the ragged end, 16 keys a step; keys past S are masked
    for (int kt = n_full * BN; kt < S; kt += 16) {
      wait_keys(kt);
      float t[8];
      uint32_t pt[1][4], pt_lo[1][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss_n16(t, desc_kmajor(qs_u, BM, wg * WG_ROWS, kk),
                     desc_kmajor(ks_u, kv_rows, kt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
      softmax_tile(t, m_i, l_i, alpha, kt, r_lo, cq, 0, S, false, kt + 16 > S,
                   scale_log2);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_a_split(t, pt, pt_lo);
      wgmma_fence();
      wgmma_rs_tb(acc, pt[0], desc_mnmajor(vs_u, kv_rows, kt / 16));
      wgmma_rs_tb(acc, pt_lo[0], desc_mnmajor(vs_u, kv_rows, kt / 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pt);
      fence_frags(pt_lo);
    }

    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float l = quad_sum(l_i[hh]);
      inv[hh] = 1.f / (l == 0.f ? 1.f : l);
    }
    store_rows<BM, DP>(qs, wg * WG_ROWS, acc, inv[0], inv[1],
                       o + (((long)b * S + row0) * H + h) * D, (long)H * D,
                       S - row0, D, (D & 7) == 0, wg, tid_wg);
    // every thread of the warpgroup has read its Q tile out before the
    // next tile is copied over it
    fence_proxy_async();
    warpgroup_sync(wg);
  }
}

template <int DP, int KS>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int D, long ldq, long ldk, long ldv, float scale_log2,
           cudaStream_t s) {
  auto kernel = vit_attn_kernel<DP, KS>;
  const int kv_rows = (S + 63) / 64 * 64;
  const int smem = smem_bytes<DP>(kv_rows);
  if (kv_rows > MAX_GROUPS * BN) return (int)cudaErrorInvalidValue;
  // the attribute is raised once per instantiation, not on every launch
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // too large for a block: refused, not sticky
      return (int)err;
    }
    smem_set = smem;
  }
  const bool vec = D % 8 == 0 && ldq % 8 == 0 && ldk % 8 == 0 &&
                   ldv % 8 == 0 && (reinterpret_cast<uintptr_t>(q) |
                                    reinterpret_cast<uintptr_t>(k) |
                                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  CUtensorMap q_map = {}, k_map = {}, v_map = {};
  if (vec) {
    int e = make_bshd_map(&q_map, q, B, S, H, D, ldq, WG_ROWS);
    if (e == 0) e = make_bshd_map(&k_map, k, B, S, H, D, ldk, 64);
    if (e == 0) e = make_bshd_map(&v_map, v, B, S, H, D, ldv, 64);
    if (e != 0) return e;
  }
  dim3 grid(H, B);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), q_map, k_map, v_map, static_cast<bf16*>(o),
      S, H, D, ldq, ldk, ldv, kv_rows, scale_log2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// ld* are the row strides of q, k and v in elements. K and V of one (crop,
// head) and the block's Q tiles must fit a block's shared memory
// (S <= 832 at D <= 64, <= 384 at D <= 128); a larger S is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int a3_vit_attention(const void* q, const void* k, const void* v,
                                void* o, int B, int S, int H, int D, long ldq,
                                long ldk, long ldv, float scale_log2,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64, 4>(q, k, v, o, B, S, H, D, ldq, ldk, ldv,
                         scale_log2, s);
  if (D <= 96)
    return launch<128, 6>(q, k, v, o, B, S, H, D, ldq, ldk, ldv,
                          scale_log2, s);
  return launch<128, 8>(q, k, v, o, B, S, H, D, ldq, ldk, ldv,
                        scale_log2, s);
}
