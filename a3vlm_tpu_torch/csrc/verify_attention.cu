// Multi-token verify attention over the decode cache for Hopper (sm_90a),
// K5 and K5q: a window of `span` query tokens (2..16, the speculative
// draft) attends over the cache, causal within the window.
//
// Replaces a3vlm_tpu/ops/decode_attention.py::_verify_kernel_blocked
// (reached through verify_attention) and ::_verify_kernel_blocked_q8
// (verify_attention_quant). q [B, span, Hq, D] bf16, read in place: query
// row r = g * span + i of kv head h is q[b, i, h * G + g] (G = Hq / Hkv,
// R = G * span rows a head). Caches [B, Hkv, S, D] bf16, or int8 with f32
// scales [B, Hkv, S]; valid [B] int32 counts the populated prefix, window
// included. Row r sees cache columns < valid[b] - span + 1 + (r % span).
// out [B, span, Hq, D] bf16, the caller's layout. The int8 form multiplies
// the scores by the key scale per column and the weights by the value
// scale, and sums each row's total over the weights alone, as the TPU
// kernel does. A row with no visible column gives zeros. D == 128.
//
// What bounds it on an H100: bytes, the cache rows below valid[b], each
// read once for all R rows of its head. The design:
// - the products run turned around, so that the R = 8 to 16 query rows of
//   the latency path are a product's N and not padding of its M = 64:
//   S^T = K Q^T with the tile's 64 keys as M, then O^T += V^T P^T with the
//   head's 128 dims as M (two halves; V read MN-major through the
//   transpose flag), both wgmma m64nNk16 with N = 8, 16, 32 or 64 (query
//   rows; R > 64 takes more blocks). The softmax runs in base 2 and f32 on
//   the accumulator layout: a query row is a column, its maximum over a
//   tile is taken across the warpgroup (shuffles, then shared memory);
// - P goes to shared memory as the B operand of the second product, as a
//   high and a low part (hi + lo, two products), so the weights keep ~16
//   bits: the TPU kernel rounds them to bf16, but at 16 live rows of 64 the
//   f32 plain version then sat at the edge of its bound on long rows;
// - split-KV sized to the card: the grid is (splits x row groups, Hkv, B),
//   the split count the most whole-tile runs whose blocks fit the card in
//   one wave (a3_verify_slots: resident blocks per SM x SMs); each query
//   row leaves a (max, sum, acc) partial per split for
//   verify_combine_kernel, or, with one split, the block writes the output
//   itself. A split that starts at or past valid[b] loads nothing;
// - one thread asks the TMA for a tile's K and V boxes ([64 keys][128],
//   rank-3 map over [B * Hkv, S, D], 128-byte swizzle; rows past S arrive
//   as zeros) into a ring of three stages, an mbarrier each; the query rows
//   come in once by cp.async;
// - int8 (K5q): the boxes are 128 bytes x 64 rows, one int8 row a swizzle
//   row. K never becomes a tile: each thread builds its bf16 A fragments
//   of S^T from the box's bytes in registers (exact: the byte under the
//   exponent of 2^23, no integer conversion). V becomes an fp16 tile for
//   the second product (1024 + u less 1152, exact; two instructions a
//   pair), with P times the value scale in fp16 high and low parts: a
//   third of the instructions and shared-memory traffic of a bf16 tile of
//   both, measured to be what bounded this form (values must stay below
//   fp16's 65504 as weights times scales, that is value scales below it);
// - the last tile of a block may hold rows at or past valid[b] (the box is
//   64 rows): their scores are masked before the maximum, the bf16 form
//   zeroes those rows of its V tile and the int8 form reads no scale
//   there, so no value past the window can reach the output.

#include <cuda_fp16.h>

#include "attention_mma.cuh"

namespace {

using namespace a3mma;

constexpr int VD = 128;                 // head dim
constexpr int VBN = 64;                 // keys per tile
constexpr int V_TILE = VBN * VD * 2;    // bf16 [64][128] tile, two panels
constexpr int V_RAW = VBN * VD;         // int8 [64][128] box

#define VF_ACC4(d, o) \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
#define VF_ACC8(d, o) VF_ACC4(d, o), VF_ACC4(d, o + 4)
#define VF_COMMA ,
#define VF_ACC32(d) \
  VF_ACC8(d, 0), VF_ACC8(d, 8), VF_ACC8(d, 16), VF_ACC8(d, 24)

// d (+)= A B^T, m64nNk16 from shared memory, bf16 or (F16) fp16: A
// K-major, or MN-major through the transpose flag (TA = 1: A [k][m] as it
// lies); B K-major. N = 8, 16, 32 or 64.
#define VF_SS(NS, TY, REGS, OUT, PA, PB, PC, PT)                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PC ", 0;\n"        \
               "wgmma.mma_async.sync.aligned.m64n" NS "k16.f32." TY "." \
               TY " {" REGS "}, " PA ", " PB ", p, 1, 1, " PT ", 0;\n}\n" \
               : OUT                                                   \
               : "l"(da), "l"(db), "r"(accumulate), "n"(TA))
#define VF_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define VF_R16 VF_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define VF_R32                                                          \
  VF_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"

template <int N, int TA, bool F16 = false>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (N == 8) {
    if constexpr (F16)
      VF_SS("8", "f16", "%0, %1, %2, %3", VF_ACC4(d, 0), "%4", "%5", "%6",
            "%7");
    else
      VF_SS("8", "bf16", "%0, %1, %2, %3", VF_ACC4(d, 0), "%4", "%5", "%6",
            "%7");
  } else if constexpr (N == 16) {
    if constexpr (F16)
      VF_SS("16", "f16", VF_R8, VF_ACC8(d, 0), "%8", "%9", "%10", "%11");
    else
      VF_SS("16", "bf16", VF_R8, VF_ACC8(d, 0), "%8", "%9", "%10", "%11");
  } else if constexpr (N == 32) {
    if constexpr (F16)
      VF_SS("32", "f16", VF_R16, VF_ACC8(d, 0) VF_COMMA VF_ACC8(d, 8), "%16",
            "%17", "%18", "%19");
    else
      VF_SS("32", "bf16", VF_R16, VF_ACC8(d, 0) VF_COMMA VF_ACC8(d, 8), "%16",
            "%17", "%18", "%19");
  } else {
    static_assert(N == 64, "N");
    if constexpr (F16)
      VF_SS("64", "f16", VF_R32, VF_ACC32(d), "%32", "%33", "%34", "%35");
    else
      VF_SS("64", "bf16", VF_R32, VF_ACC32(d), "%32", "%33", "%34", "%35");
  }
}

// d (+)= A B^T, m64nNk16 over bf16, A (16 columns) from registers, B from
// shared memory K-major. N = 8, 16, 32 or 64.
#define VF_RS(NS, REGS, OUT, PA, PB, PC)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PC ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" NS                      \
               "k16.f32.bf16.bf16 {" REGS "}, {" PA "}, " PB               \
               ", p, 1, 1, 0;\n}\n"                                        \
               : OUT                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(accumulate))

template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  if constexpr (N == 8)
    VF_RS("8", "%0, %1, %2, %3", VF_ACC4(d, 0), "%4, %5, %6, %7", "%8",
          "%9");
  else if constexpr (N == 16)
    VF_RS("16", VF_R8, VF_ACC8(d, 0), "%8, %9, %10, %11", "%12", "%13");
  else if constexpr (N == 32)
    VF_RS("32", VF_R16, VF_ACC8(d, 0) VF_COMMA VF_ACC8(d, 8),
          "%16, %17, %18, %19", "%20", "%21");
  else
    VF_RS("64", VF_R32, VF_ACC32(d), "%32, %33, %34, %35", "%36", "%37");
}

#undef VF_SS
#undef VF_RS
#undef VF_R8
#undef VF_R16
#undef VF_R32
#undef VF_ACC32
#undef VF_COMMA
#undef VF_ACC8
#undef VF_ACC4

// Two int8 values (the low bytes of lo and hi) as a bf16 pair, exact:
// each goes under the exponent of 2^23 by a byte permute and one f32
// subtraction leaves it; a small integer's bf16 is its f32's upper half.
__device__ __forceinline__ uint32_t i8pair_bf16(uint32_t lo, uint32_t hi) {
  const float a =
      __uint_as_float(__byte_perm(lo ^ 0x80u, 0x4B000000u, 0x7440)) -
      8388736.f;  // 2^23 + 128
  const float b =
      __uint_as_float(__byte_perm(hi ^ 0x80u, 0x4B000000u, 0x7440)) -
      8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Four int8 values (a word) as two fp16 pairs, exact: 1024 + (v + 128)
// by one byte permute each, less 1152.
__device__ __forceinline__ void i8x4_f16(uint32_t x, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  const uint32_t c = 0x64806480u;  // fp16 1152, twice
  const uint32_t p0 = __byte_perm(u, 0x64646464u, 0x4140);
  const uint32_t p1 = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 r0 = __hsub2(*reinterpret_cast<const __half2*>(&p0),
                             *reinterpret_cast<const __half2*>(&c));
  const __half2 r1 = __hsub2(*reinterpret_cast<const __half2*>(&p1),
                             *reinterpret_cast<const __half2*>(&c));
  lo = *reinterpret_cast<const uint32_t*>(&r0);
  hi = *reinterpret_cast<const uint32_t*>(&r1);
}

// A block is one warpgroup over NR query rows (8, 16, 32 or 64; the R rows
// of a head, or 64 of them when R > 64). The ring fills about a third
// (int8) or half (bf16) of the shared memory, so that three or two blocks
// share an SM.
template <bool QUANT, int NR>
struct VfyCfg {
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = NR * VD * 2;   // [NR][128], two panels
  static constexpr int STAGE_BYTES = QUANT ? 2 * V_RAW : 2 * V_TILE;
  static constexpr int V16_BYTES = QUANT ? V_TILE : 0;  // int8: V in fp16
  static constexpr int P_BYTES = NR * VBN * 2;  // [NR][64], one panel
  static constexpr int SMEM = SWIZZLE_ALIGN + Q_BYTES + STAGES * STAGE_BYTES +
                              V16_BYTES + 2 * P_BYTES;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// Accumulator layout of the two products (attention_mma.cuh's, with the
// roles turned): thread (warp w, g = lane / 4, c = lane % 4) holds element
// 4 j + e at M index 16 w + g + 8 (e / 2) (a key of S^T, a dim of a half of
// O^T) and N index 8 j + 2 c + e % 2 (a query row); NR / 4 query rows a
// thread, shared by the 8 g lanes of the 4 warps. The A fragments of the
// int8 form follow the same rows: K's keys 16 w + g (+ 8) and columns
// 16 kk + 2 c (+ 1, + 8, + 9); V^T's dims and keys likewise.
template <bool QUANT, int NR>
__global__ void __launch_bounds__(WG_THREADS)
verify_mma_kernel(const bf16* __restrict__ q,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const int* __restrict__ valid, float* __restrict__ part,
                  bf16* __restrict__ out, int Hkv, int G, int span, int S,
                  int tps, int P, float scale_log2) {
  using C = VfyCfg<QUANT, NR>;
  constexpr int ST = C::STAGES, NC = NR / 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];  // tile t's boxes landed
  __shared__ float red[4][NR];    // a value per warp and query row
  uint8_t* qs = align_smem(smem_raw);
  uint8_t* ring = qs + C::Q_BYTES;  // tile t: stage t % ST, K then V
  uint8_t* v16 = ring + ST * C::STAGE_BYTES;  // int8: the tile's V, fp16
  uint8_t* ps = v16 + C::V16_BYTES;  // P^T as B tiles: high, then low part

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int sp = blockIdx.x % P, rg = blockIdx.x / P;
  const int h = blockIdx.y, b = blockIdx.z;
  const int R = G * span, Hq = Hkv * G;
  const int head = b * Hkv + h;
  const int v_raw = valid[b];
  const int v_b = min(v_raw, S);  // cache rows the window may see
  const int t0 = sp * tps;
  // tiles of this split that hold a column below valid[b]
  const int n = max(min(min(t0 + tps, (S + VBN - 1) / VBN),
                        (max(v_b, 0) + VBN - 1) / VBN) - t0, 0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int it) {  // issued by thread 0
    uint8_t* dst = ring + (it % ST) * C::STAGE_BYTES;
    const uint32_t bar = smem_u32(&full[it % ST]);
    const int row = (t0 + it) * VBN;
    mbar_expect_tx(bar, C::STAGE_BYTES);
    if (QUANT) {
      tma_load_3d(smem_u32(dst), &k_map, bar, 0, row, head);
      tma_load_3d(smem_u32(dst) + V_RAW, &v_map, bar, 0, row, head);
    } else {
      tma_load_tile<VBN, VD>(dst, &k_map, bar, row, head);
      tma_load_tile<VBN, VD>(dst + V_TILE, &v_map, bar, row, head);
    }
  };

  const uint32_t qs_u = smem_u32(qs), ps_u = smem_u32(ps);
  const uint32_t v16_u = smem_u32(v16);
  if (n > 0) {
    if (tid == 0)
      for (int it = 0; it < ST && it < n; ++it) load_kv(it);
    // the block's query rows, rows >= R as zeros
    for (int i = tid; i < NR * (VD / 8); i += WG_THREADS) {
      const int rl = i / (VD / 8), c = i % (VD / 8);
      const int r = rg * NR + rl;
      const bool ok = r < R;
      const bf16* src =
          q + ((long)(b * span + r % span) * Hq + h * G + r / span) * VD +
          c * 8;
      cp_async16(qs_u + tile_offset(NR, rl, c), ok ? src : q, ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // this thread's query rows (columns 2 j + e1 of its state) see cache
  // columns < thr; its keys are key_lo and key_lo + 8 of each tile
  int thr[NC];
#pragma unroll
  for (int j = 0; j < NR / 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1)
      thr[2 * j + e1] = min(
          v_raw - span + 1 + (rg * NR + 8 * j + 2 * cq + e1) % span, S);
  const int thr_min = min(v_raw - span + 1, S);  // row i = 0's: the least
  const int key_lo = 16 * warp + gq;
  // int8: the key and value scales of this thread's two keys of a tile,
  // zero from valid[b] on (so no scale past the window is read), loaded a
  // tile ahead
  auto scales_of = [&](int it, float (&sc)[4]) {
    const long at = (long)head * S + (t0 + it) * VBN + key_lo;
    const bool ok0 = (t0 + it) * VBN + key_lo < v_b;
    const bool ok1 = (t0 + it) * VBN + key_lo + 8 < v_b;
    sc[0] = ok0 ? ks[at] : 0.f;
    sc[1] = ok1 ? ks[at + 8] : 0.f;
    sc[2] = ok0 ? vs[at] : 0.f;
    sc[3] = ok1 ? vs[at + 8] : 0.f;
  };
  float sc_next[4] = {0.f, 0.f, 0.f, 0.f};
  if (QUANT && n > 0) scales_of(0, sc_next);
  float m_c[NC], l_c[NC];  // running max of the raw scores; this lane's sum
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    m_c[c] = -INFINITY;
    l_c[c] = 0.f;
  }
  float st[NR / 2], ot[2][NR / 2];  // S^T of a tile; O^T, dims 0-63, 64-127
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) ot[0][i] = ot[1][i] = 0.f;

  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  for (int it = 0; it < n; ++it) {
    const int kt = (t0 + it) * VBN;
    uint8_t* stage = ring + (it % ST) * C::STAGE_BYTES;
    const uint32_t k_u = smem_u32(stage), v_u = k_u + V_TILE;
    mbar_wait(smem_u32(&full[it % ST]), (it / ST) & 1);
    uint32_t ak[QUANT ? VD / 16 : 1][4];
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if (QUANT) {
      // K as bf16 A fragments, straight from the int8 box (exact); rows
      // past valid[b] are finite and get zero weight
#pragma unroll
      for (int kk = 0; kk < VD / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = key_lo + 8 * (e & 1);
          const uint32_t w = *reinterpret_cast<const uint16_t*>(
              stage + r * 128 + (((kk ^ r) & 7) << 4) + 2 * cq +
              8 * (e >> 1));
          ak[kk][e] = i8pair_bf16(w, w >> 8);
        }
      // V as an fp16 tile for the transposed product; a quarter-warp
      // takes 8 rows of one 16-byte chunk, so neither side conflicts
      const uint8_t* vb = stage + V_RAW;
#pragma unroll
      for (int k = 0; k < VBN * 8 / WG_THREADS; ++k) {
        const int i = tid + k * WG_THREADS;
        const int r = (i & 7) + 8 * (i >> 6), c = (i >> 3) & 7;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            vb + r * 128 + ((c ^ (r & 7)) << 4));
        uint4 lo, hi;
        i8x4_f16(raw.x, lo.x, lo.y);
        i8x4_f16(raw.y, lo.z, lo.w);
        i8x4_f16(raw.z, hi.x, hi.y);
        i8x4_f16(raw.w, hi.z, hi.w);
        *reinterpret_cast<uint4*>(v16 + tile_offset(VBN, r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(v16 + tile_offset(VBN, r, 2 * c + 1)) =
            hi;
      }
      fence_proxy_async();  // published to P V by the barrier below
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = sc_next[i];
      if (it + 1 < n) scales_of(it + 1, sc_next);
    } else if (kt + VBN > v_b) {
      // the rows of V from valid[b] on (beyond the window) become zeros
      // before P V reads them; their scores are masked
      const int z0 = v_b - kt;
      for (int i = tid; i < (VBN - z0) * (VD / 8); i += WG_THREADS)
        *reinterpret_cast<uint4*>(stage + V_TILE +
                                  tile_offset(VBN, z0 + i / (VD / 8),
                                              i % (VD / 8))) =
            make_uint4(0, 0, 0, 0);
      fence_proxy_async();
      __syncthreads();
    }

    // S^T = K Q^T: the tile's 64 keys are M, the query rows N
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < VD / 16; ++kk) {
      if constexpr (QUANT) {
        wgmma_rs_t<NR>(st, ak[kk], desc_kmajor(qs_u, NR, 0, kk), kk > 0);
      } else {
        wgmma_ss_t<NR, 0>(st, desc_kmajor(k_u, VBN, 0, kk),
                          desc_kmajor(qs_u, NR, 0, kk), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if (QUANT) {
#pragma unroll
      for (int i = 0; i < NR / 2; ++i) st[i] *= i & 2 ? sc[1] : sc[0];
    }
    if (kt + VBN > thr_min) {
#pragma unroll
      for (int i = 0; i < NR / 2; ++i)
        st[i] = kt + key_lo + 4 * (i & 2) < thr[2 * (i >> 2) + (i & 1)]
                    ? st[i]
                    : -INFINITY;
    }
    // each query row's maximum over the tile: its 2 keys here, the 8 g
    // lanes, then the 4 warps through shared memory
    float mx[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = 4 * (c >> 1) + (c & 1);
      mx[c] = fmaxf(st[i], st[i + 2]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], o));
    }
    if (gq == 0)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        red[warp][8 * (c >> 1) + 2 * cq + (c & 1)] = mx[c];
    __syncthreads();  // (and int8: the stage is read, V in fp16 is there)
    if (QUANT && tid == 0 && it + ST < n) load_kv(it + ST);
    float alpha[NC], neg[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * (c >> 1) + 2 * cq + (c & 1);
      const float m_new =
          fmaxf(fmaxf(m_c[c], fmaxf(red[0][col], red[1][col])),
                fmaxf(red[2][col], red[3][col]));
      // a row that has seen no key yet keeps p = 0 and never forms
      // -inf - -inf
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[c] = fast_exp2((m_c[c] - m_use) * scale_log2);
      neg[c] = -m_use * scale_log2;
      m_c[c] = m_new;
      l_c[c] *= alpha[c];
    }
    // P = 2^(s scale - m); l sums P; P goes to the B tiles as high and
    // low parts, [query row][key]: bf16, or for int8 P times the value
    // scale in fp16 (the type of its V tile)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) {
      const int c = 2 * (i >> 2) + (i & 1);
      const float pv = fast_exp2(fmaf(st[i], scale_log2, neg[c]));
      l_c[c] += pv;
      const int off = tile_offset(NR, 8 * (i >> 2) + 2 * cq + (i & 1),
                                  (key_lo >> 3) + (i & 2 ? 1 : 0)) +
                      (key_lo & 7) * 2;
      if (QUANT) {
        const float w = pv * (i & 2 ? sc[3] : sc[2]);
        const __half hi = __float2half_rn(w);
        *reinterpret_cast<__half*>(ps + off) = hi;
        *reinterpret_cast<__half*>(ps + C::P_BYTES + off) =
            __float2half_rn(w - __half2float(hi));
      } else {
        const bf16 hi = __float2bfloat16_rn(pv);
        *reinterpret_cast<bf16*>(ps + off) = hi;
        *reinterpret_cast<bf16*>(ps + C::P_BYTES + off) =
            __float2bfloat16_rn(pv - __bfloat162float(hi));
      }
    }
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) {
      const float a = alpha[2 * (i >> 2) + (i & 1)];
      ot[0][i] *= a;
      ot[1][i] *= a;
    }
    fence_proxy_async();
    __syncthreads();  // P^T is published; red may be written again

    // O^T += V^T P^T: dims are M (one half a product; V through the
    // transpose flag), the query rows N, the keys K
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int kk = 0; kk < VBN / 16; ++kk) {
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          const uint64_t db =
              desc_kmajor(ps_u + pl * C::P_BYTES, NR, 0, kk);
          if constexpr (QUANT)
            wgmma_ss_t<NR, 1, true>(
                ot[hf], desc_mnmajor(v16_u + hf * (VBN * 128), VBN, kk), db,
                1);
          else
            wgmma_ss_t<NR, 1>(ot[hf],
                              desc_mnmajor(v_u + hf * (VBN * 128), VBN, kk),
                              db, 1);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot[0]);
    fence_regs(ot[1]);
    if constexpr (QUANT) fence_frags(ak);
    __syncthreads();  // the products are done with the stage and P^T
    if (!QUANT && tid == 0 && it + ST < n) load_kv(it + ST);
  }

  // each query row's sum: the 8 g lanes, then the 4 warps
  float L[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      l_c[c] += __shfl_xor_sync(0xffffffffu, l_c[c], o);
    if (gq == 0) red[warp][8 * (c >> 1) + 2 * cq + (c & 1)] = l_c[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = 8 * (c >> 1) + 2 * cq + (c & 1);
    L[c] = red[0][col] + red[1][col] + red[2][col] + red[3][col];
  }

  // rows < R: with one split the output, else this split's partial
  const long rows = (long)gridDim.z * Hkv * R;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int r = rg * NR + 8 * (c >> 1) + 2 * cq + (c & 1);
    if (r >= R) continue;
    const int i0 = 4 * (c >> 1) + (c & 1);  // ot[.][i0] and [i0 + 2]
    if (P == 1) {
      const float d = L[c] == 0.f ? 1.f : L[c];
      bf16* o = out + ((long)(b * span + r % span) * Hq + h * G + r / span) *
                          VD + key_lo;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        o[64 * hf] = __float2bfloat16_rn(ot[hf][i0] / d);
        o[64 * hf + 8] = __float2bfloat16_rn(ot[hf][i0 + 2] / d);
      }
    } else {
      const long prow = ((long)head * R + r) * P + sp;
      float* pa = part + prow * VD + key_lo;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        pa[64 * hf] = ot[hf][i0];
        pa[64 * hf + 8] = ot[hf][i0 + 2];
      }
      if (warp == 0 && gq == 0) {
        part[rows * P * VD + prow] = m_c[c] * scale_log2;  // -inf if empty
        part[rows * P * (VD + 1) + prow] = L[c];
      }
    }
  }
}

// out = sum_p w_p acc_p / sum_p w_p l_p with w_p = 2^(m_p - max m), the
// arithmetic of decode_common.cuh's pass, into the caller's layout; a row
// whose partials are all empty gives zeros. A warp a row, 4 dims a lane.
__global__ void __launch_bounds__(128)
verify_combine_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                      int rows, int Hkv, int G, int span, int P) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* pm = part + (long)rows * P * VD + (long)row * P;
  const float* pl = part + (long)rows * P * (VD + 1) + (long)row * P;
  float mx = -INFINITY;
  for (int p = 0; p < P; ++p) mx = fmaxf(mx, pm[p]);
  float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
  if (mx != -INFINITY) {
    for (int p = 0; p < P; ++p) {
      const float w = exp2f(pm[p] - mx);
      const float4 a = *reinterpret_cast<const float4*>(
          part + ((long)row * P + p) * VD + 4 * lane);
      L += w * pl[p];
      A[0] += w * a.x;
      A[1] += w * a.y;
      A[2] += w * a.z;
      A[3] += w * a.w;
    }
  }
  const float d = L == 0.f ? 1.f : L;
  const int R = G * span, r = row % R, bh = row / R;
  const int h = bh % Hkv, b = bh / Hkv;
  bf16* o = out + ((long)(b * span + r % span) * Hkv * G + h * G + r / span) *
                      VD + 4 * lane;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(A[0] / d, A[1] / d);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(A[2] / d, A[3] / d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = v;
}

// Raises the instantiation's shared-memory limit once. Returns a
// cudaError_t.
template <bool QUANT, int NR>
int prepare() {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_mma_kernel<QUANT, NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, VfyCfg<QUANT, NR>::SMEM);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    smem_set = true;
  }
  return 0;
}

// Blocks of the instantiation that the card holds at once (resident per SM
// times SMs), or a negative cudaError_t.
template <bool QUANT, int NR>
int slots() {
  static int n = 0;
  if (n == 0) {
    int e = prepare<QUANT, NR>(), dev = 0, sms = 0, per_sm = 0;
    if (e == 0) e = (int)cudaGetDevice(&dev);
    if (e == 0)
      e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (e == 0)
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, verify_mma_kernel<QUANT, NR>, WG_THREADS,
          VfyCfg<QUANT, NR>::SMEM);
    if (e != 0) return -e;
    n = max(per_sm, 1) * sms;
  }
  return n;
}

template <bool QUANT, int NR>
int launch_verify(const void* q, const void* ck, const void* cv,
                  const void* ks, const void* vs, const void* valid,
                  void* part, void* out, int B, int Hkv, int G, int span,
                  int S, int P, float scale_log2, cudaStream_t stream) {
  using C = VfyCfg<QUANT, NR>;
  auto kernel = verify_mma_kernel<QUANT, NR>;
  if (const int err = prepare<QUANT, NR>()) return err;
  CUtensorMap k_map = {}, v_map = {};
  int e;
  if (QUANT) {
    // int8 [B * Hkv][S][128] bytes in boxes of 128 bytes x 64 rows
    const cuuint64_t dims[3] = {(cuuint64_t)VD, (cuuint64_t)S,
                                (cuuint64_t)B * Hkv};
    const long strides[2] = {(long)VD, (long)S * VD};
    const cuuint32_t box[3] = {(cuuint32_t)VD, (cuuint32_t)VBN, 1};
    e = encode_map_of(&k_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                      CU_TENSOR_MAP_SWIZZLE_128B, ck, 3, dims, strides, box);
    if (e == 0)
      e = encode_map_of(&v_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                        CU_TENSOR_MAP_SWIZZLE_128B, cv, 3, dims, strides, box);
  } else {
    e = make_kv_map(&k_map, ck, VD, S, S, B * Hkv, VBN);
    if (e == 0) e = make_kv_map(&v_map, cv, VD, S, S, B * Hkv, VBN);
  }
  if (e != 0) return e;
  const int R = G * span, groups = (R + NR - 1) / NR;
  const int n_tiles = (S + VBN - 1) / VBN;
  const int tps = (n_tiles + P - 1) / P;
  kernel<<<dim3(P * groups, Hkv, B), WG_THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), k_map, v_map,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(valid), static_cast<float*>(part),
      static_cast<bf16*>(out), Hkv, G, span, S, tps, P, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  const int rows = B * Hkv * R;
  verify_combine_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), rows, Hkv, G,
      span, P);
  return (int)cudaGetLastError();
}

// The block's query rows: the R rows of a head rounded up to 8, 16 or 32,
// else groups of 64.
template <bool QUANT>
int verify_any(const void* q, const void* ck, const void* cv, const void* ks,
               const void* vs, const void* valid, void* part, void* out,
               int B, int Hkv, int G, int span, int S, int P,
               float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = G * span;
  if (R <= 8)
    return launch_verify<QUANT, 8>(q, ck, cv, ks, vs, valid, part, out, B,
                                   Hkv, G, span, S, P, scale_log2, s);
  if (R <= 16)
    return launch_verify<QUANT, 16>(q, ck, cv, ks, vs, valid, part, out, B,
                                    Hkv, G, span, S, P, scale_log2, s);
  if (R <= 32)
    return launch_verify<QUANT, 32>(q, ck, cv, ks, vs, valid, part, out, B,
                                    Hkv, G, span, S, P, scale_log2, s);
  return launch_verify<QUANT, 64>(q, ck, cv, ks, vs, valid, part, out, B, Hkv,
                                  G, span, S, P, scale_log2, s);
}

template <bool QUANT>
int slots_any(int R) {
  if (R <= 8) return slots<QUANT, 8>();
  if (R <= 16) return slots<QUANT, 16>();
  if (R <= 32) return slots<QUANT, 32>();
  return slots<QUANT, 64>();
}

}  // namespace

// How many blocks of the verify kernel for R = G * span query rows a head
// (``quant``: the int8 form) the card holds at once; the wrapper sizes the
// split count from it. A negative value is a cudaError_t.
extern "C" int a3_verify_slots(int quant, int R) {
  return quant ? slots_any<true>(R) : slots_any<false>(R);
}

// P splits of the cache (any P >= 1; the wrapper chooses it). With P > 1
// ``part`` holds B * Hkv * G * span * P * (D + 2) floats: the partial
// accumulators, then the maxima, then the sums; with P == 1 it is unused.
extern "C" int a3_verify_attend(const void* q, const void* ck, const void* cv,
                                const void* valid, void* part, void* out,
                                int B, int Hkv, int G, int span, int S, int P,
                                float scale_log2, void* stream) {
  return verify_any<false>(q, ck, cv, nullptr, nullptr, valid, part, out, B,
                           Hkv, G, span, S, P, scale_log2, stream);
}

extern "C" int a3_verify_attend_q8(const void* q, const void* ck,
                                   const void* cv, const void* ks,
                                   const void* vs, const void* valid,
                                   void* part, void* out, int B, int Hkv,
                                   int G, int span, int S, int P,
                                   float scale_log2, void* stream) {
  return verify_any<true>(q, ck, cv, ks, vs, valid, part, out, B, Hkv, G,
                          span, S, P, scale_log2, stream);
}
