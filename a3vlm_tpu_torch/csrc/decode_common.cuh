// Single-query attention over the decode cache for Hopper (sm_90a): the one
// kernel of K3 and K3u (decode_attention.cu, bf16 cache) and of K4 and K4
// fused (decode_attention_q8.cu, int8 cache with f32 row scales), with or
// without the fused write of this step's k/v row.
//
// q [B, Hkv, G, D] bf16; caches [B, Hkv, S, D] (bf16, or int8 with scales
// [B, Hkv, S]); new k/v [B, Hkv, D] bf16; pos/valid [B] int32; out
// [B, Hkv, G, D] bf16. With pos, row pos[b] of both caches becomes the new
// k/v (int8: quantized bit for bit as quantize_kv_tokens: max(absmax,
// 1e-8) / 127 by a true division, x / scale rounded half to even, clipped
// to +-127); then each of the G query rows of a kv head attends over cache
// rows [0, valid[b]) in an f32 online softmax in base 2. The int8 form
// multiplies a row's score by its key scale and its softmax weight by its
// value scale, and sums the row's total over the weights alone. A query row
// that sees no key gives zeros. The head dim D is a template argument, 128
// (the LLaMA decoders) or 64 (falcon); a D 64 instance keeps each lane's
// dims of D 128 (half the lanes a row, twice the rows a warp step) and a
// stage's 8 KB of each panel (twice the rows a stage).
//
// What bounds it on an H100: bytes, the rows below valid[b] of both caches,
// read once for all G query rows of their head. The design:
// - one thread block cluster of C blocks (1, 2, 4 or 8, chosen by the
//   wrapper from the card's resident blocks) per (b, kv head, group of up
//   to 8 query rows); block r of the cluster takes the r-th run of whole
//   stages of [0, valid[b]), so the split follows the data and the card;
// - the query rows and the new k/v rows come first, by plain loads at the
//   kernel's start, before the cache's copies fill the memory system;
// - a producer warp, one thread of it, feeds the block with 1-D bulk
//   copies (cp.async.bulk, no tensor map): a stage of K rows and of V rows
//   (int8: and the stage's slices of the two scale planes, 4 bytes a row)
//   into a ring of DC_RING stages in shared memory, a barrier each for
//   "landed" and for "read", DC_AHEAD stages in flight, so that the blocks
//   sharing an SM's copy engine take turns; the copies stop at the stage
//   that holds row valid[b] - 1. Issuing stalls while the memory system is
//   saturated, so no consumer ever waits for the issuing thread, only for
//   the data;
// - eight consumer warps compute from shared memory with 16-byte reads
//   where the registers allow: a row is LPR lanes (bf16: 16 lanes of 8
//   dims; int8: 8 lanes of 16 dims; fewer dims a lane for 2 to 8 query
//   rows, whose dims and sums each lane holds), every query row of the group
//   against each row while the stage is resident; a warp's softmax
//   rescales once a chunk of rows. In the last stage of a run, rows at or past valid[b] are
//   masked by select before the maximum, and their values and value scales
//   are zeroed before the product, so a NaN there never reaches the output;
//   the other stages take a form without selects;
// - the combine runs through distributed shared memory, with no cluster
//   barrier on its path: each block folds its warps' (max, sum, acc[D])
//   per query row into one partial, stores it into its slot of rank 0's
//   shared memory and arrives (release, cluster scope) on rank 0's combine
//   barrier; rank 0 waits there (acquire), combines the C partials and
//   writes the bf16 output. The other blocks leave as soon as they have
//   arrived. One launch, no scratch in device memory. (The only cluster
//   barrier is split around the mainloop: arrived at after the barriers
//   are set up, waited for before the first remote store.);
// - the fused write: every block takes row pos[b] from shared memory (the
//   new row, copied, or quantized, at the start), never from the cache;
//   the block whose range holds pos[b] (runs of whole stages; the last
//   block also holds everything past them) writes it once its own copies
//   have landed. A block copies only rows of its own range, so no block
//   reads a row another block writes, and attend-only over a cache that
//   already holds the row gives the fused form's bits.
// Every including source gets its own copy (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

using a3mma::bf16;
using a3mma::cluster_arrive;
using a3mma::cluster_rank;
using a3mma::cluster_size;
using a3mma::cluster_wait;
using a3mma::map_rank;
using a3mma::mbar_arrive;
using a3mma::mbar_expect_tx;
using a3mma::mbar_fence_init;
using a3mma::mbar_init;
using a3mma::mbar_wait;
using a3mma::mbar_wait_cluster;
using a3mma::remote_arrive;
using a3mma::smem_u32;

constexpr int DC_WARPS = 8;                   // consumer warps
constexpr int DC_CONSUMERS = DC_WARPS * 32;
constexpr int DC_THREADS = DC_CONSUMERS + 32;  // and the producer warp
constexpr int DC_RING = 4;         // stages of the ring
constexpr int DC_AHEAD = 2;        // stages in flight ahead of the landed
constexpr int DC_STEPS = 2;        // warp steps per softmax chunk
constexpr int DC_MAX_CLUSTER = 8;  // the portable cluster size

template <bool QUANT, int GT, int D>
struct DcCfg {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int ROW_BYTES = QUANT ? D : D * 2;
  static constexpr int ROWS = 8192 / ROW_BYTES;         // rows per stage
  // lanes per row: 16-byte reads where the registers allow (this lane's
  // dims of every query row and of their sums, DPL * GT each, at most 32)
  static constexpr int LPR =
      (GT == 8 ? 32 : QUANT && GT == 1 ? 8 : 16) * D / 128;
  static constexpr int DPL = D / LPR;                   // dims per lane
  static constexpr int LANE_BYTES = DPL * (QUANT ? 1 : 2);
  static constexpr int RPS = 32 / LPR;                  // rows per warp step
  static constexpr int WARP_ROWS = ROWS / DC_WARPS;     // of a stage
  static constexpr int CHUNK = RPS * DC_STEPS;          // rows per rescale
  static_assert(WARP_ROWS % CHUNK == 0, "stage rows per warp");
  static constexpr int PANEL = ROWS * ROW_BYTES;        // K or V of a stage
  static constexpr int SCALES = QUANT ? ROWS * 4 : 0;   // a scale slice
  static constexpr int STAGE = 2 * PANEL + 2 * SCALES;
  // the warps' partials over the drained ring: max and sum, then acc[D],
  // per warp and query row
  static constexpr int PART_ACC = 2 * DC_WARPS * GT * 4;
  static constexpr int RING = DC_RING * STAGE;
  static_assert(PART_ACC + DC_WARPS * GT * D * 4 <= RING, "partials");
  // the new row of k and of v as the cache holds them, and their scales
  static constexpr int NEW = RING;
  // rank 0's combine slots, one per block of the cluster: acc[GT][D],
  // then the maxima [rank][GT], then the sums [rank][GT]
  static constexpr int PUSH = NEW + 2 * ROW_BYTES + 16;
  static constexpr int PUSH_M = PUSH + DC_MAX_CLUSTER * GT * D * 4;
  static constexpr int PUSH_L = PUSH_M + DC_MAX_CLUSTER * GT * 4;
  // the ring's barriers (a slot's data landed, a slot was read), the
  // combine's
  static constexpr int BARS = PUSH_L + DC_MAX_CLUSTER * GT * 4;
  static constexpr int EMPTY = DC_RING, COMBINE = 2 * DC_RING;
  static constexpr int SMEM = BARS + (COMBINE + 1) * 8;
};

struct DcArgs {
  const bf16* q;
  uint8_t* ck;  // written at pos[b] only
  uint8_t* cv;
  float* ks;    // int8 form: the scale planes
  float* vs;
  const bf16* nk;  // null pos: attention only
  const bf16* nv;
  const int* pos;
  const int* valid;
  bf16* out;
  int Hkv, G, S;
  int staged;  // int8: scale slices by bulk copy (S % 4 == 0)
  float scale_log2;
};

// A barrier of the consumer warps alone (the producer may be waiting for a
// slot to empty).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(DC_CONSUMERS) : "memory");
}

// ``bytes`` (a multiple of 16, both addresses on 16 bytes) from device
// memory into this block's shared memory; completes on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ row loaders
// A lane's N values of a row as floats: bf16 pairs; or int8 through the
// byte under the exponent of 2^23 (2^23 + (x ^ 0x80) - (2^23 + 128) == x,
// exact, no integer conversion).
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void i8x4_to_f(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 | k)) -
           8388736.0f;
}

template <bool QUANT, int N>
__device__ __forceinline__ void load_lane(const uint8_t* p, float (&f)[N]) {
  if constexpr (QUANT && N == 4) {
    i8x4_to_f(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (!QUANT && N == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    bf16x2_to_f(r.x, f);
    bf16x2_to_f(r.y, f + 2);
  } else if constexpr (QUANT && N == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    i8x4_to_f(r.x, f);
    i8x4_to_f(r.y, f + 4);
    i8x4_to_f(r.z, f + 8);
    i8x4_to_f(r.w, f + 12);
  } else if constexpr (QUANT) {
    static_assert(N == 8, "int8 lane width");
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f(r.x, f);
    i8x4_to_f(r.y, f + 4);
  } else {
    static_assert(N == 8, "bf16 lane width");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    bf16x2_to_f(r.x, f);
    bf16x2_to_f(r.y, f + 2);
    bf16x2_to_f(r.z, f + 4);
    bf16x2_to_f(r.w, f + 6);
  }
}

// N bf16 values (2, 4, 8 or 16) from device memory as raw pairs.
template <int N>
__device__ __forceinline__ void load_pairs(const bf16* p,
                                           uint32_t (&w)[N / 2]) {
  if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  } else {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = r.x;
      w[4 * c + 1] = r.y;
      w[4 * c + 2] = r.z;
      w[4 * c + 3] = r.w;
    }
  }
}

// ------------------------------------------------------------- the kernel
// Grid (C x groups, Hkv, B), clusters of (C, 1, 1), DC_THREADS threads.
template <bool QUANT, int GT, int D>
__global__ void __launch_bounds__(DC_THREADS)
decode_cluster_kernel(const __grid_constant__ DcArgs a) {
  using Cf = DcCfg<QUANT, GT, D>;
  constexpr int LPR = Cf::LPR, DPL = Cf::DPL, ROWS = Cf::ROWS;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* new_k = smem + Cf::NEW;
  uint8_t* new_v = new_k + Cf::ROW_BYTES;
  float* new_s = reinterpret_cast<float*>(new_v + Cf::ROW_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Cf::BARS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR, rg = lane / LPR;  // dims block, row in a step
  const int C = (int)cluster_size(), rank = (int)cluster_rank();
  const int g0 = (blockIdx.x / C) * GT, nq = min(GT, a.G - g0);
  const int h = blockIdx.y, b = blockIdx.z, S = a.S;
  const long bh = (long)b * a.Hkv + h;
  // plain loads first, before the cache's copies fill the memory system:
  // the bounds, this lane's dims of the query rows, this step's k/v
  const int v_b = max(0, min(a.valid[b], S));
  const int p_b = a.pos ? a.pos[b] : -1;  // -1 never matches a row
  uint32_t q_raw[GT][DPL / 2];
#pragma unroll
  for (int g = 0; g < GT; ++g)
    if (g < nq) load_pairs<DPL>(a.q + (bh * a.G + g0 + g) * D + sub * DPL,
                                q_raw[g]);
  // bf16: 16 bytes a thread of k (threads 0 to NEW_PIECES - 1) or v (the
  // next NEW_PIECES); int8: warp 0's lane l quantizes dims NQ l .. NQ l +
  // NQ - 1 of both
  constexpr int NEW_PIECES = D / 8, NQ = D / 32;
  uint4 new_raw = {};
  uint32_t new_kv[2][NQ / 2] = {};
  if (a.pos && warp == 0) {
    if (!QUANT && lane < 2 * NEW_PIECES)
      new_raw = reinterpret_cast<const uint4*>(
          (lane < NEW_PIECES ? a.nk : a.nv) + bh * D)[lane % NEW_PIECES];
    if (QUANT)
      for (int i = 0; i < 2; ++i)
        load_pairs<NQ>((i ? a.nv : a.nk) + bh * D + lane * NQ, new_kv[i]);
  }
  // runs of whole stages of [0, v_b): [lo, lo + per) for rank r
  const int per = max(((v_b + ROWS - 1) / ROWS + C - 1) / C, 1) * ROWS;
  const int lo = rank * per;
  const int hi = min(lo + per, v_b);
  const int n_st = hi > lo ? (hi - lo + ROWS - 1) / ROWS : 0;
  const bool writes =
      a.pos && p_b >= 0 && p_b < S && min(p_b / per, C - 1) == rank;

  // the producer: one thread issues every copy of the block, stage j into
  // slot j % DC_RING, DC_AHEAD stages ahead of the landed ones
  auto produce = [&](int j) {
    const int slot = j % DC_RING;
    if (j >= DC_RING)  // the consumers are done with stage j - DC_RING
      mbar_wait(smem_u32(&bars[Cf::EMPTY + slot]), (j / DC_RING - 1) & 1);
    if (j >= DC_AHEAD)  // stage j - DC_AHEAD has landed
      mbar_wait(smem_u32(&bars[(j - DC_AHEAD) % DC_RING]),
                ((j - DC_AHEAD) / DC_RING) & 1);
    uint8_t* st = smem + slot * Cf::STAGE;
    const uint32_t bar = smem_u32(&bars[slot]);
    const int row0 = lo + j * ROWS;
    const int n = min(ROWS, S - row0);  // the cache's last stage is short
    const long at = bh * S + row0;
    const uint32_t panel = n * Cf::ROW_BYTES;
    const uint32_t scales = QUANT && a.staged ? n * 4 : 0;
    mbar_expect_tx(bar, 2 * panel + 2 * scales);
    bulk_load(smem_u32(st), a.ck + at * Cf::ROW_BYTES, panel, bar);
    bulk_load(smem_u32(st + Cf::PANEL), a.cv + at * Cf::ROW_BYTES, panel,
              bar);
    if (scales) {
      bulk_load(smem_u32(st + 2 * Cf::PANEL), a.ks + at, scales, bar);
      bulk_load(smem_u32(st + 2 * Cf::PANEL + Cf::SCALES), a.vs + at, scales,
                bar);
    }
  };
  const bool producer = tid == DC_CONSUMERS;
  const int first = min(n_st, DC_AHEAD);
  if (producer) {  // sets up the barriers and starts the copies at once
#pragma unroll
    for (int s = 0; s < DC_RING; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[Cf::EMPTY + s]), DC_WARPS);
    }
    mbar_init(smem_u32(&bars[Cf::COMBINE]), C * DC_CONSUMERS);
    mbar_fence_init();
    for (int j = 0; j < first; ++j) produce(j);
  }
  __syncthreads();  // the barriers are set up
  cluster_arrive();  // ... for the other blocks too (waited for below)

  if (warp == DC_WARPS) {  // the producer warp: the rest of the copies
    if (producer)
      for (int j = first; j < n_st; ++j) produce(j);
    __syncwarp();
    cluster_wait();
    return;  // no consumer waits on this warp from here on
  }

  if (a.pos) {  // the new row, as the cache will hold it
    if (warp == 0 && !QUANT && lane < 2 * NEW_PIECES)
      reinterpret_cast<uint4*>(lane < NEW_PIECES ? new_k : new_v)
          [lane % NEW_PIECES] = new_raw;
    if (warp == 0 && QUANT) {
      float kr[NQ], vr[NQ];
      float ka = 0.f, va = 0.f;
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        bf16x2_to_f(new_kv[0][j], kr + 2 * j);
        bf16x2_to_f(new_kv[1][j], vr + 2 * j);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        ka = fmaxf(ka, fabsf(kr[j]));
        va = fmaxf(va, fabsf(vr[j]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ka = fmaxf(ka, __shfl_xor_sync(0xffffffffu, ka, o));
        va = fmaxf(va, __shfl_xor_sync(0xffffffffu, va, o));
      }
      const float kscale = __fdiv_rn(fmaxf(ka, 1e-8f), 127.0f);
      const float vscale = __fdiv_rn(fmaxf(va, 1e-8f), 127.0f);
      uint32_t kw = 0, vw = 0;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int kq =
            (int)fminf(fmaxf(rintf(__fdiv_rn(kr[j], kscale)), -127.f), 127.f);
        const int vq =
            (int)fminf(fmaxf(rintf(__fdiv_rn(vr[j], vscale)), -127.f), 127.f);
        kw |= ((uint32_t)kq & 0xffu) << (8 * j);
        vw |= ((uint32_t)vq & 0xffu) << (8 * j);
      }
      if constexpr (NQ == 4) {
        reinterpret_cast<uint32_t*>(new_k)[lane] = kw;
        reinterpret_cast<uint32_t*>(new_v)[lane] = vw;
      } else {
        reinterpret_cast<uint16_t*>(new_k)[lane] = (uint16_t)kw;
        reinterpret_cast<uint16_t*>(new_v)[lane] = (uint16_t)vw;
      }
      if (lane == 0) {
        new_s[0] = kscale;
        new_s[1] = vscale;
      }
    }
    consumers_sync();
  }

  // this lane's DPL dims of each query row of the group, times the scale
  float qf[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int k = 0; k < DPL / 2; ++k) {
      bf16x2_to_f(g < nq ? q_raw[g][k] : 0u, &qf[g][2 * k]);
      qf[g][2 * k] *= a.scale_log2;
      qf[g][2 * k + 1] *= a.scale_log2;
    }
  }

  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[g][t] = 0.f;
  }

  // One stage: every query row of the group against each of its rows. A
  // stage that holds row pos[b] or rows at or past hi (the last of the
  // run), or whose int8 scales were not staged, takes the EDGE form:
  // selects for the new row and masks; the others take none.
  auto stage = [&](const uint8_t* st, int row0, auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    const float* st_ks = reinterpret_cast<const float*>(st + 2 * Cf::PANEL);
    const float* st_vs = st_ks + ROWS;
#pragma unroll
    for (int c = 0; c < Cf::WARP_ROWS / Cf::CHUNK; ++c) {
      const int r0 = warp * Cf::WARP_ROWS + c * Cf::CHUNK + rg;
      float s[DC_STEPS][GT];
#pragma unroll
      for (int i = 0; i < DC_STEPS; ++i) {
        const int r = r0 + i * Cf::RPS;
        const uint8_t* kp = st + r * Cf::ROW_BYTES;
        if (EDGE && row0 + r == p_b) kp = new_k;
        float kf[DPL];
        load_lane<QUANT, DPL>(kp + sub * Cf::LANE_BYTES, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float d = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t) d = fmaf(qf[g][t], kf[t], d);
          s[i][g] = d;
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < DC_STEPS; ++i)
#pragma unroll
          for (int g = 0; g < GT; ++g)
            s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], o);
#pragma unroll
      for (int i = 0; i < DC_STEPS; ++i) {
        const int r = r0 + i * Cf::RPS, row = row0 + r;
        const bool ok = !EDGE || row < hi;
        if (QUANT) {
          float ksc = st_ks[r];
          if (EDGE)
            ksc = !ok ? 0.f
                  : row == p_b ? new_s[0]
                  : a.staged   ? ksc
                               : a.ks[bh * S + row];
#pragma unroll
          for (int g = 0; g < GT; ++g) s[i][g] *= ksc;
        }
        if (EDGE)
#pragma unroll
          for (int g = 0; g < GT; ++g) s[i][g] = ok ? s[i][g] : -INFINITY;
      }
      // one rescale a chunk: the maximum over the warp's rows of it
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float cm = s[0][g];
#pragma unroll
        for (int i = 1; i < DC_STEPS; ++i) cm = fmaxf(cm, s[i][g]);
#pragma unroll
        for (int o = 16; o >= LPR; o >>= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float m_new = fmaxf(m[g], cm);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[g] - m_use);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[g][t] *= alpha;
#pragma unroll
        for (int i = 0; i < DC_STEPS; ++i) {
          s[i][g] = exp2f(s[i][g] - m_use);
          l[g] += s[i][g];
        }
      }
#pragma unroll
      for (int i = 0; i < DC_STEPS; ++i) {
        const int r = r0 + i * Cf::RPS, row = row0 + r;
        const uint8_t* vp = st + Cf::PANEL + r * Cf::ROW_BYTES;
        if (EDGE && row == p_b) vp = new_v;
        float vf[DPL];
        load_lane<QUANT, DPL>(vp + sub * Cf::LANE_BYTES, vf);
        float vsc = QUANT ? st_vs[r] : 1.f;
        if (EDGE) {
          const bool ok = row < hi;
          if (QUANT)
            vsc = !ok ? 0.f
                  : row == p_b ? new_s[1]
                  : a.staged   ? vsc
                               : a.vs[bh * S + row];
#pragma unroll
          for (int t = 0; t < DPL; ++t) vf[t] = ok ? vf[t] : 0.f;
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float w = QUANT ? s[i][g] * vsc : s[i][g];
#pragma unroll
          for (int t = 0; t < DPL; ++t) acc[g][t] = fmaf(w, vf[t], acc[g][t]);
        }
      }
    }
  };

  for (int j = 0; j < n_st; ++j) {
    mbar_wait(smem_u32(&bars[j % DC_RING]), (j / DC_RING) & 1);
    const uint8_t* st = smem + (j % DC_RING) * Cf::STAGE;
    const int row0 = lo + j * ROWS;
    if (row0 + ROWS > hi || (p_b >= row0 && p_b < row0 + ROWS) ||
        (QUANT && !a.staged))
      stage(st, row0, std::true_type{});
    else
      stage(st, row0, std::false_type{});
    __syncwarp();  // this warp is done with the slot
    if (lane == 0) mbar_arrive(smem_u32(&bars[Cf::EMPTY + j % DC_RING]));
  }

  // the fused write, once this block's copies have all landed
  if (writes) {
    const long at = (bh * S + p_b) * Cf::ROW_BYTES;
    constexpr int PIECES = Cf::ROW_BYTES / 16;  // 16-byte pieces of a row
    if (tid < 2 * PIECES) {
      const int half = tid / PIECES, i = tid % PIECES;
      reinterpret_cast<uint4*>((half ? a.cv : a.ck) + at)[i] =
          reinterpret_cast<const uint4*>(half ? new_v : new_k)[i];
    }
    if (QUANT && tid == 2 * PIECES) {
      a.ks[bh * S + p_b] = new_s[0];
      a.vs[bh * S + p_b] = new_s[1];
    }
  }

  // the warp's rows of a step share m: sum their (l, acc) across the warp
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int t = 0; t < DPL; ++t)
        acc[g][t] += __shfl_xor_sync(0xffffffffu, acc[g][t], o);
    }
  // the ring is drained (every issued stage was waited for) once every
  // warp is past the mainloop: the warps' partials go over it
  consumers_sync();
  float* pm = reinterpret_cast<float*>(smem);
  float* pl = pm + DC_WARPS * GT;
  float* pacc = reinterpret_cast<float*>(smem + Cf::PART_ACC);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane < LPR) {
      float* dst = pacc + (warp * GT + g) * D + sub * DPL;
#pragma unroll
      for (int t = 0; t < DPL; t += 4)
        *reinterpret_cast<float4*>(dst + t) =
            make_float4(acc[g][t], acc[g][t + 1], acc[g][t + 2], acc[g][t + 3]);
    }
    if (lane == 0) {
      pm[warp * GT + g] = m[g];
      pl[warp * GT + g] = l[g];
    }
  }
  consumers_sync();

  // the block's partial per query row, into its slot at rank 0
  cluster_wait();  // rank 0's combine barrier is set up
  float* slot_acc = map_rank(
      reinterpret_cast<float*>(smem + Cf::PUSH) + rank * GT * D, 0);
  float* slot_m = map_rank(
      reinterpret_cast<float*>(smem + Cf::PUSH_M) + rank * GT, 0);
  float* slot_l = map_rank(
      reinterpret_cast<float*>(smem + Cf::PUSH_L) + rank * GT, 0);
  for (int o = tid; o < GT * D; o += DC_CONSUMERS) {
    const int g = o / D, d = o % D;
    float M = -INFINITY, L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DC_WARPS; ++w) M = fmaxf(M, pm[w * GT + g]);
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < DC_WARPS; ++w) {
        const float x = exp2f(pm[w * GT + g] - M);
        L = fmaf(x, pl[w * GT + g], L);
        A = fmaf(x, pacc[(w * GT + g) * D + d], A);
      }
    }
    slot_acc[o] = A;
    if (d == 0) {
      slot_m[g] = M;
      slot_l[g] = L;
    }
  }
  remote_arrive(smem_u32(&bars[Cf::COMBINE]), 0);
  if (rank != 0) return;  // rank 0 reads nothing of this block's memory

  mbar_wait_cluster(smem_u32(&bars[Cf::COMBINE]), 0);
  const float* push_acc = reinterpret_cast<const float*>(smem + Cf::PUSH);
  const float* push_m = reinterpret_cast<const float*>(smem + Cf::PUSH_M);
  const float* push_l = reinterpret_cast<const float*>(smem + Cf::PUSH_L);
  for (int o = tid; o < nq * D; o += DC_CONSUMERS) {
    const int g = o / D;
    float mr[DC_MAX_CLUSTER], lr[DC_MAX_CLUSTER], ar[DC_MAX_CLUSTER];
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < DC_MAX_CLUSTER; ++r) {  // every load in flight
      mr[r] = r < C ? push_m[r * GT + g] : -INFINITY;
      lr[r] = r < C ? push_l[r * GT + g] : 0.f;
      ar[r] = r < C ? push_acc[r * GT * D + o] : 0.f;
      M = fmaxf(M, mr[r]);
    }
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int r = 0; r < DC_MAX_CLUSTER; ++r) {
        const float x = exp2f(mr[r] - M);
        L = fmaf(x, lr[r], L);
        A = fmaf(x, ar[r], A);
      }
    }
    a.out[(bh * a.G + g0) * D + o] =
        __float2bfloat16_rn(A / (L == 0.f ? 1.f : L));
  }
}

// ------------------------------------------------------------------- host
// Raises the instantiation's shared-memory limit once. Returns a
// cudaError_t.
template <bool QUANT, int GT, int D>
int dc_prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_cluster_kernel<QUANT, GT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        DcCfg<QUANT, GT, D>::SMEM);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    done = true;
  }
  return 0;
}

// Blocks of the instantiation the card holds at once (resident per SM times
// SMs), or a negative cudaError_t.
template <bool QUANT, int GT, int D>
int dc_slots() {
  static int n = 0;
  if (n == 0) {
    int e = dc_prepare<QUANT, GT, D>(), dev = 0, sms = 0, per_sm = 0;
    if (e == 0) e = (int)cudaGetDevice(&dev);
    if (e == 0)
      e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (e == 0)
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_cluster_kernel<QUANT, GT, D>, DC_THREADS,
          DcCfg<QUANT, GT, D>::SMEM);
    if (e != 0) return -e;
    n = max(per_sm, 1) * sms;
  }
  return n;
}

template <bool QUANT, int GT, int D>
int dc_launch(const DcArgs& a, int B, int C, cudaStream_t stream) {
  if (const int err = dc_prepare<QUANT, GT, D>()) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((a.G + GT - 1) / GT), a.Hkv, B);
  cfg.blockDim = dim3(DC_THREADS);
  cfg.dynamicSmemBytes = DcCfg<QUANT, GT, D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_cluster_kernel<QUANT, GT, D>, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The query rows a block holds: G rounded up to 1, 2, 4 or 8; more than 8
// take more groups (blocks) of 8.
template <bool QUANT, int D>
int dc_slots_g(int G) {
  if (G <= 1) return dc_slots<QUANT, 1, D>();
  if (G <= 2) return dc_slots<QUANT, 2, D>();
  if (G <= 4) return dc_slots<QUANT, 4, D>();
  return dc_slots<QUANT, 8, D>();
}

// Of the head dims 64 and 128; any other is cudaErrorInvalidValue (as a
// negative count).
template <bool QUANT>
int dc_slots_any(int G, int D) {
  if (D == 64) return dc_slots_g<QUANT, 64>(G);
  if (D == 128) return dc_slots_g<QUANT, 128>(G);
  return -(int)cudaErrorInvalidValue;
}

template <bool QUANT, int D>
int dc_launch_g(const DcArgs& a, int B, int C, cudaStream_t s) {
  if (a.G <= 1) return dc_launch<QUANT, 1, D>(a, B, C, s);
  if (a.G <= 2) return dc_launch<QUANT, 2, D>(a, B, C, s);
  if (a.G <= 4) return dc_launch<QUANT, 4, D>(a, B, C, s);
  return dc_launch<QUANT, 8, D>(a, B, C, s);
}

template <bool QUANT>
int dc_launch_any(const DcArgs& a, int B, int D, int C, void* stream) {
  if (C < 1 || C > DC_MAX_CLUSTER || a.G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return dc_launch_g<QUANT, 64>(a, B, C, s);
  if (D == 128) return dc_launch_g<QUANT, 128>(a, B, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
