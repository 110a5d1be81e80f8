// The quantized GEMVs for M <= 32 on Hopper (sm_90a): one kernel template,
// gemv_cluster_kernel<MODE, MT>, for the int4 modes of int4_matmul.cu (K1
// MODE_V1, K1v3 MODE_V3, K11 MODE_GLU), the W4A8 decode of
// int4_matmul_a8.cu (K7, MODE_W4A8) and the int8 GEMV of int8_matmul.cu
// (K6, MODE_INT8). Each source instantiates the modes it serves.
//
// What bounds a GEMV on an H100 is the weight stream (K*N/2 bytes for int4,
// K*N for int8, and the scales), and as much the instructions that turn each
// weight into a tensor-core operand; so each weight is read once, by TMA,
// and converted once, in registers.
//
// Launch: one launch, no scratch in device memory. A block owns 128 output
// columns and a run of stages of 64 rows of q (packed rows for int4, rows of
// K for int8); the C blocks of a thread block cluster (C from gemv_splits
// in the wrapper, 1-8: the most for which the card holds every cluster at
// once) split K between them. Eight consumer warps are 4 column slices of
// 32 x 2 phases; the phases take alternate runs of stages (a run holds
// whole groups, so a group's sum is never split), each through a ring of
// its own. A producer warp fills both rings by TMA: each stage's q bytes
// [64][128] (128-byte swizzle), x's rows for the stage (MT = ceil(M / 8)
// fragments of 8 rows) and, for the int4 modes, the scale rows of both
// halves. At the end the two phases' sums are added in shared memory, each
// block scatters its [M][128] partial over the cluster (rank r gets the
// r-th slice of it) through distributed shared memory and releases one
// arrival on each rank's barrier, and each rank sums the C partials of its
// slice in rank order, applies the epilogue and rounds once: a relaunch
// gives the same bits.
//
// The products: out^T = W^T x^T on mma.sync, A = 16 output columns x the
// step's rows of K (the weights), B = the step's rows of K x 8 rows of x.
//
// - MODE_V1, MODE_V3, MODE_GLU (bf16 x, m16n8k16 bf16 -> f32): x's 64
//   columns of each half [8 MT][64] (128-byte swizzle). A byte under the
//   exponent of 2^23 and one f32 subtraction give a nibble, one multiply
//   and cvt.rn.bf16x2 the scaled bf16 pair (MODE_V3: two byte permutes and
//   one bf16x2 subtraction give the exact nibble pair; each group summed on
//   its own in f32 and scaled at its end). MODE_GLU forms x = silu(g) * u
//   once per element in the stage and adds the residual at the store.
// - MODE_INT8 (K6; bf16 x, m16n8k16): q holds int8 weights [K, N]; a stage
//   is 64 rows of K and x's 64 columns [8 MT][64]. Each byte becomes bf16
//   exactly (under the exponent of 2^23, less 2^23 + 128), the products
//   accumulate in f32, and the column scale multiplies the finished sum at
//   the store, as the TPU kernel orders it.
// - MODE_W4A8 (K7; int8 xq, m16n8k32 s8 -> s32): xq's 64 bytes of each half
//   [8 MT][64] (64-byte swizzle). A lane reads its 4 columns of 4 rows and
//   transposes the bytes with 8 byte permutes; a mask then leaves each
//   nibble in the high half of its byte (16 v, the low nibble shifted up
//   first), which is the s8 operand: no float math on the weights. Each
//   group's int32 sum is exact; it converts to f32 and is multiplied by the
//   group's scale / 16 (a power of two: the same product as v's) and added,
//   as the TPU kernel's half_acc does; where a 32-row step meets two groups
//   each takes a product of its own with the other's rows masked to 0. The
//   row scale xs multiplies the finished sum at the store.

#pragma once

#include "matmul_common.cuh"

namespace {

constexpr int GV_BN = 128;                      // output columns a block
constexpr int GV_SR = 64;                       // q rows a stage
constexpr int GV_WARPS = 8;                     // consumer warps
constexpr int GV_CONSUMERS = GV_WARPS * 32;
constexpr int GV_THREADS = GV_CONSUMERS + 32;   // and the producer warp
constexpr int GV_MAX_CLUSTER = 8;               // the portable cluster size
constexpr int GV_MAX_RING = 16;
constexpr int GV_Q_BYTES = GV_SR * GV_BN;       // a stage's q bytes

// A stage: the q bytes [64][128] (128-byte swizzle), XN boxes of x (the low
// and the high half; MODE_GLU: of g, then of u; MODE_INT8: one) of [8 MT
// rows][64] (bf16, 128-byte swizzle; MODE_W4A8: int8, 64-byte swizzle),
// then for the int4 modes the scale rows of both halves, sb rows of 128
// each (the groups a stage of 64 rows meets, gv_sb). The ring holds as many
// stages as ``BUDGET`` allows (2 to 16); then come the combine slots and
// the barriers. Blocks an SM: three up to 8 rows (72 registers a thread),
// two up to 24 (96), one above; MODE_V3 and MODE_W4A8, which hold a second
// set of sums for each half, two up to 8 rows and one above.
template <int MODE, int MT>
struct GvCfg {
  static constexpr bool SCALES = MODE != MODE_INT8;  // group scale rows
  static constexpr int MINB = MODE == MODE_V3 || MODE == MODE_W4A8
                                  ? (MT == 1 ? 2 : 1)
                              : MT == 1 ? 3
                              : MT < 4  ? 2
                                        : 1;
  static constexpr int BUDGET = MINB == 1   ? 192 * 1024
                                : MINB == 2 ? 96 * 1024
                                            : 68 * 1024;
  static constexpr int XN = MODE == MODE_GLU ? 4 : MODE == MODE_INT8 ? 1 : 2;
  static constexpr int X_BYTES = 8 * MT * (MODE == MODE_W4A8 ? 64 : 128);
  static constexpr int PUSH = 8 * MT * GV_BN + GV_MAX_CLUSTER;  // floats
  __host__ __device__ static constexpr int stage(int sb) {
    return GV_Q_BYTES + XN * X_BYTES + (SCALES ? 1024 * sb : 0);
  }
  // even: half the slots for each phase
  __host__ __device__ static constexpr int ring(int sb) {
    return BUDGET / stage(sb) < 2            ? 2
           : BUDGET / stage(sb) > GV_MAX_RING ? GV_MAX_RING
                                              : BUDGET / stage(sb) & ~1;
  }
  __host__ __device__ static constexpr int smem(int sb) {
    return SWIZZLE_ALIGN + ring(sb) * stage(sb) + PUSH * 4 +
           (2 * GV_MAX_RING + 1) * 8;
  }
  // the phases' sums [2][M][128] go over the drained ring, which holds at
  // least min(BUDGET / 2, 16 stages) whatever sb is
  static_assert(2 * 8 * MT * GV_BN * 4 <= BUDGET / 2 &&
                    2 * 8 * MT * GV_BN * 4 <= GV_MAX_RING * stage(0),
                "partials");
  static_assert(stage(0) % 1024 == 0, "stages keep the swizzle alignment");
  static_assert(smem(1) <= 227 * 1024 && smem(GV_SR) <= 227 * 1024,
                "shared memory");
};

struct GvArgs {
  const bf16* res;       // MODE_GLU: [M, N]
  const float* vscale;   // MODE_W4A8: xs [M]; MODE_INT8: column scales [N]
  bf16* out;             // [M, N]
  int M, half, N, group;  // half: rows of q (K for MODE_INT8; group 64)
  int spg;              // stages of a run of whole groups (gv_spg)
  int sb, stage, ring;  // scale rows a half and bytes of a stage; stages
};

// Stages of the shortest run of whole stages that holds whole groups:
// lcm(64, group) / 64. A run is never split between blocks or phases, so
// MODE_V3 and MODE_W4A8 sum every group in one piece.
__host__ __device__ inline int gv_spg(int group) {
  int a = GV_SR, b = group;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return group / a;
}

// Scale rows of each half that a stage meets: 64 / group for a group that
// divides 64, one for a multiple of 64, else at most two more than whole
// groups fit.
inline int gv_sb(int group) {
  if (GV_SR % group == 0) return GV_SR / group;
  if (group % GV_SR == 0) return 1;
  return min(GV_SR, (GV_SR - 1) / group + 2);
}

// A barrier of the consumer warps alone (the producer may be waiting for a
// slot to empty), and one of a phase's four warps.
__device__ __forceinline__ void gv_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GV_CONSUMERS) : "memory");
}

__device__ __forceinline__ void gv_phase_sync(int p) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + p) : "memory");
}

// d += A B: m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B: m16n8k32, s8 in, s32 accumulators (exact: no sum here comes
// near 2^31).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Words w[0..3] (rows r .. r + 3, byte j = column j) as t[0..3] (t[j] byte
// i = column j of row r + i): a 4 x 4 byte transpose in 8 permutes.
__device__ __forceinline__ void transpose_bytes(const uint32_t* w,
                                                uint32_t* t) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// The nibbles of half h of four packed bytes as s8 values 16 v.
__device__ __forceinline__ uint32_t nibbles_x16(uint32_t w, int h) {
  return (h ? w : w << 4) & 0xF0F0F0F0u;
}

// Lane (g, c) of a warp, column slice cs: its 4 columns are 32 cs + 4 g ..
// + 3 of the block. MODE_V1/V3/GLU/INT8 take 16-row steps: for rows 2c, 2c
// + 1, 2c + 8 and 2c + 9 of a step (the k slots its A and B fragments hold)
// it reads one word of 4 bytes. Bytes 2t and 2t + 1 are output columns g
// and g + 8 of fragment t (t = 0, 1), so the warp's two fragments cover its
// 32 columns, and the accumulator's rows g, g + 8 are those two columns
// again. In the 128-byte swizzle these reads, and the B fragments' (row g
// of x, k slots 2c, 2c + 1 and 2c + 8, 2c + 9), meet no bank conflict.
// MODE_W4A8 takes 32-row steps: rows 4c .. 4c + 3 and 16 + 4c .. + 3 (the
// s8 fragments' k slots), transposed so that a word holds one column's 4
// rows; these reads meet 2-way conflicts (rows 8 apart share a swizzle),
// the B fragments' none (64-byte swizzle: row g's chunks move with g / 2).
template <int MODE, int MT>
__global__ void __launch_bounds__(GV_THREADS, GvCfg<MODE, MT>::MINB)
gemv_cluster_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap u_map,
                    const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap s_map,
                    const __grid_constant__ GvArgs a) {
  using C = GvCfg<MODE, MT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_smem(smem_raw);
  float* push = reinterpret_cast<float*>(ring + a.ring * a.stage);
  uint64_t* full = reinterpret_cast<uint64_t*>(push + C::PUSH);
  uint64_t* empty = full + GV_MAX_RING;
  uint64_t* combine = empty + GV_MAX_RING;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Cn = (int)cluster_size(), rank = (int)cluster_rank();
  const int n_blk = (blockIdx.x / Cn) * GV_BN;
  // rank r takes the r-th share of the runs of whole groups of stages
  const int total = (a.half + GV_SR - 1) / GV_SR;
  const int spg = a.spg;
  const int per = ((total + spg - 1) / spg + Cn - 1) / Cn * spg;
  const int lo = min(rank * per, total);
  const int n_st = min(lo + per, total) - lo;
  const int hg = a.half / a.group;  // groups a half
  const uint32_t tx =
      GV_Q_BYTES + C::XN * C::X_BYTES + (C::SCALES ? 1024 * a.sb : 0);

  // Each phase has a ring of its own, ring / 2 slots: the k-th stage of
  // phase q goes to slot q ring / 2 + k % (ring / 2), in round k / (ring /
  // 2). A slot is read by one phase only, so a phase that runs ahead can
  // never take an earlier round's parity for its own.
  const int pring = a.ring / 2;
  // the producer: stage j, the k-th of phase q, once its slot's last
  // reader is done
  auto produce = [&](int j, int q, int k) {
    const int slot = q * pring + k % pring;
    if (k >= pring)
      mbar_wait(smem_u32(&empty[slot]), (k / pring - 1) & 1);
    uint8_t* st = ring + slot * a.stage;
    const uint32_t bar = smem_u32(&full[slot]);
    const int row0 = (lo + j) * GV_SR;
    mbar_expect_tx(bar, tx);
    tma_load_2d(smem_u32(st), &q_map, bar, n_blk, row0);
    uint8_t* xs = st + GV_Q_BYTES;
    if constexpr (MODE == MODE_INT8) {
      tma_load_3d(smem_u32(xs), &x_map, bar, row0, 0, 0);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(smem_u32(xs + h * C::X_BYTES), &x_map, bar, row0, h, 0);
        if (MODE == MODE_GLU)
          tma_load_3d(smem_u32(xs + (2 + h) * C::X_BYTES), &u_map, bar, row0,
                      h, 0);
        tma_load_2d(smem_u32(xs + C::XN * C::X_BYTES + h * a.sb * 512),
                    &s_map, bar, n_blk, h * hg + row0 / a.group);
      }
    }
  };
  const bool producer = tid == GV_CONSUMERS;
  if (producer) {  // sets up the barriers
    for (int s = 0; s < a.ring; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // the four warps of a phase
    }
    mbar_init(smem_u32(combine), Cn);
    mbar_fence_init();
  }
  __syncthreads();   // the barriers are set up
  cluster_arrive();  // ... for the other blocks too (waited for below)

  if (warp == GV_WARPS) {  // the producer warp: every copy, in stage order
    if (producer) {
      int k[2] = {0, 0};
      for (int j = 0, in_run = 0, q = 0; j < n_st; ++j, ++in_run) {
        if (in_run == spg) {  // run j / spg goes to phase (j / spg) % 2
          in_run = 0;
          q ^= 1;
        }
        produce(j, q, k[q]++);
      }
    }
    __syncwarp();
    cluster_wait();
    return;  // no consumer waits on this warp from here on
  }

  const int cs = warp & 3, p = warp >> 2;  // column slice, phase
  const int g = lane >> 2, c = lane & 3;
  const int col = 32 * cs + 4 * g;  // this lane's 4 columns in the block
  // Offsets in a stage's q tile of this lane's words: 16-row steps (rows
  // 2c, 2c + 1, 2c + 8, 2c + 9; a step is 2048 bytes on) or, MODE_W4A8,
  // 32-row steps (rows 4c + i and 16 + 4c + i; a step is 4096 bytes on).
  // The swizzle depends on a row's index mod 8 alone.
  constexpr bool A8 = MODE == MODE_W4A8;
  constexpr int NW = A8 ? 8 : 4;
  int qoff[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int r = A8 ? 4 * c + (i & 3) + 16 * (i >> 2)
                     : 2 * c + (i & 1) + 8 * (i >> 1);
    qoff[i] = r * GV_BN + (((col >> 4) ^ (r & 7)) << 4) + (col & 15);
  }
  // Scale rows: one for the stage where group % 64 == 0, one a 16-row step
  // where group % 16 == 0 (no step meets two groups), else one a row;
  // MODE_W4A8 takes one product a step where group % 32 == 0.
  const bool whole = a.group % GV_SR == 0, step16 = a.group % 16 == 0;
  const bool step32 = a.group % 32 == 0;
  float acc[MT][2][4];
  // MODE_V3: the current group's unscaled sums of each half
  float part[MODE == MODE_V3 ? 2 : 1][MT][2][4];
  // MODE_W4A8: the current group's integer sums of each half
  int ipart[A8 ? 2 : 1][MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][t][e] = 0.f;
        part[0][mt][t][e] = 0.f;
        part[MODE == MODE_V3 ? 1 : 0][mt][t][e] = 0.f;
        ipart[0][mt][t][e] = 0;
        ipart[A8 ? 1 : 0][mt][t][e] = 0;
      }

  // this phase's stages, in order, through its ring (as the producer
  // counts them)
  int kp = 0;
  for (int j = 0, in_run = 0, q = 0; j < n_st; ++j, ++in_run) {
    if (in_run == spg) {
      in_run = 0;
      q ^= 1;
    }
    if (q != p) continue;  // the other phase's run
    const int my_slot = p * pring + kp % pring, my_round = kp / pring;
    ++kp;
    mbar_wait(smem_u32(&full[my_slot]), my_round & 1);
    const uint8_t* qs = ring + my_slot * a.stage;
    uint8_t* xs = ring + my_slot * a.stage + GV_Q_BYTES;
    const float* ss = reinterpret_cast<const float*>(xs + C::XN * C::X_BYTES);
    const int row0 = (lo + j) * GV_SR;
    const int g0 = whole ? 0 : row0 / a.group;  // the stage's first row
    if constexpr (MODE == MODE_W4A8) {
      const int gs = row0 / a.group;  // the group of the stage's first row
#pragma unroll
      for (int ks = 0; ks < GV_SR / 32; ++ks) {
        const int s0 = row0 + 32 * ks;
        uint32_t w[8], tw[8];  // rows 4c + i, 16 + 4c + i; then by column
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(qs + ks * 4096 + qoff[i]);
        transpose_bytes(w, tw);
        transpose_bytes(w + 4, tw + 4);
        // the step's groups (one where group % 64 == 0: the stage's), and
        // this lane's rows, for the masks where it meets more than one
        const int gf = whole ? gs : s0 / a.group;
        const int gl = step32 ? gf : (s0 + 31) / a.group;
        const int r0 = s0 + 4 * c, r1 = s0 + 16 + 4 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t af[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            af[t][0] = nibbles_x16(tw[2 * t], h);
            af[t][1] = nibbles_x16(tw[2 * t + 1], h);
            af[t][2] = nibbles_x16(tw[4 + 2 * t], h);
            af[t][3] = nibbles_x16(tw[4 + 2 * t + 1], h);
          }
          uint32_t bf[MT][2];  // xq's B fragments of this half
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint8_t* xr =
                xs + h * C::X_BYTES + (8 * mt + g) * 64 + 4 * c;
            const int sw = (g >> 1) & 3;
            bf[mt][0] = *reinterpret_cast<const uint32_t*>(
                xr + (((2 * ks) ^ sw) << 4));
            bf[mt][1] = *reinterpret_cast<const uint32_t*>(
                xr + (((2 * ks + 1) ^ sw) << 4));
          }
          const float* sh = ss + h * a.sb * GV_BN + col;
          for (int gi = gf; gi <= gl; ++gi) {
            uint32_t am[2][4];
            uint32_t m0 = 0xFFFFFFFFu, m1 = 0xFFFFFFFFu;
            if (!step32) {
              m0 = m1 = 0u;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if ((r0 + i) / a.group == gi) m0 |= 0xFFu << (8 * i);
                if ((r1 + i) / a.group == gi) m1 |= 0xFFu << (8 * i);
              }
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              am[t][0] = af[t][0] & m0;
              am[t][1] = af[t][1] & m0;
              am[t][2] = af[t][2] & m1;
              am[t][3] = af[t][3] & m1;
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int t = 0; t < 2; ++t)
                mma_s8_16832(ipart[h][mt][t], am[t], bf[mt][0], bf[mt][1]);
            if ((gi + 1) * a.group > s0 + 32) continue;  // the group goes on
            // its integer sum (16 times the dot: the nibbles are 16 v) in
            // f32, times its scale / 16, into the running sum
            const float4 sg =
                *reinterpret_cast<const float4*>(sh + (gi - gs) * GV_BN);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[mt][t][e] =
                      fmaf((float)ipart[h][mt][t][e],
                           comp(sg, 2 * t + (e >> 1)) * 0.0625f,
                           acc[mt][t][e]);
                  ipart[h][mt][t][e] = 0;
                }
          }
        }
      }
    } else {
      if constexpr (MODE == MODE_GLU) {
        // x = silu(g) * u, formed once per element by the phase's warps,
        // in place of g
        for (int i = cs * 32 + lane; i < 2 * C::X_BYTES / 4; i += 128) {
          uint32_t* gp = reinterpret_cast<uint32_t*>(xs) + i;
          const uint32_t uw =
              reinterpret_cast<const uint32_t*>(xs + 2 * C::X_BYTES)[i];
          const uint32_t gw = *gp;
          const __nv_bfloat162 gv =
              *reinterpret_cast<const __nv_bfloat162*>(&gw);
          const __nv_bfloat162 uv =
              *reinterpret_cast<const __nv_bfloat162*>(&uw);
          __nv_bfloat162 z;
          z.x = glu_bf16(gv.x, uv.x);
          z.y = glu_bf16(gv.y, uv.y);
          *gp = *reinterpret_cast<const uint32_t*>(&z);
        }
        gv_phase_sync(p);
      }
      // MODE_V1, MODE_GLU: the high nibbles stay in the high half of their
      // byte, 16 (v + 8) under the exponent of 2^23, so they come out as
      // 16 v and take scale / 16 (exact: a power of two); with group % 64
      // == 0 one scale row serves the stage
      constexpr int NH = MODE == MODE_INT8 ? 1 : 2;  // halves a step
      float4 s_stage[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s_stage[h] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (MODE != MODE_V3 && MODE != MODE_INT8 && whole) {
          const float hs = h ? 0.0625f : 1.f;
          s_stage[h] = *reinterpret_cast<const float4*>(
              ss + h * a.sb * GV_BN + col);
          s_stage[h].x *= hs;
          s_stage[h].y *= hs;
          s_stage[h].z *= hs;
          s_stage[h].w *= hs;
        }
      }
#pragma unroll
      for (int ks = 0; ks < GV_SR / 16; ++ks) {
        // the step's scale row where group % 16 == 0, and whether a group
        // ends with it (MODE_V3)
        const int srow =
            whole || !step16 ? 0 : (row0 + 16 * ks) / a.group - g0;
        bool ends = false;
        if (MODE == MODE_V3)
          ends = whole ? ks == GV_SR / 16 - 1 &&
                             (row0 + GV_SR) % a.group == 0
                       : (row0 + 16 * ks + 16) % a.group == 0;
        // the step's words (int4: each for both halves)
        uint32_t wq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wq[i] = *reinterpret_cast<const uint32_t*>(qs + ks * 2048 + qoff[i]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float* sh = ss + h * a.sb * GV_BN + col;
          uint32_t bf[MT][2];  // x's B fragments of this half
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint8_t* xr =
                xs + h * C::X_BYTES + (8 * mt + g) * 128 + 4 * c;
            bf[mt][0] =
                *reinterpret_cast<const uint32_t*>(xr + (((2 * ks) ^ g) << 4));
            bf[mt][1] = *reinterpret_cast<const uint32_t*>(
                xr + (((2 * ks + 1) ^ g) << 4));
          }
          // biased values (v + 8; MODE_V1 high: 16 (v + 8); int8: v + 128)
          uint32_t k[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t w = wq[i];
            if (MODE == MODE_INT8)
              k[i] = w ^ 0x80808080u;
            else if (MODE == MODE_V3)
              k[i] = ((h ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
            else
              k[i] = h ? (w & 0xF0F0F0F0u) ^ 0x80808080u
                       : (w & 0x0F0F0F0Fu) ^ 0x08080808u;
          }
          uint32_t af[2][4];
          if constexpr (MODE == MODE_V3) {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              // bytes 2t, 2t + 1 of rows (r, r + 1), then of (r + 8, r + 9)
              const uint32_t sel = (2 * t) | ((4 + 2 * t) << 4) |
                                   ((2 * t + 1) << 8) | ((5 + 2 * t) << 12);
              const uint32_t u0 = __byte_perm(k[0], k[1], sel);
              const uint32_t u1 = __byte_perm(k[2], k[3], sel);
              af[t][0] = nibble_pair_bf16(u0, 0, 1);
              af[t][1] = nibble_pair_bf16(u0, 2, 3);
              af[t][2] = nibble_pair_bf16(u1, 0, 1);
              af[t][3] = nibble_pair_bf16(u1, 2, 3);
            }
          } else if constexpr (MODE == MODE_INT8) {
            // the bytes as bf16, exact
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {  // output column g, g + 8
                const int b = 2 * t + hh;
                af[t][hh] = pack_bf16(biased_f32(k[0], b, 128.f),
                                      biased_f32(k[1], b, 128.f));
                af[t][2 + hh] = pack_bf16(biased_f32(k[2], b, 128.f),
                                          biased_f32(k[3], b, 128.f));
              }
          } else {
            // each row's scales of the 4 columns
            float4 sv[4];
            if (whole) {
              sv[0] = sv[1] = sv[2] = sv[3] = s_stage[h];
            } else {
              const float hs = h ? 0.0625f : 1.f;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int rs = step16 ? srow
                                      : (row0 + 16 * ks + 2 * c + (i & 1) +
                                         8 * (i >> 1)) / a.group - g0;
                sv[i] = *reinterpret_cast<const float4*>(sh + rs * GV_BN);
                sv[i].x *= hs;
                sv[i].y *= hs;
                sv[i].z *= hs;
                sv[i].w *= hs;
              }
            }
            const float bias = h ? 128.f : 8.f;
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {  // output column g, g + 8
                const int b = 2 * t + hh;
                af[t][hh] =
                    pack_bf16(biased_f32(k[0], b, bias) * comp(sv[0], b),
                              biased_f32(k[1], b, bias) * comp(sv[1], b));
                af[t][2 + hh] =
                    pack_bf16(biased_f32(k[2], b, bias) * comp(sv[2], b),
                              biased_f32(k[3], b, bias) * comp(sv[3], b));
              }
          }
          if constexpr (MODE == MODE_V3) {
            // each group of the step on its own: one product a group, the
            // rows of the others masked out where the step meets more than
            // one (group % 16 != 0); at a group's last row, its sum times
            // its scale into the running sum
            const int s0 = row0 + 16 * ks;
            const int gf = step16 ? 0 : s0 / a.group;
            const int gl = step16 ? 0 : (s0 + 15) / a.group;
            for (int gi = gf; gi <= gl; ++gi) {
              uint32_t am[2][4];
              uint32_t m01 = 0xFFFFFFFFu, m89 = 0xFFFFFFFFu;
              if (!step16) {
                auto in = [&](int l, uint32_t bits) {
                  return (s0 + l) / a.group == gi ? bits : 0u;
                };
                m01 = in(2 * c, 0x0000FFFFu) | in(2 * c + 1, 0xFFFF0000u);
                m89 = in(2 * c + 8, 0x0000FFFFu) | in(2 * c + 9, 0xFFFF0000u);
              }
#pragma unroll
              for (int t = 0; t < 2; ++t) {
                am[t][0] = af[t][0] & m01;
                am[t][1] = af[t][1] & m01;
                am[t][2] = af[t][2] & m89;
                am[t][3] = af[t][3] & m89;
              }
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int t = 0; t < 2; ++t)
                  mma_bf16_16816(part[h][mt][t], am[t], bf[mt][0],
                                 bf[mt][1]);
              if (step16 ? !ends : (gi + 1) * a.group > s0 + 16)
                continue;  // the group goes on
              const float4 sg = *reinterpret_cast<const float4*>(
                  sh + (step16 ? srow : gi - g0) * GV_BN);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    acc[mt][t][e] = fmaf(part[h][mt][t][e],
                                         comp(sg, 2 * t + (e >> 1)),
                                         acc[mt][t][e]);
                    part[h][mt][t][e] = 0.f;
                  }
            }
          } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int t = 0; t < 2; ++t)
                mma_bf16_16816(acc[mt][t], af[t], bf[mt][0], bf[mt][1]);
          }
        }
      }
    }
    // the slot is read (MODE_GLU: and written, before the copies'
    // asynchronous proxy writes it again)
    if (MODE == MODE_GLU) fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[my_slot]));
  }

  // every consumer warp is past the mainloop, so every issued stage was
  // waited for: the phases' sums go over the drained ring
  gv_consumers_sync();
  float* red = reinterpret_cast<float*>(ring);
  const int E = a.M * GV_BN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * mt + 2 * c + (e & 1);
        if (m < a.M)
          red[p * E + m * GV_BN + col + 2 * t + (e >> 1)] = acc[mt][t][e];
      }
  gv_consumers_sync();
  // the block's [M][128] partial, slice r of it into slot ``rank`` of rank
  // r's combine area
  cluster_wait();  // every rank's combine barrier is set up
  const int chunk = (E + Cn - 1) / Cn;
  for (int i = tid; i < E; i += GV_CONSUMERS) {
    const int d = i / chunk;
    *map_rank(push + rank * chunk + (i - d * chunk), d) = red[i] + red[E + i];
  }
  gv_consumers_sync();
  if (tid < Cn) {  // one arrival a block on each rank, after every store
    fence_cluster();
    remote_arrive(smem_u32(combine), tid);
  }
  mbar_wait_cluster(smem_u32(combine), 0);
  // this rank's slice: the C partials in rank order, the epilogue (+ res;
  // * xs[m]; * the column scale), one rounding
  const int i0 = rank * chunk, i1 = min(E, i0 + chunk);
  for (int i = i0 + tid; i < i1; i += GV_CONSUMERS) {
    float s = 0.f;
    for (int r = 0; r < Cn; ++r) s += push[r * chunk + i - i0];
    const int n = n_blk + i % GV_BN, m = i / GV_BN;
    if (n >= a.N) continue;
    const size_t at = (size_t)m * a.N + n;
    if (MODE == MODE_GLU) s += __bfloat162float(a.res[at]);
    if (MODE == MODE_W4A8) s *= a.vscale[m];
    if (MODE == MODE_INT8) s *= a.vscale[n];
    a.out[at] = __float2bfloat16_rn(s);
  }
}

// ------------------------------------------------------------------- host
// Raises the instantiation's shared-memory limit once, to what a block
// may have (the layout's size depends on the group). Returns a
// cudaError_t.
template <int MODE, int MT>
int gv_prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_cluster_kernel<MODE, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    done = true;
  }
  return 0;
}

// Clusters of Cn blocks of the instantiation the card holds at once for
// this group (cudaOccupancyMaxActiveClusters: a cluster's blocks share one
// GPC), or a negative cudaError_t.
template <int MODE, int MT>
int gv_clusters(int group, int Cn) {
  if (const int err = gv_prepare<MODE, MT>()) return -err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Cn * 1024);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = GvCfg<MODE, MT>::smem(gv_sb(group));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, gemv_cluster_kernel<MODE, MT>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// The tensor maps of a call and one launch: grid (Cn x column tiles),
// clusters of (Cn, 1, 1). x (and u): [M] rows of two halves of ``half``
// elements each, ``xld`` elements apart (16 bytes divide xld's), read as a
// rank-3 map (half, 2, M) in boxes of 64 columns x 1 half x 8 MT rows
// (bf16 in the 128-byte swizzle; MODE_W4A8: int8 in the 64-byte swizzle);
// MODE_INT8: [M] rows of K bf16, xld apart, as a map (K, 1, M). q [half, N]
// bytes in boxes of 128 x 64; scale [2 half / group, N] f32 in boxes of
// 128 x sb.
template <int MODE, int MT>
int gv_launch(const void* x, const void* u, const void* q, const void* scale,
              const void* vscale, const void* res, void* out, int M,
              int half, int N, int group, int xld, int Cn,
              cudaStream_t stream) {
  using C = GvCfg<MODE, MT>;
  if (const int err = gv_prepare<MODE, MT>()) return err;
  const int sb = gv_sb(group);
  CUtensorMap x_map = {}, u_map = {}, q_map = {}, s_map = {};
  const cuuint64_t x_dims[3] = {(cuuint64_t)half,
                                MODE == MODE_INT8 ? 1u : 2u, (cuuint64_t)M};
  const long x_strides[2] = {(long)xld,
                             MODE == MODE_INT8 ? (long)xld : 2L * xld};
  const cuuint32_t x_box[3] = {64, 1, (cuuint32_t)(8 * MT)};
  int e = MODE == MODE_W4A8
              ? encode_map_of(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              CU_TENSOR_MAP_SWIZZLE_64B, x, 3, x_dims,
                              x_strides, x_box)
              : encode_map(&x_map, x, 3, x_dims, x_strides, x_box);
  if (e == 0 && MODE == MODE_GLU)
    e = encode_map(&u_map, u, 3, x_dims, x_strides, x_box);
  if (e != 0) return e;
  const cuuint64_t q_dims[2] = {(cuuint64_t)N, (cuuint64_t)half};
  const long q_strides[1] = {(long)N};
  const cuuint32_t q_box[2] = {GV_BN, GV_SR};
  e = encode_map_of(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                    CU_TENSOR_MAP_SWIZZLE_128B, q, 2, q_dims, q_strides,
                    q_box);
  if (e != 0) return e;
  if (C::SCALES) {
    const cuuint64_t s_dims[2] = {(cuuint64_t)N,
                                  (cuuint64_t)(2 * half / group)};
    const cuuint32_t s_box[2] = {GV_BN, (cuuint32_t)sb};
    e = encode_map_of(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      CU_TENSOR_MAP_SWIZZLE_NONE, scale, 2, s_dims, q_strides,
                      s_box);
    if (e != 0) return e;
  }
  const GvArgs args = {static_cast<const bf16*>(res),
                       static_cast<const float*>(vscale),
                       static_cast<bf16*>(out),
                       M, half, N, group, gv_spg(group), sb, C::stage(sb),
                       C::ring(sb)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Cn * ((N + GV_BN - 1) / GV_BN));
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = C::smem(sb);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemv_cluster_kernel<MODE, MT>, x_map, u_map, q_map, s_map, args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// MT = ceil(M / 8) of 1-4, for one mode.
template <int MODE>
int gv_launch_m(const void* x, const void* u, const void* q,
                const void* scale, const void* vscale, const void* res,
                void* out, int M, int half, int N, int group, int xld, int Cn,
                cudaStream_t s) {
  switch ((M + 7) / 8) {
    case 1:
      return gv_launch<MODE, 1>(x, u, q, scale, vscale, res, out, M, half, N,
                                group, xld, Cn, s);
    case 2:
      return gv_launch<MODE, 2>(x, u, q, scale, vscale, res, out, M, half, N,
                                group, xld, Cn, s);
    case 3:
      return gv_launch<MODE, 3>(x, u, q, scale, vscale, res, out, M, half, N,
                                group, xld, Cn, s);
    case 4:
      return gv_launch<MODE, 4>(x, u, q, scale, vscale, res, out, M, half, N,
                                group, xld, Cn, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int gv_clusters_m(int M, int group, int Cn) {
  if (M < 1 || M > 32 || group < 1 || Cn < 1 || Cn > GV_MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  switch ((M + 7) / 8) {
    case 1: return gv_clusters<MODE, 1>(group, Cn);
    case 2: return gv_clusters<MODE, 2>(group, Cn);
    case 3: return gv_clusters<MODE, 3>(group, Cn);
    case 4: return gv_clusters<MODE, 4>(group, Cn);
  }
  return -(int)cudaErrorInvalidValue;
}

// The checks every GEMV entry point makes: M rows of 1-32, Cn blocks a
// cluster of 1-8, xld a multiple of ``align`` elements (16 bytes) no
// shorter than ``half``, N % 16 == 0, a group that divides ``half``.
inline bool gv_valid(int M, int half, int N, int group, int xld, int align,
                     int Cn) {
  return M >= 1 && M <= 32 && Cn >= 1 && Cn <= GV_MAX_CLUSTER &&
         xld % align == 0 && xld >= half && N % 16 == 0 && group >= 1 &&
         half % group == 0;
}

}  // namespace
