// int4 dequant-matmul for Hopper (sm_90a), in three modes of one GEMV
// kernel and one tiled kernel.
//
// Replaces a3vlm_tpu/ops/quant_matmul.py::_int4_kernel (tiled by
// _int4_matmul_2d), ::_int4_kernel_v3 (the same call with variant="v3")
// and ::_int4_kernel_glu (tiled by _int4_matmul_2d_glu). Computes
//
//     out[M, N] = x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi)
//
// where byte row r of q [K/2, N] holds weight row r in its low nibble and
// row r + K/2 in its high nibble (sign-extended). Products accumulate in
// f32; the output is bf16. The modes differ in where the scale goes and in
// what x is:
//
// - MODE_V1: deq(v) rounds float(v) * scale[row / group, n] to bf16, as the
//   TPU kernel does.
// - MODE_V3: the nibbles go to bf16 unscaled (exact); each group's rows are
//   summed on their own in f32 (the group in one piece), multiplied by the
//   group's scale and added to the running sum.
// - MODE_GLU: x is formed from two inputs as bf16(sigmoid(g) * g * u) in
//   f32, the weights are as in MODE_V1, and a residual is added in f32
//   before the one rounding at the store: res + (silu(g) * u) @ W.
//
// What bounds it on an H100: at decode (M = batch <= 32) the weight stream,
// K*N/2 bytes and the scales per call, and as much the instructions that
// dequantize each weight once (scripts/torch_gemv_variants.py times the
// GEMV with its copies alone and its arithmetic alone); at prefill (M ~
// 1500-6000) the multiply-adds (at M 5948, 5120 x 5120: 0.32 ms at the
// published 989 TFLOP/s bf16 rate against 0.04 ms for its bytes at 3.35
// TB/s). Two launch shapes follow from that:
//
// - int4_gemv_cluster_kernel (M <= 32): one launch, no scratch in device
//   memory. A block owns 128 output columns and a run of 64-row stages of
//   K; the C blocks of a thread block cluster (C from gemv_splits in the
//   wrapper, 1-8: the most for which the card holds every cluster at once)
//   split K between them. Eight consumer warps are 4 column slices of 32 x
//   2 phases; the phases take alternate runs of stages (a run holds whole
//   groups, so MODE_V3 sums a group in one piece), each through a ring of
//   its own. A producer warp fills both rings by TMA: each stage's packed
//   bytes [64][128] and x's 64 columns of each half [8 MT rows][64] (both
//   in the 128-byte swizzle, MT = ceil(M / 8)), and its scale rows. The
//   consumers turn the weights into the A fragments of mma.sync m16n8k16
//   in registers, each weight once: a byte under the exponent of 2^23 and
//   one f32 subtraction give the nibble, one multiply and cvt.rn.bf16x2
//   the scaled bf16 pair (MODE_V3: two byte permutes and one bf16x2
//   subtraction give the exact nibble pair). The rows of x are the B
//   fragments (n = 8 rows a fragment) and the products accumulate in f32.
//   At the end the two phases' sums are added in shared memory, each
//   block scatters its [M][128] partial over the cluster (rank r gets the
//   r-th slice of it) through distributed shared memory and releases one
//   arrival on each rank's barrier, and each rank sums the C partials of
//   its slice in rank order, adds the GLU residual and rounds once: a
//   relaunch gives the same bits.
// - int4_mma_kernel (large M): the Hopper tile of matmul_common.cuh (TMA
//   ring of x, packed-byte and scale boxes; weights dequantized to bf16 in
//   shared memory while the previous step's wgmma products run). Per
//   weight, the dequantization costs a few integer and float instructions
//   against the 2 BM multiply-adds the tensor cores do with it, so the
//   block is 256 rows high (128 for v3).
//   MODE_GLU first forms silu(g) * u once per element (glu_prepass_kernel)
//   into a scratch that the caller allocates, so that the N / 128 column
//   blocks that read each element do not form it again.

#include "matmul_common.cuh"

namespace {

// ---------------------------------------------------------------- small M
constexpr int GV_BN = 128;                      // output columns a block
constexpr int GV_SR = 64;                       // packed rows a stage
constexpr int GV_WARPS = 8;                     // consumer warps
constexpr int GV_CONSUMERS = GV_WARPS * 32;
constexpr int GV_THREADS = GV_CONSUMERS + 32;   // and the producer warp
constexpr int GV_MAX_CLUSTER = 8;               // the portable cluster size
constexpr int GV_MAX_RING = 16;
constexpr int GV_Q_BYTES = GV_SR * GV_BN;       // a stage's packed bytes

// A stage: the packed bytes [64][128] (128-byte swizzle), XN boxes of x
// [8 MT rows][64 bf16] (the low and the high half; MODE_GLU: of g, then of
// u), then the scale rows of both halves, sb rows of 128 each (the groups
// a stage of 64 rows meets, gv_sb). The ring holds as many stages as
// ``BUDGET`` allows (2 to 16); then come the combine slots and the
// barriers. Blocks an SM: three up to 8 rows (72 registers a thread),
// two up to 24 (96), one above; MODE_V3, which holds three sets of sums,
// two up to 8 rows and one above.
template <int MODE, int MT>
struct GvCfg {
  static constexpr int MINB = MODE == MODE_V3 ? (MT == 1 ? 2 : 1)
                              : MT == 1       ? 3
                              : MT < 4        ? 2
                                              : 1;
  static constexpr int BUDGET = MINB == 1   ? 192 * 1024
                                : MINB == 2 ? 96 * 1024
                                            : 68 * 1024;
  static constexpr int XN = MODE == MODE_GLU ? 4 : 2;
  static constexpr int X_BYTES = 8 * MT * 128;
  static constexpr int PUSH = 8 * MT * GV_BN + GV_MAX_CLUSTER;  // floats
  __host__ __device__ static constexpr int stage(int sb) {
    return GV_Q_BYTES + XN * X_BYTES + 1024 * sb;
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
  // the phases' sums [2][M][128] go over the drained ring
  static_assert(2 * 8 * MT * GV_BN * 4 <= 2 * stage(1), "partials");
  static_assert(smem(1) <= 227 * 1024 && smem(GV_SR) <= 227 * 1024,
                "shared memory");
};

struct GvArgs {
  const bf16* res;  // MODE_GLU: [M, N]
  bf16* out;        // [M, N]
  int M, half, N, group;
  int spg;              // stages of a run of whole groups (gv_spg)
  int sb, stage, ring;  // scale rows a half and bytes of a stage; stages
};

// Stages of the shortest run of whole stages that holds whole groups:
// lcm(64, group) / 64. A run is never split between blocks or phases, so
// MODE_V3 sums every group in one piece.
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The product, out^T = W^T x^T, on mma.sync m16n8k16: A is 16 output
// columns x 16 rows of K, B 16 rows of K x 8 rows of x. Lane (g, c) of a
// warp reads, for rows 2c, 2c + 1, 2c + 8 and 2c + 9 of a 16-row step
// (the k slots its A and B fragments hold), one word of 4 packed bytes:
// columns 32 cs + 4 g .. + 3 of the block. Bytes 2t and 2t + 1 are output
// columns g and g + 8 of fragment t (t = 0, 1), so the warp's two
// fragments cover its 32 columns, and the accumulator's rows g, g + 8 are
// those two columns again. In the 128-byte swizzle these reads, and the B
// fragments' (row g of x, k slots 2c, 2c + 1 and 2c + 8, 2c + 9), meet no
// bank conflict.
template <int MODE, int MT>
__global__ void __launch_bounds__(GV_THREADS, GvCfg<MODE, MT>::MINB)
int4_gemv_cluster_kernel(const __grid_constant__ CUtensorMap x_map,
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
  const uint32_t tx = GV_Q_BYTES + C::XN * C::X_BYTES + 1024 * a.sb;

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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tma_load_3d(smem_u32(xs + h * C::X_BYTES), &x_map, bar, row0, h, 0);
      if (MODE == MODE_GLU)
        tma_load_3d(smem_u32(xs + (2 + h) * C::X_BYTES), &u_map, bar, row0,
                    h, 0);
      tma_load_2d(smem_u32(xs + C::XN * C::X_BYTES + h * a.sb * 512), &s_map,
                  bar, n_blk, h * hg + row0 / a.group);
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
  // Offsets in a stage's packed tile of this lane's words, rows 2c, 2c + 1,
  // 2c + 8 and 2c + 9 of the first 16-row step; a step is 2048 bytes on,
  // and the swizzle depends on a row's index mod 8 alone.
  int qoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * c + (i & 1) + 8 * (i >> 1);
    qoff[i] = r * GV_BN + (((col >> 4) ^ (r & 7)) << 4) + (col & 15);
  }
  // Scale rows: one for the stage where group % 64 == 0, one a 16-row step
  // where group % 16 == 0 (no step meets two groups), else one a row.
  const bool whole = a.group % GV_SR == 0, step16 = a.group % 16 == 0;
  float acc[MT][2][4];
  // MODE_V3: the current group's unscaled sums of each half
  float part[MODE == MODE_V3 ? 2 : 1][MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][t][e] = 0.f;
        part[0][mt][t][e] = 0.f;
        part[MODE == MODE_V3 ? 1 : 0][mt][t][e] = 0.f;
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
    if constexpr (MODE == MODE_GLU) {
      // x = silu(g) * u, formed once per element by the phase's warps, in
      // place of g
      for (int i = cs * 32 + lane; i < 2 * C::X_BYTES / 4; i += 128) {
        uint32_t* gp = reinterpret_cast<uint32_t*>(xs) + i;
        const uint32_t uw =
            reinterpret_cast<const uint32_t*>(xs + 2 * C::X_BYTES)[i];
        const uint32_t gw = *gp;
        const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(&gw);
        const __nv_bfloat162 uv = *reinterpret_cast<const __nv_bfloat162*>(&uw);
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
    float4 s_stage[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_stage[h] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MODE != MODE_V3 && whole) {
        const float hs = h ? 0.0625f : 1.f;
        s_stage[h] = *reinterpret_cast<const float4*>(ss + h * a.sb * GV_BN +
                                                      col);
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
      const int srow = whole || !step16 ? 0 : (row0 + 16 * ks) / a.group - g0;
      bool ends = false;
      if (MODE == MODE_V3)
        ends = whole ? ks == GV_SR / 16 - 1 &&
                           (row0 + GV_SR) % a.group == 0
                     : (row0 + 16 * ks + 16) % a.group == 0;
      // the step's words, each for both halves
      uint32_t wq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wq[i] = *reinterpret_cast<const uint32_t*>(qs + ks * 2048 + qoff[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sh = ss + h * a.sb * GV_BN + col;
        uint32_t bf[MT][2];  // x's B fragments of this half
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* xr = xs + h * C::X_BYTES + (8 * mt + g) * 128 + 4 * c;
          bf[mt][0] =
              *reinterpret_cast<const uint32_t*>(xr + (((2 * ks) ^ g) << 4));
          bf[mt][1] = *reinterpret_cast<const uint32_t*>(
              xr + (((2 * ks + 1) ^ g) << 4));
        }
        uint32_t k[4];  // biased nibbles (v + 8; MODE_V1 high: 16 (v + 8))
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t w = wq[i];
          if (MODE == MODE_V3)
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
  // this rank's slice: the C partials in rank order, + res, one rounding
  const int i0 = rank * chunk, i1 = min(E, i0 + chunk);
  for (int i = i0 + tid; i < i1; i += GV_CONSUMERS) {
    float s = 0.f;
    for (int r = 0; r < Cn; ++r) s += push[r * chunk + i - i0];
    const int n = n_blk + i % GV_BN;
    if (n >= a.N) continue;
    const size_t at = (size_t)(i / GV_BN) * a.N + n;
    if (MODE == MODE_GLU) s += __bfloat162float(a.res[at]);
    a.out[at] = __float2bfloat16_rn(s);
  }
}

// ---------------------------------------------------------------- large M
template <int MODE>
__global__ void __launch_bounds__(QmmCfg<MODE>::THREADS, 1)
int4_mma_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap s_map,
                const float* __restrict__ col_scale,
                const bf16* __restrict__ res, bf16* __restrict__ out, int M,
                int half, int N, int group) {
  qmm_tile<MODE>(&x_map, &q_map, &s_map, col_scale, res, out, M, half, N,
                 group);
}

// z = bf16(sigmoid(g) * g * u) in f32 (glu_bf16), 8 elements a thread.
__global__ void __launch_bounds__(256)
glu_prepass_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                   bf16* __restrict__ z, size_t n8) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const uint4 a = reinterpret_cast<const uint4*>(g)[i];
  const uint4 b = reinterpret_cast<const uint4*>(u)[i];
  const bf16* av = reinterpret_cast<const bf16*>(&a);
  const bf16* bv = reinterpret_cast<const bf16*>(&b);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = glu_bf16(av[e], bv[e]);
  reinterpret_cast<uint4*>(z)[i] = *reinterpret_cast<const uint4*>(o);
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
        int4_gemv_cluster_kernel<MODE, MT>,
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
      &n, int4_gemv_cluster_kernel<MODE, MT>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// The tensor maps of a call and one launch: grid (Cn x column tiles),
// clusters of (Cn, 1, 1). x (and u): [M] rows of two halves of ``half``
// bf16 each, ``xld`` elements apart (xld % 8 == 0), read as a rank-3 map
// (half, 2, M) in boxes of 64 columns x 1 half x 8 MT rows; q [half, N]
// bytes in boxes of 128 x 64; scale [2 half / group, N] f32 in boxes of
// 128 x sb.
template <int MODE, int MT>
int gv_launch(const void* x, const void* u, const void* q, const void* scale,
              const void* res, void* out, int M, int half, int N, int group,
              int xld, int Cn, cudaStream_t stream) {
  using C = GvCfg<MODE, MT>;
  if (const int err = gv_prepare<MODE, MT>()) return err;
  const int sb = gv_sb(group);
  CUtensorMap x_map = {}, u_map = {}, q_map = {}, s_map = {};
  const cuuint64_t x_dims[3] = {(cuuint64_t)half, 2, (cuuint64_t)M};
  const long x_strides[2] = {(long)xld, 2L * xld};
  const cuuint32_t x_box[3] = {64, 1, (cuuint32_t)(8 * MT)};
  int e = encode_map(&x_map, x, 3, x_dims, x_strides, x_box);
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
  const cuuint64_t s_dims[2] = {(cuuint64_t)N,
                                (cuuint64_t)(2 * half / group)};
  const cuuint32_t s_box[2] = {GV_BN, (cuuint32_t)sb};
  e = encode_map_of(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                    CU_TENSOR_MAP_SWIZZLE_NONE, scale, 2, s_dims, q_strides,
                    s_box);
  if (e != 0) return e;
  const GvArgs args = {static_cast<const bf16*>(res),
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
      &cfg, int4_gemv_cluster_kernel<MODE, MT>, x_map, u_map, q_map, s_map,
      args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// MT = ceil(M / 8) of 1-4, for one mode.
template <int MODE>
int gv_launch_m(const void* x, const void* u, const void* q,
                const void* scale, const void* res, void* out, int M,
                int half, int N, int group, int xld, int Cn,
                cudaStream_t s) {
  switch ((M + 7) / 8) {
    case 1:
      return gv_launch<MODE, 1>(x, u, q, scale, res, out, M, half, N, group,
                                xld, Cn, s);
    case 2:
      return gv_launch<MODE, 2>(x, u, q, scale, res, out, M, half, N, group,
                                xld, Cn, s);
    case 3:
      return gv_launch<MODE, 3>(x, u, q, scale, res, out, M, half, N, group,
                                xld, Cn, s);
    case 4:
      return gv_launch<MODE, 4>(x, u, q, scale, res, out, M, half, N, group,
                                xld, Cn, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int gv_clusters_m(int M, int group, int Cn) {
  switch ((M + 7) / 8) {
    case 1: return gv_clusters<MODE, 1>(group, Cn);
    case 2: return gv_clusters<MODE, 2>(group, Cn);
    case 3: return gv_clusters<MODE, 3>(group, Cn);
    case 4: return gv_clusters<MODE, 4>(group, Cn);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// The GEMV for M <= 32, one launch: mode 0 (MODE_V1), 1 (MODE_V3) or 2
// (MODE_GLU: x is g, u its pair, res + (silu(g) * u) @ W). x (and u) [M]
// rows of two halves ``xld`` elements apart (xld % 8 == 0, xld >= half);
// q [half, N], scale [2 half / group, N], out (and res) [M, N]; N % 16 ==
// 0; Cn blocks a cluster (1-8) split K.
extern "C" int a3_int4_gemv(int mode, const void* x, const void* u,
                            const void* q, const void* scale, const void* res,
                            void* out, int M, int half, int N, int group,
                            int xld, int Cn, void* stream) {
  if (M < 1 || M > 32 || Cn < 1 || Cn > GV_MAX_CLUSTER || xld % 8 ||
      xld < half || N % 16 || group < 1 || half % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_V1)
    return gv_launch_m<MODE_V1>(x, u, q, scale, res, out, M, half, N, group,
                                xld, Cn, s);
  if (mode == MODE_V3)
    return gv_launch_m<MODE_V3>(x, u, q, scale, res, out, M, half, N, group,
                                xld, Cn, s);
  if (mode == MODE_GLU)
    return gv_launch_m<MODE_GLU>(x, u, q, scale, res, out, M, half, N, group,
                                 xld, Cn, s);
  return (int)cudaErrorInvalidValue;
}

// Clusters of Cn blocks of the GEMV in ``mode`` at M rows and this group
// that the card holds at once, or a negative cudaError_t.
extern "C" int a3_int4_gemv_clusters(int mode, int M, int group, int Cn) {
  if (M < 1 || M > 32 || group < 1 || Cn < 1 || Cn > GV_MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  if (mode == MODE_V1) return gv_clusters_m<MODE_V1>(M, group, Cn);
  if (mode == MODE_V3) return gv_clusters_m<MODE_V3>(M, group, Cn);
  if (mode == MODE_GLU) return gv_clusters_m<MODE_GLU>(M, group, Cn);
  return -(int)cudaErrorInvalidValue;
}

// Tensor-core tiled product for M > 32: half % 64 == 0, group % 64 == 0,
// N % 16 == 0, every pointer 16-byte aligned.
extern "C" int a3_int4_mma(const void* x, const void* q, const void* scale,
                           void* out, int M, int half, int N, int group,
                           void* stream) {
  return qmm_launch<MODE_V1>(int4_mma_kernel<MODE_V1>, x, q, scale, nullptr,
                             out, M, half, N, group,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int a3_int4_mma_v3(const void* x, const void* q, const void* scale,
                              void* out, int M, int half, int N, int group,
                              void* stream) {
  return qmm_launch<MODE_V3>(int4_mma_kernel<MODE_V3>, x, q, scale, nullptr,
                             out, M, half, N, group,
                             static_cast<cudaStream_t>(stream));
}

// res + (silu(g) * u) @ W: z [M, 2 * half] bf16 is the caller's scratch for
// silu(g) * u, formed here once per element before the tile runs over it.
extern "C" int a3_int4_mma_glu(const void* g, const void* u, const void* q,
                               const void* scale, const void* res, void* z,
                               void* out, int M, int half, int N, int group,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n8 = (size_t)M * half / 4;  // M * 2 half / 8
  glu_prepass_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<bf16*>(z), n8);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return qmm_launch<MODE_GLU>(int4_mma_kernel<MODE_GLU>, z, q, scale, res, out,
                              M, half, N, group, s);
}
