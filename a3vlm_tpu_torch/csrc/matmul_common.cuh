// Pieces the quantized-matmul kernels share (int4_matmul.cu, int8_matmul.cu,
// int4_matmul_a8.cu, and the GEMV of gemv_cluster.cuh): the modes, exact
// conversions of packed values to numbers, and the tiled route of K1, K1v3,
// K11 and K6 on Hopper's tensor cores (qmm_tile, below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace a3mma;

// silu(g) * u as the GLU-fused kernels form it: in f32, sigmoid(g) * g * u,
// rounded to bf16 before the product.
__device__ __forceinline__ __nv_bfloat16 glu_bf16(__nv_bfloat16 g,
                                                 __nv_bfloat16 u) {
  const float gf = __bfloat162float(g);
  const float sig = 1.f / (1.f + expf(-gf));
  return __float2bfloat16_rn(sig * gf * __bfloat162float(u));
}

// ------------------------------------------------- the tiled route (M > 32)
//
// A block computes a [BM, 128] tile of out = x @ W over the whole of K (no
// split-K, so a relaunch is bit-identical). Its 2 warpgroups own 64 R rows
// each. A step covers two [64 k][128 n] weight tiles, its two halves: for
// the int4 modes the low and the high nibbles of 64 packed rows (against x
// columns [k0, k0 + 64) and [half + k0, ...) of the split-half packing),
// for int8 128 consecutive rows of K.
//
// - Copies. One thread asks the TMA for a step's boxes: two x boxes
//   [BM][64] bf16 in the 128-byte swizzle (a K-major A operand as it lies,
//   rows past M and columns past K as zeros) into a ring of XST slots; the
//   packed bytes of q and, for the int4 modes, the step's scale rows of
//   each half ([128] f32: one where a step lies in one group, group % 64
//   == 0; two at group 32, the group of the chunk-packed row-parallel
//   weights, MODE_V1 and MODE_GLU) into a ring of QST slots, since the
//   weights are needed a step before their x. One mbarrier per slot; no
//   thread spends instructions on a copy.
// - Dequantization. All 256 threads turn a step's packed bytes into its
//   two bf16 tiles in shared memory, in the MN-major 128-byte swizzle that
//   K2 reads V from (the B operand through the transpose flag): a thread
//   reads 8 bytes (8 columns of one K row) and writes 8 weights of each
//   half as 16-byte chunks, conflict-free. A value becomes a number without
//   the card's slow integer conversion: as the low byte under the exponent
//   of 2^23 (one byte permute) one f32 subtraction leaves it; the unscaled
//   nibbles of MODE_V3 are made two at a time as bf16 (128 + k, exact) less
//   136. The tiles are double-buffered: step s + 1 is dequantized while
//   the products of step s are on the tensor cores (for R = 2 in four
//   pieces between their four k16 batches), and fence.proxy.async plus the
//   block barrier publish the tiles to them.
// - Products: wgmma m64n128k16, A (x) and B (weights) from shared memory,
//   f32 accumulators in registers (64 R a thread).
// - Modes. MODE_V1: bf16(float(v) * scale), as the TPU kernel rounds it.
//   MODE_V3: unscaled nibbles (exact in bf16), each half's product (one
//   64-row group) into an accumulator of its own, then scaled by the
//   group's scale and added to the running sum (R = 1: three
//   accumulators). MODE_GLU: MODE_V1 over x = silu(g) * u, formed once per
//   element by a pre-pass, and the residual added in f32 before the one
//   rounding at the store. MODE_INT8: bf16(q) exactly, the column scale on
//   the finished sum at the store.
constexpr int MODE_V1 = 0;    // int4, every weight scaled (K1)
constexpr int MODE_V3 = 1;    // int4, group scale on the group's sum (K1v3)
constexpr int MODE_GLU = 2;   // MODE_V1 over silu(g) * u, + residual (K11)
constexpr int MODE_INT8 = 3;  // int8, column scale at the store (K6)
constexpr int MODE_W4A8 = 4;  // int4 x int8 activations, the GEMV only (K7)

// Blocks of 256 rows (two warpgroups of 128; on an H100 faster than blocks
// of 128 at M 1487 and 5948, where the dequantization per product halves),
// 128 for MODE_V3, which holds three accumulators. Ring depths fill the
// shared memory.
template <int MODE>
struct QmmCfg {
  static constexpr int R = MODE == MODE_V3 ? 1 : 2;  // m64 row blocks a WG
  static constexpr int XST = MODE == MODE_V3 ? 3 : 2;   // x ring slots
  static constexpr int QST = MODE == MODE_V3 ? 4 : MODE == MODE_INT8 ? 2 : 3;
  static constexpr int NWG = 2;
  static constexpr int THREADS = NWG * WG_THREADS;
  static constexpr int BM = NWG * R * WG_ROWS;  // rows of x per block
  static constexpr int BN = 128;                // output columns per block
  static constexpr int BK = 64;                 // K rows of a weight tile
  static constexpr bool INT8 = MODE == MODE_INT8;
  static constexpr int X_BYTES = BM * BK * 2;   // one [BM][64] bf16 box
  static constexpr int QROWS = INT8 ? 2 * BK : BK;  // packed rows a step
  static constexpr int Q_BYTES = QROWS * BN;
  // two scale rows a half (the second read at group 32 only)
  static constexpr int S_ROWS = 2;
  static constexpr int S_BYTES = INT8 ? 0 : 2 * S_ROWS * BN * 4;
  static constexpr int Q_SLOT = (Q_BYTES + S_BYTES + SWIZZLE_ALIGN - 1) /
                                SWIZZLE_ALIGN * SWIZZLE_ALIGN;
  static constexpr int W_BYTES = BK * BN * 2;   // one [64][128] bf16 tile
  static constexpr int SMEM = SWIZZLE_ALIGN + XST * 2 * X_BYTES +
                              QST * Q_SLOT + 2 * 2 * W_BYTES;
  static constexpr int CHUNKS = BK * BN / 8 / THREADS;  // 8-byte reads
  // dequantize a piece after each k16 batch of products, or all of it
  // after the last: a batch of R = 2 (4 products a warpgroup) hides a
  // piece, one of R = 1 does not (both measured on an H100)
  static constexpr bool INTERLEAVE = R == 2;
  // the step whose weights a q slot frees for: MODE_V3 reads its scales
  // after its own products, the others only to dequantize, a step earlier
  static constexpr int Q_LEAD = MODE == MODE_V3 ? 0 : 1;
  static_assert(CHUNKS == 4, "dequant pieces: one per k16 batch");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// Byte ``b`` of ``k`` (a biased value k < 2^8, bias ``bias``) as f32: put
// under the exponent of 2^23 by one byte permute, less 2^23 + bias, exact.
__device__ __forceinline__ float biased_f32(uint32_t k, int b, float bias) {
  return __uint_as_float(__byte_perm(k, 0x4B000000u, 0x7440 + b)) -
         (8388608.f + bias);
}

// Bytes a and b of k (biased nibbles) as a bf16 pair: 128 + k (0x43kk,
// exact for k < 128) less 136.
__device__ __forceinline__ uint32_t nibble_pair_bf16(uint32_t k, int a,
                                                     int b) {
  const uint32_t t = __byte_perm(k, 0x43434343u, a | 0x40 | (b << 8) | 0x4000);
  const uint32_t c = 0x43084308u;  // bf16 136, twice
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 weights of a tile row (columns 8 nc .. 8 nc + 7) from 8 packed bytes:
// their nibbles at bit ``shift`` (0 low, 4 high), scaled by sc and rounded
// once to bf16 where SCALED, else the nibbles themselves.
template <bool SCALED>
__device__ __forceinline__ uint4 deq_int4_chunk(uint2 raw, int shift,
                                                const float (&sc)[8]) {
  uint32_t o[4];
#pragma unroll
  for (int wi = 0; wi < 2; ++wi) {
    // the signed nibble u of v, XOR 8: v + 8 in [0, 16), one per byte
    const uint32_t k =
        (((wi ? raw.y : raw.x) >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = 4 * wi + 2 * p;  // columns c, c + 1 of the chunk
      o[2 * wi + p] =
          SCALED ? pack_bf16(biased_f32(k, 2 * p, 8.f) * sc[c],
                             biased_f32(k, 2 * p + 1, 8.f) * sc[c + 1])
                 : nibble_pair_bf16(k, 2 * p, 2 * p + 1);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The same for 8 int8 weights: bf16(q), exact.
__device__ __forceinline__ uint4 deq_int8_chunk(uint2 raw) {
  uint32_t o[4];
#pragma unroll
  for (int wi = 0; wi < 2; ++wi) {
    const uint32_t k = (wi ? raw.y : raw.x) ^ 0x80808080u;  // v + 128
#pragma unroll
    for (int p = 0; p < 2; ++p)
      o[2 * wi + p] = pack_bf16(biased_f32(k, 2 * p, 128.f),
                                biased_f32(k, 2 * p + 1, 128.f));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Piece j (of 4) of a step's dequantization: the packed bytes ``qs`` (scale
// rows after them) into the two bf16 tiles at ``w`` (the second W_BYTES
// after the first). Thread tid owns columns 8 (tid % 16) .. + 7 of row
// tid / 16 + 16 j of each tile; ``sc`` holds its columns' scales of both
// halves (MODE_V1, MODE_GLU).
template <class C, int MODE>
__device__ __forceinline__ void qmm_dequant(const uint8_t* qs, uint8_t* w,
                                            int j, int tid,
                                            const float (&sc)[2][8]) {
  const int nc = tid & 15;
  const int k = (tid >> 4) + j * (C::THREADS / 16);
  const int at = tile_offset(C::BK, k, nc);
  if constexpr (MODE == MODE_INT8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(w + h * C::W_BYTES + at) = deq_int8_chunk(
          *reinterpret_cast<const uint2*>(qs + (h * C::BK + k) * C::BN +
                                          nc * 8));
  } else {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(qs + k * C::BN + nc * 8);
    constexpr bool SCALED = MODE != MODE_V3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(w + h * C::W_BYTES + at) =
          deq_int4_chunk<SCALED>(raw, 4 * h, sc[h]);
  }
}

// This thread's 8 columns' scales of both halves of a step (MODE_V1,
// MODE_GLU): scale row ``sub`` of each half, after the packed bytes.
template <class C>
__device__ __forceinline__ void qmm_scales(const uint8_t* qs, int tid,
                                           float (&sc)[2][8], int sub) {
  const float4* sp = reinterpret_cast<const float4*>(qs + C::Q_BYTES);
  const int nc = tid & 15;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 a = sp[(h * C::S_ROWS + sub) * (C::BN / 4) + 2 * nc + i];
      sc[h][4 * i] = a.x;
      sc[h][4 * i + 1] = a.y;
      sc[h][4 * i + 2] = a.z;
      sc[h][4 * i + 3] = a.w;
    }
}

// The block's [BM, 128] tile of out (layout and modes in the note above).
// ``rows``: int4: K rows of q (half = Kpad / 2); int8: K. x_map: x [M,
// Kpad or K] bf16; q_map: q [rows, N] bytes; s_map (int4): scale
// [Kpad / group, N] f32. col_scale (int8): [N]; res (GLU): [M, N].
template <int MODE>
__device__ __forceinline__ void qmm_tile(
    const CUtensorMap* x_map, const CUtensorMap* q_map,
    const CUtensorMap* s_map, const float* __restrict__ col_scale,
    const bf16* __restrict__ res, bf16* __restrict__ out, int M, int rows,
    int N, int group) {
  using C = QmmCfg<MODE>;
  constexpr int R = C::R, XST = C::XST, QST = C::QST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t x_full[XST];  // step s's x landed
  __shared__ __align__(8) uint64_t q_full[QST];  // step s's weights landed
  uint8_t* xring = align_smem(smem_raw);
  uint8_t* qring = xring + XST * 2 * C::X_BYTES;
  uint8_t* wbuf = qring + QST * C::Q_SLOT;  // [2 steps][2 halves] tiles
  const uint32_t xring_u = smem_u32(xring), wbuf_u = smem_u32(wbuf);

  const int tid = threadIdx.x;
  // warp-uniform for the compiler: branches on it are not divergent
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int tid_wg = tid % WG_THREADS;
  const int m_blk = blockIdx.y * C::BM, n_blk = blockIdx.x * C::BN;
  const int steps = (rows + C::QROWS - 1) / C::QROWS;
  const int hg = C::INT8 ? 0 : rows / group;  // groups per half
  // scale rows of a half in a step: 2 at group 32 (rows 0-31 of the step,
  // dequantized by pieces 0 and 1, then rows 32-63 by pieces 2 and 3)
  const int srows = (!C::INT8 && group < C::BK) ? C::BK / group : 1;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < XST; ++i) mbar_init(smem_u32(&x_full[i]), 1);
#pragma unroll
    for (int i = 0; i < QST; ++i) mbar_init(smem_u32(&q_full[i]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // copies, issued by thread 0
  auto load_x = [&](int s) {
    if (s >= steps) return;
    const uint32_t slot = xring_u + (s % XST) * 2 * C::X_BYTES;
    const uint32_t bar = smem_u32(&x_full[s % XST]);
    mbar_expect_tx(bar, 2 * C::X_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_2d(slot + h * C::X_BYTES, x_map, bar,
                  C::INT8 ? (2 * s + h) * C::BK : h * rows + s * C::BK,
                  m_blk);
  };
  auto load_q = [&](int s) {
    if (s >= steps) return;
    const uint32_t slot = smem_u32(qring) + (s % QST) * C::Q_SLOT;
    const uint32_t bar = smem_u32(&q_full[s % QST]);
    const int k0 = s * C::QROWS;
    mbar_expect_tx(bar, C::Q_BYTES + (C::INT8 ? 0 : 2 * srows * C::BN * 4));
    tma_load_2d(slot, q_map, bar, n_blk, k0);
    if (!C::INT8) {
      tma_load_2d(slot + C::Q_BYTES, s_map, bar, n_blk, k0 / group);
      tma_load_2d(slot + C::Q_BYTES + C::S_ROWS * C::BN * 4, s_map, bar,
                  n_blk, hg + k0 / group);
    }
  };
  auto q_of = [&](int s) { return qring + (s % QST) * C::Q_SLOT; };
  auto w_of = [&](int s) { return wbuf + (s & 1) * 2 * C::W_BYTES; };
  auto x_desc = [&](int s, int h, int r, int ks) {
    return desc_kmajor(xring_u + ((s % XST) * 2 + h) * C::X_BYTES, C::BM,
                       (wg * R + r) * WG_ROWS, ks);
  };
  auto w_desc = [&](int s, int h, int ks) {
    return desc_mnmajor(wbuf_u + ((s & 1) * 2 + h) * C::W_BYTES, C::BK, ks);
  };
  float sc[2][8];
  // step s's weights landed, and this thread's scales of them read
  auto weights_ready = [&](int s) {
    mbar_wait(smem_u32(&q_full[s % QST]), (s / QST) & 1);
    if (MODE == MODE_V1 || MODE == MODE_GLU)
      qmm_scales<C>(q_of(s), tid, sc, 0);
  };
  // piece j of step s's dequantization, after the second scale rows at
  // group 32
  auto dequant = [&](int s, int j) {
    if ((MODE == MODE_V1 || MODE == MODE_GLU) && srows == 2 && j == 2)
      qmm_scales<C>(q_of(s), tid, sc, 1);
    qmm_dequant<C, MODE>(q_of(s), w_of(s), j, tid, sc);
  };

  if (tid == 0) {
    for (int i = 0; i < XST; ++i) load_x(i);
    for (int i = 0; i < QST; ++i) load_q(i);
  }
  weights_ready(0);
#pragma unroll
  for (int j = 0; j < C::CHUNKS; ++j) dequant(0, j);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0 && C::Q_LEAD == 1) load_q(QST);  // step 0's slot is free

  const int warp = tid_wg >> 5, lane = tid_wg & 31;
  const int gq = lane >> 2, cq = lane & 3;
  float acc[R][64];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[r][i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const bool next = s + 1 < steps;
    mbar_wait(smem_u32(&x_full[s % XST]), (s / XST) & 1);
    // MODE_V3: each half's unscaled group sum in part[h]
    float part[MODE == MODE_V3 ? 2 : 1][64];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::BK / 16; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (MODE == MODE_V3) {
          wgmma_ss_tb_n128(part[h], x_desc(s, h, 0, ks), w_desc(s, h, ks),
                           ks > 0);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r)
            wgmma_ss_tb_n128(acc[r], x_desc(s, h, r, ks), w_desc(s, h, ks),
                             1);
        }
      }
      if (C::INTERLEAVE && next) {
        if (ks == 0) weights_ready(s + 1);
        dequant(s + 1, ks);
      }
    }
    wgmma_commit();
    if (!C::INTERLEAVE && next) {
      weights_ready(s + 1);
#pragma unroll
      for (int j = 0; j < C::CHUNKS; ++j) dequant(s + 1, j);
    }
    if (next) fence_proxy_async();
    wgmma_wait<0>();
    if constexpr (MODE == MODE_V3) {
      fence_regs(part[0]);
      fence_regs(part[1]);
      // times each group's scale (the step's q slot), into the running sum
      const float* sp = reinterpret_cast<const float*>(q_of(s) + C::Q_BYTES);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 sv =
              *reinterpret_cast<const float2*>(sp + h * C::S_ROWS * C::BN +
                                               8 * j + 2 * cq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[0][4 * j + e] = fmaf(part[h][4 * j + e], e & 1 ? sv.y : sv.x,
                                     acc[0][4 * j + e]);
        }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
    }
    __syncthreads();  // step s's x slot, its tiles and a q slot are free
    if (tid == 0) {
      load_x(s + XST);
      load_q(s + C::Q_LEAD + QST);
    }
  }

  // the store: * col_scale (int8), + res (GLU) in f32, one rounding
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row0 = m_blk + (wg * R + r) * WG_ROWS + warp * 16 + gq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n_blk + 8 * j + 2 * cq;
      if (col >= N) continue;
      float c0 = 1.f, c1 = 1.f;
      if (MODE == MODE_INT8) {
        c0 = col_scale[col];
        c1 = col_scale[col + 1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= M) continue;
        float v0 = acc[r][4 * j + 2 * hh], v1 = acc[r][4 * j + 2 * hh + 1];
        if (MODE == MODE_INT8) {
          v0 *= c0;
          v1 *= c1;
        }
        const size_t at = (size_t)row * N + col;
        if (MODE == MODE_GLU) {
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(res + at);
          v0 += __bfloat162float(rv.x);
          v1 += __bfloat162float(rv.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Host side of the tiled route: raises the kernel's shared-memory limit
// once per instantiation, encodes the tensor maps of this call (x [M, Kpad
// or K] bf16 in boxes of 64 columns x BM rows, 128-byte swizzle; q [rows,
// N] bytes in boxes of 128 columns x a step's rows; for the int4 modes
// scale [Kpad / group, N] f32 in boxes of 128 x 1, 128 x 2 at group 32)
// and launches one block
// per [BM, 128] output tile. Returns a cudaError_t.
template <int MODE, typename Kernel>
int qmm_launch(Kernel kernel, const void* x, const void* q, const void* scale,
               const void* res, void* out, int M, int rows, int N, int group,
               cudaStream_t stream) {
  using C = QmmCfg<MODE>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    smem_set = true;
  }
  const int xcols = C::INT8 ? rows : 2 * rows;
  CUtensorMap x_map = {}, q_map = {}, s_map = {};
  const cuuint64_t x_dims[2] = {(cuuint64_t)xcols, (cuuint64_t)M};
  const long x_strides[1] = {(long)xcols};
  const cuuint32_t x_box[2] = {64, (cuuint32_t)C::BM};
  int e = encode_map(&x_map, x, 2, x_dims, x_strides, x_box);
  if (e != 0) return e;
  const cuuint64_t q_dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const long q_strides[1] = {(long)N};
  const cuuint32_t q_box[2] = {(cuuint32_t)C::BN, (cuuint32_t)C::QROWS};
  e = encode_map_of(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                    CU_TENSOR_MAP_SWIZZLE_NONE, q, 2, q_dims, q_strides,
                    q_box);
  if (e != 0) return e;
  if (MODE != MODE_INT8) {
    const cuuint64_t s_dims[2] = {(cuuint64_t)N, (cuuint64_t)(xcols / group)};
    const long s_strides[1] = {(long)N};
    const cuuint32_t s_box[2] = {(cuuint32_t)C::BN,
                                 (cuuint32_t)(group < C::BK ? C::BK / group
                                                            : 1)};
    e = encode_map_of(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      CU_TENSOR_MAP_SWIZZLE_NONE, scale, 2, s_dims, s_strides,
                      s_box);
    if (e != 0) return e;
  }
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      x_map, q_map, s_map,
      MODE == MODE_INT8 ? static_cast<const float*>(scale) : nullptr,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), M, rows, N,
      group);
  return (int)cudaGetLastError();
}

}  // namespace
