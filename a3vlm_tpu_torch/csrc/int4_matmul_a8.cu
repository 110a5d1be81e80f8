// int4 weights against int8 activations for Hopper (sm_90a): the W4A8
// decode GEMV, the W8A8 prefill kernel, and the per-row activation
// quantizer both take first.
//
// Replace a3vlm_tpu/ops/quant_matmul.py::_int4_kernel_w4a8 (tiled by
// _int4_matmul_2d_w4a8), ::_int4_kernel_w8a8p (tiled by
// _int4_matmul_2d_w8a8p), and the XLA ops of quantize_act_int8 that their
// wrappers run first. Both matmuls take activations already quantized per
// row (xq int8 [M, K], xs f32 [M]) and the split-half packed weight of
// int4_matmul.cu (byte row r of q [K/2, N] holds weight row r in its low
// nibble and row r + K/2 in its high nibble).
//
// The quantizer, quantize_act_kernel: one block a row takes the row's
// absmax m, then s = max(m, 1e-8) / 127 and q = clamp(rint(x / s), -127,
// 127), both quotients correctly rounded (__fdiv_rn), rint half to even:
// the plain version's tensor ops to the bit. It reads each row twice (the
// second time from L1) and is bound by its launch at decode sizes.
//
// W4A8 (M <= 32), gemv_cluster_kernel<MODE_W4A8, MT> (gemv_cluster.cuh):
//
//     out[m, n] = xs[m] * sum_g s[g, n] * (xq[m, Kg] . q4[Kg, n])
//
// One launch, no scratch: the cluster GEMV of K1 with xq's int8 rows in the
// stages, the nibbles turned into s8 operands by byte permutes and masks
// (no float math), each group's dot an exact int32 sum on mma.sync
// m16n8k32, converted to f32, multiplied by the group's scale and added;
// xs[m] is applied once at the store. The weight stream, K*N/2 bytes,
// bounds it.
//
// W8A8 prefill (M >= 256), w8a8p_mma_kernel:
//
//     w8[k, n]  = round_half_even(q4[k, n] * r[g(k), n])      |w8| <= 127
//     out[m, n] = float(sum_k xq[m, k] * w8[k, n]) * xs[m] * cs[n]
//
// with r = scale * (15.875 / smax) and cs = smax / 15.875 computed by the
// caller. The int8 multiply-adds bound it (at M 5948, 14336 x 5120: 0.44 ms
// at the published 1979 TOP/s). The block computes a [256, 128] tile of out
// over the whole of K on wgmma m64n128k32 s8 x s8 -> s32, two warpgroups of
// two m64 row blocks, in steps of 128 packed rows:
//
// - Copies (TMA, one thread, an mbarrier a slot): the step's xq boxes
//   [256 rows][128 k] of each half in the 128-byte swizzle (a K-major A
//   operand as they lie) into a ring of 2, and its packed bytes [128 k][128
//   n] with the two ratio rows of each half into a ring of 2.
// - Requantization: s8 products read both operands K-major, and the bytes
//   come [k][n], so every thread takes 16 rows x 4 columns of the packed
//   bytes, turns each weight into int8 (the nibble under the exponent of
//   2^23 less 2^23 + 8; times its ratio, __fmul_rn; plus 1.5 x 2^23, whose
//   round to nearest even leaves the integer in the low byte) and writes
//   each column's 16 values as one 16-byte chunk of the weight tile [128
//   n][128 k] in the 128-byte swizzle. A warp's loads are whole rows, and a
//   rotation of the column a thread writes first keeps a quarter-warp's
//   stores in eight different chunks, so neither side meets a bank
//   conflict. Each half is a k-step of its own, with its own tile: the
//   tile of k-step t + 1 is formed in four pieces between the four k32
//   batches of k-step t's products, and fence.proxy.async with the block
//   barrier publishes it.
// - The int32 sum over the whole K is exact, and the epilogue multiplies in
//   one fixed order with no contraction, so the result equals the plain
//   version's bit for bit.

#include "gemv_cluster.cuh"

namespace {

// ------------------------------------------------------------- quantizer
constexpr int QA_THREADS = 256;

// x as f32, from bf16 or f32.
__device__ __forceinline__ float qa_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float qa_float(float v) { return v; }

// Row blockIdx.x of x [M, K] (T: bf16 or float) -> q [M, K] int8 and s [M]
// f32. VEC elements a load (16 bytes; 1 where K or a row start does not
// allow it).
template <typename T, int VEC>
__global__ void __launch_bounds__(QA_THREADS)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ s, int K) {
  __shared__ float wmax[QA_THREADS / 32];
  const T* row = x + (size_t)blockIdx.x * K;
  int8_t* qrow = q + (size_t)blockIdx.x * K;
  const int tid = threadIdx.x, n = K / VEC;
  struct alignas(sizeof(T) * VEC) Vec { T v[VEC]; };
  struct alignas(VEC) QVec { int8_t v[VEC]; };
  const Vec* rv = reinterpret_cast<const Vec*>(row);
  float m = 0.f;
#pragma unroll 4
  for (int i = tid; i < n; i += QA_THREADS) {
    const Vec v = rv[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(qa_float(v.v[e])));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  m = wmax[0];
#pragma unroll
  for (int w = 1; w < QA_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
  const float sc = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  if (tid == 0) s[blockIdx.x] = sc;
#pragma unroll 4
  for (int i = tid; i < n; i += QA_THREADS) {
    const Vec v = rv[i];
    QVec o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(qa_float(v.v[e]), sc)),
                                   -127.f),
                             127.f);
    reinterpret_cast<QVec*>(qrow)[i] = o;
  }
}

// ---------------------------------------------------------- W8A8 prefill
struct W8Cfg {
  static constexpr int R = 2;        // m64 row blocks a warpgroup
  static constexpr int NWG = 2;
  static constexpr int THREADS = NWG * WG_THREADS;
  static constexpr int BM = NWG * R * WG_ROWS;  // 256 rows of xq a block
  static constexpr int BN = 128;                // output columns a block
  static constexpr int BK = 128;                // packed rows a step
  static constexpr int XST = 2, QST = 2;        // ring slots
  static constexpr int X_BYTES = BM * BK;       // one [256][128] xq box
  static constexpr int Q_BYTES = BK * BN;       // a step's packed bytes
  static constexpr int R_BYTES = 2 * 2 * BN * 4;  // two ratio rows a half
  static constexpr int Q_SLOT = Q_BYTES + R_BYTES;
  static constexpr int W_BYTES = BN * BK;       // one int8 tile [128][128]
  static constexpr int SMEM =
      SWIZZLE_ALIGN + XST * 2 * X_BYTES + QST * Q_SLOT + 2 * W_BYTES;
  static_assert(Q_SLOT % 1024 == 0, "slots keep the 1024-byte alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// d (+)= A B^T over int8, s32 accumulators, both operands K-major from
// shared memory; m64n128k32.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
#define A3_ACC8I(d, o)                                                  \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),           \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : A3_ACC8I(d, 0), A3_ACC8I(d, 8), A3_ACC8I(d, 16), A3_ACC8I(d, 24),
        A3_ACC8I(d, 32), A3_ACC8I(d, 40), A3_ACC8I(d, 48), A3_ACC8I(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
#undef A3_ACC8I
}

template <int N>
__device__ __forceinline__ void fence_iregs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// round_half_even(v * r) as the low byte of a float: v = the biased nibble
// at byte ``b`` of k less 8, exact; the product rounded once; then 1.5 x
// 2^23 added, which rounds to an integer (|v * r| <= 127) and leaves it,
// two's complement, in the low byte.
__device__ __forceinline__ uint32_t requant_byte(uint32_t k, uint32_t sel,
                                                 float r) {
  const float v =
      __fsub_rn(__uint_as_float(__byte_perm(k, 0x4B000000u, sel)),
                8388616.f);
  return __float_as_uint(__fadd_rn(__fmul_rn(v, r), 12582912.f));
}

// The low bytes of four words as one word, a first.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__global__ void __launch_bounds__(W8Cfg::THREADS, 1)
w8a8p_mma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap r_map,
                 const float* __restrict__ xscale,
                 const float* __restrict__ cscale, bf16* __restrict__ out,
                 int M, int half, int N, int group) {
  using C = W8Cfg;
  constexpr int R = C::R, XST = C::XST, QST = C::QST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t x_full[XST];
  __shared__ __align__(8) uint64_t q_full[QST];
  uint8_t* xring = align_smem(smem_raw);
  uint8_t* qring = xring + XST * 2 * C::X_BYTES;
  uint8_t* wbuf = qring + QST * C::Q_SLOT;  // the tiles of 2 k-steps
  const uint32_t xring_u = smem_u32(xring), wbuf_u = smem_u32(wbuf);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int tid_wg = tid % WG_THREADS;
  const int m_blk = blockIdx.y * C::BM, n_blk = blockIdx.x * C::BN;
  const int steps = (half + C::BK - 1) / C::BK;
  const int T = 2 * steps;  // k-steps: the low half of step s, then its high
  const int hg = half / group;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < XST; ++i) mbar_init(smem_u32(&x_full[i]), 1);
#pragma unroll
    for (int i = 0; i < QST; ++i) mbar_init(smem_u32(&q_full[i]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_x = [&](int s) {
    if (s >= steps) return;
    const uint32_t slot = xring_u + (s % XST) * 2 * C::X_BYTES;
    const uint32_t bar = smem_u32(&x_full[s % XST]);
    mbar_expect_tx(bar, 2 * C::X_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_2d(slot + h * C::X_BYTES, &x_map, bar,
                  h * half + s * C::BK, m_blk);
  };
  auto load_q = [&](int s) {
    if (s >= steps) return;
    const uint32_t slot = smem_u32(qring) + (s % QST) * C::Q_SLOT;
    const uint32_t bar = smem_u32(&q_full[s % QST]);
    const int k0 = s * C::BK;
    mbar_expect_tx(bar, C::Q_SLOT);
    tma_load_2d(slot, &q_map, bar, n_blk, k0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_2d(slot + C::Q_BYTES + h * 2 * C::BN * 4, &r_map, bar, n_blk,
                  h * hg + k0 / group);
  };

  // The requantization: thread tid takes rows 16 kb .. + 15 (kb = tid / 32)
  // and columns 4 nb .. + 3 (nb = tid % 32) of a step's packed bytes, and
  // in piece j of a k-step writes column 4 nb + (j + rot) % 4 of its tile.
  const int kb = tid >> 5, nb = tid & 31;
  const int rot = (nb + (nb >> 2)) & 3;
  uint32_t words[16];  // the step's packed bytes, rows 16 kb + i
  uint32_t kh[16];     // the k-step's biased nibbles
  float rt[2][4];      // ratios of the piece's column, by piece, each half
  auto weights_ready = [&](int s) {  // step s's bytes and ratios, read
    mbar_wait(smem_u32(&q_full[s % QST]), (s / QST) & 1);
    const uint8_t* qs = qring + (s % QST) * C::Q_SLOT;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      words[i] =
          *reinterpret_cast<const uint32_t*>(qs + (16 * kb + i) * C::BN + 4 * nb);
    // the rows' group, as a row of the two loaded (group % 64 == 0, so 16
    // rows lie in one group)
    const int k0 = s * C::BK;
    const int gr = (k0 + 16 * kb) / group - k0 / group;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          qs + C::Q_BYTES + (h * 2 + gr) * C::BN * 4 + 16 * nb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = (j + rot) & 3;
        rt[h][j] = cj == 0 ? v.x : cj == 1 ? v.y : cj == 2 ? v.z : v.w;
      }
    }
  };
  // piece j of k-step t's tile (the weights of step t / 2 are in words)
  auto requant = [&](int t, int j) {
    const int h = t & 1;
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        kh[i] = ((h ? words[i] >> 4 : words[i]) & 0x0F0F0F0Fu) ^ 0x08080808u;
    }
    const int cj = (j + rot) & 3;
    const uint32_t sel = 0x7440u | cj;
    const float r = h ? rt[1][j] : rt[0][j];
    uint32_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = requant_byte(kh[i], sel, r);
    const int n = 4 * nb + cj;
    *reinterpret_cast<uint4*>(wbuf + (t & 1) * C::W_BYTES + n * C::BK +
                              ((kb ^ (n & 7)) << 4)) =
        make_uint4(low_bytes(b[0], b[1], b[2], b[3]),
                   low_bytes(b[4], b[5], b[6], b[7]),
                   low_bytes(b[8], b[9], b[10], b[11]),
                   low_bytes(b[12], b[13], b[14], b[15]));
  };
  auto x_desc = [&](int s, int h, int r, int ks) {
    return desc_kmajor(xring_u + ((s % XST) * 2 + h) * C::X_BYTES, C::BM,
                       (wg * R + r) * WG_ROWS, ks);
  };
  auto w_desc = [&](int t, int ks) {
    return desc_kmajor(wbuf_u + (t & 1) * C::W_BYTES, C::BN, 0, ks);
  };

  if (tid == 0) {
    for (int i = 0; i < XST; ++i) load_x(i);
    for (int i = 0; i < QST; ++i) load_q(i);
  }
  weights_ready(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) requant(0, j);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) load_q(QST);  // step 0's slot is read

  int acc[R][64];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[r][i] = 0;

  for (int t = 0; t < T; ++t) {
    const int s = t >> 1, h = t & 1;
    const bool next = t + 1 < T;
    if (h == 0) mbar_wait(smem_u32(&x_full[s % XST]), (s / XST) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::BK / 32; ++ks) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        wgmma_s8_n128(acc[r], x_desc(s, h, r, ks), w_desc(t, ks), 1);
      if (next) {
        if (h == 1 && ks == 0) weights_ready(s + 1);
        requant(t + 1, ks);
      }
    }
    wgmma_commit();
    if (next) fence_proxy_async();
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_iregs(acc[r]);
    // the tile of k-step t is free, t + 1's published; after a high half
    // the step's x slot and the next step's q slot are read
    __syncthreads();
    if (tid == 0 && h == 1) {
      load_x(s + XST);
      load_q(s + 1 + QST);
    }
  }

  // float(acc) * xs[m] * cs[n], in that order, one rounding
  const int warp = tid_wg >> 5, lane = tid_wg & 31;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row0 = m_blk + (wg * R + r) * WG_ROWS + warp * 16 + gq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n_blk + 8 * j + 2 * cq;
      if (col >= N) continue;
      const float c0 = cscale[col], c1 = cscale[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= M) continue;
        const float xr = xscale[row];
        const float v0 =
            __fmul_rn(__fmul_rn((float)acc[r][4 * j + 2 * hh], xr), c0);
        const float v1 =
            __fmul_rn(__fmul_rn((float)acc[r][4 * j + 2 * hh + 1], xr), c1);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// The W4A8 GEMV for M <= 32, one launch: xq [M] int8 rows of two halves
// ``xld`` bytes apart (xld % 16 == 0, xld >= half), xscale f32 [M], q
// [half, N], scale [2 half / group, N], out [M, N]; N % 16 == 0; any group
// that divides half; Cn blocks a cluster (1-8) split K.
extern "C" int a3_int4_gemv_a8(const void* xq, const void* xscale,
                               const void* q, const void* scale, void* out,
                               int M, int half, int N, int group, int xld,
                               int Cn, void* stream) {
  if (!gv_valid(M, half, N, group, xld, 16, Cn))
    return (int)cudaErrorInvalidValue;
  return gv_launch_m<MODE_W4A8>(xq, nullptr, q, scale, xscale, nullptr, out,
                                M, half, N, group, xld, Cn,
                                static_cast<cudaStream_t>(stream));
}

// Clusters of Cn blocks of the W4A8 GEMV at M rows and this group that the
// card holds at once, or a negative cudaError_t.
extern "C" int a3_int4_gemv_a8_clusters(int M, int group, int Cn) {
  return gv_clusters_m<MODE_W4A8>(M, group, Cn);
}

// The per-row quantizer: x [M, K] (bf16, or f32 where ``is_f32``), q [M, K]
// int8, s [M] f32; one block a row. Loads of 16 bytes where K allows them
// (the wrapper gives 16-byte aligned tensors).
extern "C" int a3_quantize_act_int8(const void* x, void* q, void* s, int M,
                                    int K, int is_f32, void* stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s);
  if (is_f32) {
    const float* xf = static_cast<const float*>(x);
    if (K % 4 == 0)
      quantize_act_kernel<float, 4><<<M, QA_THREADS, 0, st>>>(xf, qo, so, K);
    else
      quantize_act_kernel<float, 1><<<M, QA_THREADS, 0, st>>>(xf, qo, so, K);
  } else {
    const bf16* xb = static_cast<const bf16*>(x);
    if (K % 8 == 0)
      quantize_act_kernel<bf16, 8><<<M, QA_THREADS, 0, st>>>(xb, qo, so, K);
    else
      quantize_act_kernel<bf16, 1><<<M, QA_THREADS, 0, st>>>(xb, qo, so, K);
  }
  return (int)cudaGetLastError();
}

// W8A8 prefill tiled product. xq int8 [M, 2 * half], ratio f32
// [2 * half / group, N], xscale f32 [M], cscale f32 [N]. half % 64 == 0,
// group % 64 == 0, N % 16 == 0, every pointer 16-byte aligned. Raises the
// kernel's shared-memory limit once, encodes the tensor maps of the call
// (xq in boxes of 128 columns x 256 rows, 128-byte swizzle; q [half, N]
// bytes in boxes of 128 x 128; ratio in boxes of 128 x 2) and launches one
// block per [256, 128] output tile.
extern "C" int a3_int4_mma_w8a8p(const void* xq, const void* xscale,
                                 const void* q, const void* ratio,
                                 const void* cscale, void* out, int M, int half,
                                 int N, int group, void* stream) {
  using C = W8Cfg;
  if (half % 64 || group % 64 || N % 16) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8p_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    smem_set = true;
  }
  CUtensorMap x_map = {}, q_map = {}, r_map = {};
  const cuuint64_t x_dims[2] = {(cuuint64_t)(2 * half), (cuuint64_t)M};
  const long x_strides[1] = {(long)(2 * half)};
  const cuuint32_t x_box[2] = {C::BK, C::BM};
  int e = encode_map_of(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                        CU_TENSOR_MAP_SWIZZLE_128B, xq, 2, x_dims, x_strides,
                        x_box);
  if (e != 0) return e;
  const cuuint64_t q_dims[2] = {(cuuint64_t)N, (cuuint64_t)half};
  const long q_strides[1] = {(long)N};
  const cuuint32_t q_box[2] = {C::BN, C::BK};
  e = encode_map_of(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                    CU_TENSOR_MAP_SWIZZLE_NONE, q, 2, q_dims, q_strides,
                    q_box);
  if (e != 0) return e;
  const cuuint64_t r_dims[2] = {(cuuint64_t)N,
                                (cuuint64_t)(2 * half / group)};
  const cuuint32_t r_box[2] = {C::BN, 2};
  e = encode_map_of(&r_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                    CU_TENSOR_MAP_SWIZZLE_NONE, ratio, 2, r_dims, q_strides,
                    r_box);
  if (e != 0) return e;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  w8a8p_mma_kernel<<<grid, C::THREADS, C::SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      x_map, q_map, r_map, static_cast<const float*>(xscale),
      static_cast<const float*>(cscale), static_cast<bf16*>(out), M, half, N,
      group);
  return (int)cudaGetLastError();
}
