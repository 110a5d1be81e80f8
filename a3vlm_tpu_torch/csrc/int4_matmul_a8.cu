// int4 weights against int8 activations for Hopper (sm_90a): the W4A8
// decode kernel and the W8A8 prefill kernel.
//
// Replace a3vlm_tpu/ops/quant_matmul.py::_int4_kernel_w4a8 (tiled by
// _int4_matmul_2d_w4a8) and ::_int4_kernel_w8a8p (tiled by
// _int4_matmul_2d_w8a8p). Both take activations already quantized per row
// (xq int8 [M, K], xs f32 [M]) and the split-half packed weight of
// int4_matmul.cu (byte row r of q [K/2, N] holds weight row r in its low
// nibble and row r + K/2 in its high nibble).
//
// W4A8 (M <= 32), int4_gemv_a8_kernel:
//
//     out[m, n] = xs[m] * sum_g s[g, n] * (xq[m, Kg] . q4[Kg, n])
//
// Nibbles unpack to int with two shifts and no float math; the dot over the
// rows of one group is an int32 sum (exact in any order); each is converted
// to f32, multiplied by the group's scale and added; xs[m] is applied once
// in the second pass. The weight stream, K*N/2 bytes, bounds it, so it is
// the split-K GEMV of int4_matmul.cu with integer multiply-adds: a block
// owns 128 columns and 128 packed rows, K is split at multiples of 16 rows,
// and splitk_reduce_kernel sums the f32 partials in a fixed order.
//
// W8A8 prefill (M >= 256), int4_mma_w8a8p_kernel:
//
//     w8[k, n]  = round_half_even(q4[k, n] * r[g(k), n])      |w8| <= 127
//     out[m, n] = float(sum_k xq[m, k] * w8[k, n]) * xs[m] * cs[n]
//
// with r = scale * (15.875 / smax) and cs = smax / 15.875 computed by the
// caller. The multiply-adds bound it. A block owns a 128 x 128 output tile;
// every step requantizes a [32, 128] tile of each half to int8 in shared
// memory, transposed so that a column's K run is contiguous (the .col
// operand), and runs mma.sync m16n8k32 (s8 x s8 -> s32). The int32 sum over
// the whole K is exact, and the epilogue multiplies in one fixed order, so
// the result equals the plain version's bit for bit.

#include "matmul_common.cuh"

namespace {

// ------------------------------------------------------------------ W4A8
constexpr int GA_TX = 32;
constexpr int GA_TY = 8;
constexpr int GA_COLS = 4;
constexpr int GA_BN = GA_TX * GA_COLS;  // 128 columns per block
constexpr int GA_KS = 128;              // packed rows per split
constexpr int GA_MT = 8;                // rows of x per block

__global__ void __launch_bounds__(GA_TX * GA_TY)
int4_gemv_a8_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    float* __restrict__ partial,
                    int M, int half, int N, int group) {
  __shared__ int xs[2][GA_MT][GA_KS];
  __shared__ float red[GA_TY][GA_MT][GA_BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GA_TX + tx;
  const int n0 = blockIdx.x * GA_BN + tx * GA_COLS;
  const int split = blockIdx.y;
  const int r0 = split * GA_KS;
  const int m0 = blockIdx.z * GA_MT;
  const size_t kpad = 2 * (size_t)half;

  for (int i = tid; i < GA_MT * GA_KS; i += GA_TX * GA_TY) {
    const int m = i / GA_KS, r = i % GA_KS;
    int lo = 0, hi = 0;
    if (m0 + m < M && r0 + r < half) {
      const int8_t* row = xq + (size_t)(m0 + m) * kpad;
      lo = row[r0 + r];
      hi = row[half + r0 + r];
    }
    xs[0][m][r] = lo;
    xs[1][m][r] = hi;
  }
  __syncthreads();

  float acc[GA_MT][GA_COLS];
  int pl[GA_MT][GA_COLS], ph[GA_MT][GA_COLS];  // the current group's dots
#pragma unroll
  for (int m = 0; m < GA_MT; ++m)
#pragma unroll
    for (int c = 0; c < GA_COLS; ++c) {
      acc[m][c] = 0.f;
      pl[m][c] = ph[m][c] = 0;
    }

  if (n0 < N) {
    const int hg = half / group;
    const int per_ty = GA_KS / GA_TY;
    int cur_g = -1;
    float sl[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
    auto flush = [&]() {
#pragma unroll
      for (int m = 0; m < GA_MT; ++m)
#pragma unroll
        for (int c = 0; c < GA_COLS; ++c) {
          acc[m][c] += (float)pl[m][c] * sl[c];
          acc[m][c] += (float)ph[m][c] * sh[c];
          pl[m][c] = ph[m][c] = 0;
        }
    };
    for (int rr = ty * per_ty; rr < (ty + 1) * per_ty; ++rr) {
      const int r = r0 + rr;
      if (r >= half) break;
      const int gi = r / group;
      if (gi != cur_g) {
        if (cur_g >= 0) flush();
        cur_g = gi;
        const float4 a =
            *reinterpret_cast<const float4*>(scale + (size_t)gi * N + n0);
        const float4 b = *reinterpret_cast<const float4*>(
            scale + (size_t)(hg + gi) * N + n0);
        sl[0] = a.x; sl[1] = a.y; sl[2] = a.z; sl[3] = a.w;
        sh[0] = b.x; sh[1] = b.y; sh[2] = b.z; sh[3] = b.w;
      }
      const char4 b = *reinterpret_cast<const char4*>(q + (size_t)r * N + n0);
      const int bytes[4] = {b.x, b.y, b.z, b.w};
      int wl[4], wh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wl[c] = lo_nibble(bytes[c]);
        wh[c] = hi_nibble(bytes[c]);
      }
#pragma unroll
      for (int m = 0; m < GA_MT; ++m) {
        const int xl = xs[0][m][rr], xh = xs[1][m][rr];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pl[m][c] += xl * wl[c];
          ph[m][c] += xh * wh[c];
        }
      }
    }
    if (cur_g >= 0) flush();
  }

#pragma unroll
  for (int m = 0; m < GA_MT; ++m)
#pragma unroll
    for (int c = 0; c < GA_COLS; ++c) red[ty][m][tx * GA_COLS + c] = acc[m][c];
  __syncthreads();

  for (int i = tid; i < GA_MT * GA_BN; i += GA_TX * GA_TY) {
    const int m = i / GA_BN, col = i % GA_BN;
    const int n = blockIdx.x * GA_BN + col;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < GA_TY; ++t) s += red[t][m][col];
      partial[((size_t)split * M + m0 + m) * N + n] = s;
    }
  }
}

// ---------------------------------------------------------- W8A8 prefill
constexpr int P8_BM = 128;
constexpr int P8_BN = 128;
constexpr int P8_BK = 32;   // packed rows per step: one k32 mma per half
constexpr int P8_LD = 48;   // bytes per tile row: 16-byte aligned, and the
                            // 8 rows x 4 words of a fragment load hit 32 banks

__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(256)
int4_mma_w8a8p_kernel(const int8_t* __restrict__ xq,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ ratio,
                      const float* __restrict__ xscale,
                      const float* __restrict__ cscale,
                      __nv_bfloat16* __restrict__ out,
                      int M, int half, int N, int group) {
  // xs[h][m][k]: the two K halves of xq; ws[h][n][k]: requantized weights
  __shared__ __align__(16) int8_t xs[2][P8_BM][P8_LD];
  __shared__ __align__(16) int8_t ws[2][P8_BN][P8_LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 columns each
  const int gid = lane >> 2, tig = lane & 3;
  const int m_blk = blockIdx.y * P8_BM;
  const int n_blk = blockIdx.x * P8_BN;
  const size_t kpad = 2 * (size_t)half;
  const int hg = half / group;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int k0 = 0; k0 < half; k0 += P8_BK) {
    {
      const int row = tid >> 1;
      const int c16 = (tid & 1) * 16;
      const int m = m_blk + row;
      uint4 vlo = make_uint4(0, 0, 0, 0), vhi = vlo;
      if (m < M) {
        const int8_t* p = xq + (size_t)m * kpad + k0 + c16;
        vlo = *reinterpret_cast<const uint4*>(p);
        vhi = *reinterpret_cast<const uint4*>(p + half);
      }
      *reinterpret_cast<uint4*>(&xs[0][row][c16]) = vlo;
      *reinterpret_cast<uint4*>(&xs[1][row][c16]) = vhi;
    }
    {
      const int r = tid / (P8_BN / 16);          // 0..31
      const int c16 = (tid % (P8_BN / 16)) * 16;
      const int n = n_blk + c16;
      const int kr = k0 + r;
      if (n < N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)kr * N + n);
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
        const int gi = kr / group;
        const float* rlo = ratio + (size_t)gi * N + n;
        const float* rhi = ratio + (size_t)(hg + gi) * N + n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v = bytes[j];
          ws[0][c16 + j][r] =
              (int8_t)__float2int_rn(__fmul_rn((float)lo_nibble(v), rlo[j]));
          ws[1][c16 + j][r] =
              (int8_t)__float2int_rn(__fmul_rn((float)hi_nibble(v), rhi[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          ws[0][c16 + j][r] = 0;
          ws[1][c16 + j][r] = 0;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + gid;
        const int col = tig * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[h][row][col]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[h][row + 8][col]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[h][row][col + 16]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[h][row + 8][col + 16]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + gid;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(&ws[h][n][tig * 4]);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(&ws[h][n][tig * 4 + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8_16832(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n_blk + wn * 32 + ni * 8 + tig * 2;
      if (col >= N) continue;
      const float c0 = cscale[col], c1 = cscale[col + 1];
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m_blk + wm * 64 + mi * 16 + gid + hrow * 8;
        if (row >= M) continue;
        const float xr = xscale[row];
        // float(acc) * xs[m] * cs[n], in that order
        const float v0 =
            __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * hrow], xr), c0);
        const float v1 =
            __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * hrow + 1], xr), c1);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// W4A8 split-K GEMV for M <= 32. xq int8 [M, 2 * half], xscale f32 [M],
// partial: [ceil(half / 128), M, N] f32 scratch. N % 16 == 0.
extern "C" int a3_int4_gemv_a8(const void* xq, const void* xscale,
                               const void* q, const void* scale, void* partial,
                               void* out, int M, int half, int N, int group,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (half + GA_KS - 1) / GA_KS;
  dim3 grid((N + GA_BN - 1) / GA_BN, splits, (M + GA_MT - 1) / GA_MT);
  int4_gemv_a8_kernel<<<grid, dim3(GA_TX, GA_TY), 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(partial), M, half,
      N, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_splitk_reduce(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out),
      splits, M, N, nullptr, static_cast<const float*>(xscale), nullptr, s);
}

// W8A8 prefill tiled product. xq int8 [M, 2 * half], ratio f32
// [2 * half / group, N], xscale f32 [M], cscale f32 [N]. half % 32 == 0,
// N % 16 == 0.
extern "C" int a3_int4_mma_w8a8p(const void* xq, const void* xscale,
                                 const void* q, const void* ratio,
                                 const void* cscale, void* out, int M, int half,
                                 int N, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + P8_BN - 1) / P8_BN, (M + P8_BM - 1) / P8_BM);
  int4_mma_w8a8p_kernel<<<grid, 256, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(q),
      static_cast<const float*>(ratio), static_cast<const float*>(xscale),
      static_cast<const float*>(cscale), static_cast<__nv_bfloat16*>(out), M,
      half, N, group);
  return (int)cudaGetLastError();
}
