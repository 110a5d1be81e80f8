// Pieces the quantized-matmul kernels share (int4_matmul.cu, int8_matmul.cu,
// int4_matmul_a8.cu): nibble unpacking, the second pass of the split-K
// GEMVs, and the bf16 tensor-core tile (mma.sync m16n8k16, a 128 x 128
// output tile per block of 8 warps, 32 rows of K per step).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int lo_nibble(int b) {
  return ((int)((unsigned)b << 28)) >> 28;
}

__device__ __forceinline__ int hi_nibble(int b) { return b >> 4; }

// silu(g) * u as the GLU-fused kernels form it: in f32, sigmoid(g) * g * u,
// rounded to bf16 before the product.
__device__ __forceinline__ __nv_bfloat16 glu_bf16(__nv_bfloat16 g,
                                                 __nv_bfloat16 u) {
  const float gf = __bfloat162float(g);
  const float sig = 1.f / (1.f + expf(-gf));
  return __float2bfloat16_rn(sig * gf * __bfloat162float(u));
}

// Second pass of a split-K GEMV: sums the f32 partials [splits, M, N] in a
// fixed order (so results do not change from run to run), then applies the
// epilogue once: * col_scale[n], * row_scale[m], + res[m, n], each where the
// pointer is not null, and rounds to bf16.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     __nv_bfloat16* __restrict__ out,
                                     int splits, int M, int N,
                                     const float* __restrict__ col_scale,
                                     const float* __restrict__ row_scale,
                                     const __nv_bfloat16* __restrict__ res) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * mn + i];
  if (col_scale) s *= col_scale[i % N];
  if (row_scale) s *= row_scale[i / N];
  if (res) s += __bfloat162float(res[i]);
  out[i] = __float2bfloat16_rn(s);
}

inline cudaError_t launch_splitk_reduce(const float* partial,
                                        __nv_bfloat16* out, int splits, int M,
                                        int N, const float* col_scale,
                                        const float* row_scale,
                                        const __nv_bfloat16* res,
                                        cudaStream_t s) {
  const size_t mn = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      partial, out, splits, M, N, col_scale, row_scale, res);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 tensor-core tile
constexpr int MM_BM = 128;
constexpr int MM_BN = 128;
constexpr int MM_BK = 32;  // rows of K per step
constexpr int MM_LD = MM_BK + 8;
constexpr int MM_THREADS = 256;

typedef __nv_bfloat16 MmTile[MM_BM][MM_LD];

struct MmLane {
  int wm, wn, gid, tig;  // 2 warps along M (64 rows), 4 along N (32 columns)
  __device__ explicit MmLane(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    wm = warp >> 2;
    wn = warp & 3;
    gid = lane >> 2;
    tig = lane & 3;
  }
};

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mm_zero(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
}

// Rows [m_blk, m_blk + 128) and columns [k_off, k_off + 32) of x [M, ld]
// into xs; rows past M and columns from k_limit on are zero. With GLU the
// element is glu_bf16(x, u). ld and k_off are multiples of 8.
template <bool GLU>
__device__ __forceinline__ void mm_load_x(MmTile& xs,
                                          const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ u,
                                          size_t ld, int m_blk, int M,
                                          int k_off, int k_limit, int tid) {
  for (int i = tid; i < MM_BM * MM_BK / 8; i += MM_THREADS) {
    const int row = i / (MM_BK / 8);
    const int c8 = (i % (MM_BK / 8)) * 8;
    const int m = m_blk + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < M && k_off + c8 < k_limit) {
      const size_t at = (size_t)m * ld + k_off + c8;
      v = *reinterpret_cast<const uint4*>(x + at);
      if (GLU) {
        const uint4 w = *reinterpret_cast<const uint4*>(u + at);
        __nv_bfloat16* gv = reinterpret_cast<__nv_bfloat16*>(&v);
        const __nv_bfloat16* uv = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = glu_bf16(gv[j], uv[j]);
      }
    }
    *reinterpret_cast<uint4*>(&xs[row][c8]) = v;
  }
}

// acc += xs [128 x 32] @ ws^T, ws stored n-major ([n][k]) so a B fragment's
// two k-neighbours are one 32-bit word.
__device__ __forceinline__ void mm_step(float (&acc)[4][4][4],
                                        const MmTile& xs, const MmTile& ws,
                                        const MmLane& t) {
#pragma unroll
  for (int kk = 0; kk < MM_BK; kk += 16) {
    uint32_t af[4][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = t.wm * 64 + mi * 16 + t.gid;
      const int col = kk + t.tig * 2;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[row][col]);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][col]);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[row][col + 8]);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][col + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = t.wn * 32 + ni * 8 + t.gid;
      const int k = kk + t.tig * 2;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(&ws[n][k]);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(&ws[n][k + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bf[ni]);
  }
}

// The block's tile to out [M, N] as bf16: acc * col_scale[n] + res[m, n],
// each where the pointer is not null, rounded once. N is even.
__device__ __forceinline__ void mm_store(const float (&acc)[4][4][4],
                                         __nv_bfloat16* __restrict__ out,
                                         int M, int N, int m_blk, int n_blk,
                                         const MmLane& t,
                                         const float* __restrict__ col_scale,
                                         const __nv_bfloat16* __restrict__ res) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n_blk + t.wn * 32 + ni * 8 + t.tig * 2;
      if (col >= N) continue;
      float s0 = 1.f, s1 = 1.f;
      if (col_scale) {
        s0 = col_scale[col];
        s1 = col_scale[col + 1];
      }
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m_blk + t.wm * 64 + mi * 16 + t.gid + hrow * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * hrow] * s0;
        float v1 = acc[mi][ni][2 * hrow + 1] * s1;
        const size_t at = (size_t)row * N + col;
        if (res) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(res + at);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace
