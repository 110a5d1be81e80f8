// int4 dequant-matmul for Hopper (sm_90a), in three modes of one pair of
// kernels.
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
// - MODE_V3: the nibbles go to bf16 unscaled (exact); each run of rows
//   inside one group is summed on its own in f32, multiplied by the group's
//   scale, and added to the running sum (the runs are 16 rows per thread
//   in the GEMV and 32 rows per step in the tiled form, so a 64-row group
//   is scaled in 4 or 2 pieces; the TPU kernel scales it in one).
// - MODE_GLU: x is formed from two inputs as bf16(sigmoid(g) * g * u) in
//   f32, the weights are as in MODE_V1, and a residual is added in f32
//   before the one rounding at the store: res + (silu(g) * u) @ W.
//
// What bounds it on an H100: at decode (M = batch <= 32) the weight stream,
// K*N/2 bytes per call, and nothing else; at prefill (M ~ 6000) the
// multiply-adds. Two launch shapes follow from that:
//
// - int4_gemv_kernel (small M): a split-K GEMV. A block owns 128 columns and
//   128 packed rows; its 32 x 8 threads read 4 contiguous bytes each, so a
//   warp streams one 128-byte row segment per step. x is staged in shared
//   memory, group scales are reloaded only when the group changes, and the
//   per-split f32 partials are summed in a fixed order by a second pass
//   (splitk_reduce_kernel, which also adds the GLU residual, once), so
//   results do not change from run to run.
// - int4_mma_kernel (large M): a 128 x 128 output tile per block; every
//   32-row K step dequantizes a [32, 128] tile of each half into shared
//   memory as bf16 and runs mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   No cp.async, TMA or wgmma yet: a simple right kernel first.

#include "matmul_common.cuh"

namespace {

constexpr int MODE_V1 = 0;
constexpr int MODE_V3 = 1;
constexpr int MODE_GLU = 2;

__device__ __forceinline__ float deq_bf16(int v, float s) {
  return __bfloat162float(__float2bfloat16_rn((float)v * s));
}

// ---------------------------------------------------------------- small M
constexpr int GV_TX = 32;               // threads along N
constexpr int GV_TY = 8;                // row slices per block
constexpr int GV_COLS = 4;              // columns per thread
constexpr int GV_BN = GV_TX * GV_COLS;  // 128 columns per block
constexpr int GV_KS = 128;              // packed rows per split
constexpr int GV_MT = 8;                // rows of x per block

// u is read in MODE_GLU only (x is then g).
template <int MODE>
__global__ void __launch_bounds__(GV_TX * GV_TY)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ u,
                 const int8_t* __restrict__ q,
                 const float* __restrict__ scale,
                 float* __restrict__ partial,
                 int M, int half, int N, int group) {
  __shared__ float xs[2][GV_MT][GV_KS];
  __shared__ float red[GV_TY][GV_MT][GV_BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GV_TX + tx;
  const int n0 = blockIdx.x * GV_BN + tx * GV_COLS;
  const int split = blockIdx.y;
  const int r0 = split * GV_KS;
  const int m0 = blockIdx.z * GV_MT;
  const size_t kpad = 2 * (size_t)half;

  for (int i = tid; i < GV_MT * GV_KS; i += GV_TX * GV_TY) {
    const int m = i / GV_KS, r = i % GV_KS;
    float lo = 0.f, hi = 0.f;
    if (m0 + m < M && r0 + r < half) {
      const size_t at = (size_t)(m0 + m) * kpad + r0 + r;
      if (MODE == MODE_GLU) {
        lo = __bfloat162float(glu_bf16(x[at], u[at]));
        hi = __bfloat162float(glu_bf16(x[at + half], u[at + half]));
      } else {
        lo = __bfloat162float(x[at]);
        hi = __bfloat162float(x[at + half]);
      }
    }
    xs[0][m][r] = lo;
    xs[1][m][r] = hi;
  }
  __syncthreads();

  float acc[GV_MT][GV_COLS];
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    const int hg = half / group;
    const int per_ty = GV_KS / GV_TY;
    int cur_g = -1;
    float sl[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
    // MODE_V3: unscaled sums of the current group's rows
    float pl[GV_MT][GV_COLS], ph[GV_MT][GV_COLS];
#pragma unroll
    for (int m = 0; m < GV_MT; ++m)
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c) pl[m][c] = ph[m][c] = 0.f;
    auto flush = [&]() {
#pragma unroll
      for (int m = 0; m < GV_MT; ++m)
#pragma unroll
        for (int c = 0; c < GV_COLS; ++c) {
          acc[m][c] += pl[m][c] * sl[c];
          acc[m][c] += ph[m][c] * sh[c];
          pl[m][c] = ph[m][c] = 0.f;
        }
    };
    for (int rr = ty * per_ty; rr < (ty + 1) * per_ty; ++rr) {
      const int r = r0 + rr;
      if (r >= half) break;
      const int gi = r / group;
      if (gi != cur_g) {
        if (MODE == MODE_V3 && cur_g >= 0) flush();
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
      float wl[4], wh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (MODE == MODE_V3) {
          wl[c] = (float)lo_nibble(bytes[c]);
          wh[c] = (float)hi_nibble(bytes[c]);
        } else {
          wl[c] = deq_bf16(lo_nibble(bytes[c]), sl[c]);
          wh[c] = deq_bf16(hi_nibble(bytes[c]), sh[c]);
        }
      }
#pragma unroll
      for (int m = 0; m < GV_MT; ++m) {
        const float xl = xs[0][m][rr], xh = xs[1][m][rr];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (MODE == MODE_V3) {
            pl[m][c] = fmaf(xl, wl[c], pl[m][c]);
            ph[m][c] = fmaf(xh, wh[c], ph[m][c]);
          } else {
            acc[m][c] = fmaf(xl, wl[c], acc[m][c]);
            acc[m][c] = fmaf(xh, wh[c], acc[m][c]);
          }
        }
      }
    }
    if (MODE == MODE_V3 && cur_g >= 0) flush();
  }

#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) red[ty][m][tx * GV_COLS + c] = acc[m][c];
  __syncthreads();

  for (int i = tid; i < GV_MT * GV_BN; i += GV_TX * GV_TY) {
    const int m = i / GV_BN, col = i % GV_BN;
    const int n = blockIdx.x * GV_BN + col;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < GV_TY; ++t) s += red[t][m][col];
      partial[((size_t)split * M + m0 + m) * N + n] = s;
    }
  }
}

// ---------------------------------------------------------------- large M
template <int MODE>
__global__ void __launch_bounds__(MM_THREADS)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ u,
                const int8_t* __restrict__ q,
                const float* __restrict__ scale,
                const __nv_bfloat16* __restrict__ res,
                __nv_bfloat16* __restrict__ out,
                int M, int half, int N, int group) {
  // xs[h]: the two K halves of x; ws[h]: dequantized weights, n-major
  __shared__ __align__(16) __nv_bfloat16 xs[2][MM_BM][MM_LD];
  __shared__ __align__(16) __nv_bfloat16 ws[2][MM_BN][MM_LD];
  const int tid = threadIdx.x;
  const MmLane t(tid);
  const int m_blk = blockIdx.y * MM_BM;
  const int n_blk = blockIdx.x * MM_BN;
  const size_t kpad = 2 * (size_t)half;
  const int hg = half / group;

  float acc[4][4][4];
  mm_zero(acc);

  for (int k0 = 0; k0 < half; k0 += MM_BK) {
    mm_load_x<MODE == MODE_GLU>(xs[0], x, u, kpad, m_blk, M, k0, half, tid);
    mm_load_x<MODE == MODE_GLU>(xs[1], x, u, kpad, m_blk, M, half + k0,
                                (int)kpad, tid);
    {
      const int r = tid / (MM_BN / 16);         // 0..31
      const int c16 = (tid % (MM_BN / 16)) * 16;
      const int n = n_blk + c16;
      const int kr = k0 + r;
      if (n < N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)kr * N + n);
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
        const int gi = kr / group;
        const float* slo = scale + (size_t)gi * N + n;
        const float* shi = scale + (size_t)(hg + gi) * N + n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v = bytes[j];
          const float fl = (float)lo_nibble(v), fh = (float)hi_nibble(v);
          ws[0][c16 + j][r] =
              __float2bfloat16_rn(MODE == MODE_V3 ? fl : fl * slo[j]);
          ws[1][c16 + j][r] =
              __float2bfloat16_rn(MODE == MODE_V3 ? fh : fh * shi[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          ws[0][c16 + j][r] = __float2bfloat16_rn(0.f);
          ws[1][c16 + j][r] = __float2bfloat16_rn(0.f);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (MODE == MODE_V3) {
        // this step's 32 rows lie in one group (group % 32 == 0): their
        // unscaled f32 sum, times the group's scale, into the running sum
        float part[4][4][4];
        mm_zero(part);
        mm_step(part, xs[h], ws[h], t);
        const float* srow = scale + (size_t)(h * hg + k0 / group) * N;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n_blk + t.wn * 32 + ni * 8 + t.tig * 2;
          const float s0 = col < N ? srow[col] : 0.f;
          const float s1 = col < N ? srow[col + 1] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            acc[mi][ni][0] += part[mi][ni][0] * s0;
            acc[mi][ni][1] += part[mi][ni][1] * s1;
            acc[mi][ni][2] += part[mi][ni][2] * s0;
            acc[mi][ni][3] += part[mi][ni][3] * s1;
          }
        }
      } else {
        mm_step(acc, xs[h], ws[h], t);
      }
    }
    __syncthreads();
  }
  mm_store(acc, out, M, N, m_blk, n_blk, t, nullptr,
           MODE == MODE_GLU ? res : nullptr);
}

template <int MODE>
int launch_gemv(const void* x, const void* u, const void* q, const void* scale,
                const void* res, void* partial, void* out, int M, int half,
                int N, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (half + GV_KS - 1) / GV_KS;
  dim3 grid((N + GV_BN - 1) / GV_BN, splits, (M + GV_MT - 1) / GV_MT);
  int4_gemv_kernel<MODE><<<grid, dim3(GV_TX, GV_TY), 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(partial), M, half,
      N, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_splitk_reduce(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out),
      splits, M, N, nullptr, nullptr,
      static_cast<const __nv_bfloat16*>(res), s);
}

template <int MODE>
int launch_mma(const void* x, const void* u, const void* q, const void* scale,
               const void* res, void* out, int M, int half, int N, int group,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  int4_mma_kernel<MODE><<<grid, MM_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), M, half, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

// Split-K GEMV for M <= 32. partial: [ceil(half / 128), M, N] f32 scratch.
extern "C" int a3_int4_gemv(const void* x, const void* q, const void* scale,
                            void* partial, void* out, int M, int half, int N,
                            int group, void* stream) {
  return launch_gemv<MODE_V1>(x, nullptr, q, scale, nullptr, partial, out, M,
                              half, N, group, stream);
}

extern "C" int a3_int4_gemv_v3(const void* x, const void* q, const void* scale,
                               void* partial, void* out, int M, int half,
                               int N, int group, void* stream) {
  return launch_gemv<MODE_V3>(x, nullptr, q, scale, nullptr, partial, out, M,
                              half, N, group, stream);
}

// res + (silu(g) * u) @ W; g, u [M, 2 * half], res and out [M, N].
extern "C" int a3_int4_gemv_glu(const void* g, const void* u, const void* q,
                                const void* scale, const void* res,
                                void* partial, void* out, int M, int half,
                                int N, int group, void* stream) {
  return launch_gemv<MODE_GLU>(g, u, q, scale, res, partial, out, M, half, N,
                               group, stream);
}

// Tensor-core tiled product for larger M. half must be a multiple of 32;
// for the v3 form so must group.
extern "C" int a3_int4_mma(const void* x, const void* q, const void* scale,
                           void* out, int M, int half, int N, int group,
                           void* stream) {
  return launch_mma<MODE_V1>(x, nullptr, q, scale, nullptr, out, M, half, N,
                             group, stream);
}

extern "C" int a3_int4_mma_v3(const void* x, const void* q, const void* scale,
                              void* out, int M, int half, int N, int group,
                              void* stream) {
  return launch_mma<MODE_V3>(x, nullptr, q, scale, nullptr, out, M, half, N,
                             group, stream);
}

extern "C" int a3_int4_mma_glu(const void* g, const void* u, const void* q,
                               const void* scale, const void* res, void* out,
                               int M, int half, int N, int group,
                               void* stream) {
  return launch_mma<MODE_GLU>(g, u, q, scale, res, out, M, half, N, group,
                              stream);
}
