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
//   scale, and added to the running sum. The GEMV's runs are 16 rows per
//   thread, so it scales a 64-row group in 4 pieces; the tiled form's step
//   is 64 rows and lies in one group (group % 64 == 0), so it scales a
//   group in one piece, as the TPU kernel does.
// - MODE_GLU: x is formed from two inputs as bf16(sigmoid(g) * g * u) in
//   f32, the weights are as in MODE_V1, and a residual is added in f32
//   before the one rounding at the store: res + (silu(g) * u) @ W.
//
// What bounds it on an H100: at decode (M = batch <= 32) the weight stream,
// K*N/2 bytes per call, and nothing else; at prefill (M ~ 1500-6000) the
// multiply-adds (at M 5948, 5120 x 5120: 0.32 ms at the published 989
// TFLOP/s bf16 rate against 0.04 ms for its bytes at 3.35 TB/s). Two
// launch shapes follow from that:
//
// - int4_gemv_kernel (small M): a split-K GEMV. A block owns 128 columns and
//   128 packed rows; its 32 x 8 threads read 4 contiguous bytes each, so a
//   warp streams one 128-byte row segment per step. x is staged in shared
//   memory, group scales are reloaded only when the group changes, and the
//   per-split f32 partials are summed in a fixed order by a second pass
//   (splitk_reduce_kernel, which also adds the GLU residual, once), so
//   results do not change from run to run.
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
