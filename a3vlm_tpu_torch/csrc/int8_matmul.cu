// int8 weight-only matmul for Hopper (sm_90a).
//
// Replaces a3vlm_tpu/ops/quant_matmul.py::_int8_kernel (tiled by
// _int8_matmul_2d). Computes
//
//     out[M, N] = (x[M, K] @ float(q[K, N])) * s[n]
//
// for x bf16, q int8 and one f32 scale per output channel. int8 values are
// exact in bf16 and in f32, so the products are those of the TPU kernel;
// they accumulate in f32, the scale is applied once to the finished sum,
// and the output is rounded to bf16 once. K is not padded and N need not
// divide a tile (N % 16 == 0 is all the 16-byte weight loads need).
//
// What bounds it on an H100: at decode (M <= 32) the weight stream, K*N
// bytes per call; at prefill the multiply-adds. As for the int4 kernels:
//
// - int8_gemv_kernel (M <= 32): a split-K GEMV. A block owns 512 columns
//   and 128 rows of K; each of its 32 x 4 threads reads 16 contiguous bytes
//   of a weight row, so a warp streams 512 bytes of it per step. x is staged
//   in shared memory as f32; the per-split f32 partials are summed in a
//   fixed order, and scaled, by splitk_reduce_kernel.
// - int8_mma_kernel (larger M): a 128 x 128 output tile per block; every
//   32-row K step turns a [32, 128] tile of q into bf16 in shared memory and
//   runs mma.sync m16n8k16 (bf16 in, f32 accumulate); the scale is applied at
//   the store.

#include "matmul_common.cuh"

namespace {

constexpr int G8_TX = 32;                // threads along N
constexpr int G8_TY = 4;                 // row slices per block
constexpr int G8_COLS = 16;              // columns per thread
constexpr int G8_BN = G8_TX * G8_COLS;   // 512 columns per block
constexpr int G8_KS = 128;               // rows of K per split
constexpr int G8_MT = 4;                 // rows of x per block

__global__ void __launch_bounds__(G8_TX * G8_TY)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q,
                 float* __restrict__ partial, int M, int K, int N) {
  __shared__ float xs[G8_MT][G8_KS];
  __shared__ float red[G8_TY][G8_MT][G8_BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * G8_TX + tx;
  const int n0 = blockIdx.x * G8_BN + tx * G8_COLS;
  const int split = blockIdx.y;
  const int r0 = split * G8_KS;
  const int m0 = blockIdx.z * G8_MT;

  for (int i = tid; i < G8_MT * G8_KS; i += G8_TX * G8_TY) {
    const int m = i / G8_KS, r = i % G8_KS;
    float v = 0.f;
    if (m0 + m < M && r0 + r < K)
      v = __bfloat162float(x[(size_t)(m0 + m) * K + r0 + r]);
    xs[m][r] = v;
  }
  __syncthreads();

  float acc[G8_MT][G8_COLS];
#pragma unroll
  for (int m = 0; m < G8_MT; ++m)
#pragma unroll
    for (int c = 0; c < G8_COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    const int per_ty = G8_KS / G8_TY;
    for (int rr = ty * per_ty; rr < (ty + 1) * per_ty; ++rr) {
      const int r = r0 + rr;
      if (r >= K) break;
      const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)r * N + n0);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
      float w[G8_COLS];
#pragma unroll
      for (int c = 0; c < G8_COLS; ++c) w[c] = (float)bytes[c];
#pragma unroll
      for (int m = 0; m < G8_MT; ++m) {
        const float xv = xs[m][rr];
#pragma unroll
        for (int c = 0; c < G8_COLS; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < G8_MT; ++m)
#pragma unroll
    for (int c = 0; c < G8_COLS; ++c) red[ty][m][tx * G8_COLS + c] = acc[m][c];
  __syncthreads();

  for (int i = tid; i < G8_MT * G8_BN; i += G8_TX * G8_TY) {
    const int m = i / G8_BN, col = i % G8_BN;
    const int n = blockIdx.x * G8_BN + col;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < G8_TY; ++t) s += red[t][m][col];
      partial[((size_t)split * M + m0 + m) * N + n] = s;
    }
  }
}

__global__ void __launch_bounds__(MM_THREADS)
int8_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 xs[MM_BM][MM_LD];
  __shared__ __align__(16) __nv_bfloat16 ws[MM_BN][MM_LD];  // n-major
  const int tid = threadIdx.x;
  const MmLane t(tid);
  const int m_blk = blockIdx.y * MM_BM;
  const int n_blk = blockIdx.x * MM_BN;

  float acc[4][4][4];
  mm_zero(acc);

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    mm_load_x<false>(xs, x, nullptr, (size_t)K, m_blk, M, k0, K, tid);
    {
      const int r = tid / (MM_BN / 16);         // 0..31
      const int c16 = (tid % (MM_BN / 16)) * 16;
      const int n = n_blk + c16;
      const int kr = k0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (n < N && kr < K)
        raw = *reinterpret_cast<const uint4*>(q + (size_t)kr * N + n);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        ws[c16 + j][r] = __float2bfloat16_rn((float)bytes[j]);
    }
    __syncthreads();
    mm_step(acc, xs, ws, t);
    __syncthreads();
  }
  mm_store(acc, out, M, N, m_blk, n_blk, t, scale, nullptr);
}

}  // namespace

// Split-K GEMV for M <= 32. partial: [ceil(K / 128), M, N] f32 scratch;
// scale: [N] f32. N % 16 == 0.
extern "C" int a3_int8_gemv(const void* x, const void* q, const void* scale,
                            void* partial, void* out, int M, int K, int N,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (K + G8_KS - 1) / G8_KS;
  dim3 grid((N + G8_BN - 1) / G8_BN, splits, (M + G8_MT - 1) / G8_MT);
  int8_gemv_kernel<<<grid, dim3(G8_TX, G8_TY), 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<float*>(partial), M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_splitk_reduce(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out),
      splits, M, N, static_cast<const float*>(scale), nullptr, nullptr, s);
}

// Tensor-core tiled product for larger M. K % 8 == 0, N % 16 == 0.
extern "C" int a3_int8_mma(const void* x, const void* q, const void* scale,
                           void* out, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  int8_mma_kernel<<<grid, MM_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K,
      N);
  return (int)cudaGetLastError();
}
