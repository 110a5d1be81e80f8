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
// - gemv_cluster_kernel<MODE_INT8, MT> (M <= 32, gemv_cluster.cuh): one
//   launch, no scratch. A thread block cluster splits K for each 128 output
//   columns; a producer warp brings each 64-row stage of q ([64][128]
//   bytes) and of x ([8 MT rows][64] bf16) by TMA, rows and columns past K
//   as zeros, so K need not divide a stage (the wrapper pads x's rows to a
//   multiple of 8 elements where K is not, for the map's 16-byte strides);
//   each byte becomes bf16 once in registers (under the exponent of 2^23),
//   the products run on mma.sync m16n8k16 in f32, the cluster adds its
//   partials through distributed shared memory in rank order, and the
//   column scale multiplies the finished sum at the store.
// - int8_mma_kernel (larger M): the Hopper tile of matmul_common.cuh in
//   MODE_INT8: x and q come in by TMA ([BM][64] bf16 and [64][128] byte
//   boxes; rows and columns past K, and rows past M, as zeros, so K need
//   not divide a step), each 64-row step of q becomes bf16 in shared memory
//   (exact) while the previous step's wgmma products run, and the scale is
//   applied to the finished f32 sum at the store.

#include "gemv_cluster.cuh"

namespace {

__global__ void __launch_bounds__(QmmCfg<MODE_INT8>::THREADS, 1)
int8_mma_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap s_map,
                const float* __restrict__ col_scale,
                const bf16* __restrict__ res, bf16* __restrict__ out, int M,
                int K, int N, int group) {
  qmm_tile<MODE_INT8>(&x_map, &q_map, &s_map, col_scale, res, out, M, K, N,
                      group);
}

}  // namespace

// The GEMV for M <= 32, one launch: x [M] rows of K bf16, ``xld`` elements
// apart (xld % 8 == 0, xld >= K); q [K, N] int8; scale [N] f32; out [M, N];
// N % 16 == 0; Cn blocks a cluster (1-8) split K.
extern "C" int a3_int8_gemv(const void* x, const void* q, const void* scale,
                            void* out, int M, int K, int N, int xld, int Cn,
                            void* stream) {
  if (!gv_valid(M, K, N, 1, xld, 8, Cn)) return (int)cudaErrorInvalidValue;
  return gv_launch_m<MODE_INT8>(x, nullptr, q, nullptr, scale, nullptr, out,
                                M, K, N, GV_SR, xld, Cn,
                                static_cast<cudaStream_t>(stream));
}

// Clusters of Cn blocks of the int8 GEMV at M rows that the card holds at
// once, or a negative cudaError_t.
extern "C" int a3_int8_gemv_clusters(int M, int Cn) {
  return gv_clusters_m<MODE_INT8>(M, GV_SR, Cn);
}

// Tensor-core tiled product for M > 32: K % 8 == 0, N % 16 == 0, every
// pointer 16-byte aligned.
extern "C" int a3_int8_mma(const void* x, const void* q, const void* scale,
                           void* out, int M, int K, int N, void* stream) {
  return qmm_launch<MODE_INT8>(int8_mma_kernel, x, q, scale, nullptr, out, M,
                               K, N, 1, static_cast<cudaStream_t>(stream));
}
