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
// - gemv_cluster_kernel<MODE, MT> (M <= 32, gemv_cluster.cuh): one launch,
//   no scratch in device memory; a thread block cluster of C blocks splits
//   K for each 128 output columns, a producer warp feeds the stages by TMA,
//   each weight is dequantized once into mma.sync A fragments, and the
//   blocks add their partials through distributed shared memory in rank
//   order (a relaunch gives the same bits).
// - int4_mma_kernel (large M): the Hopper tile of matmul_common.cuh (TMA
//   ring of x, packed-byte and scale boxes; weights dequantized to bf16 in
//   shared memory while the previous step's wgmma products run). Per
//   weight, the dequantization costs a few integer and float instructions
//   against the 2 BM multiply-adds the tensor cores do with it, so the
//   block is 256 rows high (128 for v3).
//   MODE_GLU first forms silu(g) * u once per element (glu_prepass_kernel)
//   into a scratch that the caller allocates, so that the N / 128 column
//   blocks that read each element do not form it again.

#include "gemv_cluster.cuh"

namespace {

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
  if (!gv_valid(M, half, N, group, xld, 8, Cn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_V1)
    return gv_launch_m<MODE_V1>(x, u, q, scale, nullptr, res, out, M, half,
                                N, group, xld, Cn, s);
  if (mode == MODE_V3)
    return gv_launch_m<MODE_V3>(x, u, q, scale, nullptr, res, out, M, half,
                                N, group, xld, Cn, s);
  if (mode == MODE_GLU)
    return gv_launch_m<MODE_GLU>(x, u, q, scale, nullptr, res, out, M, half,
                                 N, group, xld, Cn, s);
  return (int)cudaErrorInvalidValue;
}

// Clusters of Cn blocks of the GEMV in ``mode`` at M rows and this group
// that the card holds at once, or a negative cudaError_t.
extern "C" int a3_int4_gemv_clusters(int mode, int M, int group, int Cn) {
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
