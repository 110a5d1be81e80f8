// Shared pieces of the split-KV decode kernels over the decode cache
// (decode_attention.cu, decode_attention_q8.cu): the
// tile constants, the row loaders and the pass that combines the per-split
// partial (max, sum, acc) of an online softmax in base 2 into the output.
// Every including source gets its own copy (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DC_WARPS = 4;
constexpr int DC_CHUNK = 256;                  // cache rows per block
constexpr int DC_SUB = DC_CHUNK / DC_WARPS;    // rows per warp
constexpr int DC_D = 128;
constexpr int DC_UNROLL = 4;

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}

// Four int8 values of a quantized cache row as floats.
__device__ __forceinline__ void load4_i8(const int8_t* p, float* out) {
  const char4 raw = *reinterpret_cast<const char4*>(p);
  out[0] = (float)raw.x;
  out[1] = (float)raw.y;
  out[2] = (float)raw.z;
  out[3] = (float)raw.w;
}

// One block per output row, one thread per dim: out = sum_p w_p acc_p /
// sum_p w_p l_p with w_p = 2^(m_p - max m). A row whose partials are all
// empty (no visible key) gives zeros.
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      __nv_bfloat16* __restrict__ out, int P) {
  const long row = blockIdx.x;
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int p = 0; p < P; ++p) mx = fmaxf(mx, part_m[row * P + p]);
  float L = 0.f, A = 0.f;
  if (mx != -INFINITY) {
    for (int p = 0; p < P; ++p) {
      const float w = exp2f(part_m[row * P + p] - mx);
      L += w * part_l[row * P + p];
      A += w * part_acc[(row * P + p) * DC_D + d];
    }
  }
  out[row * DC_D + d] = __float2bfloat16_rn(A / (L == 0.f ? 1.f : L));
}

}  // namespace
