// One block of exact softmax attention on the SIMT units, used by
// vit_attention.cu (K10, non-causal tower attention); flash_attention_bwd.cu
// takes its constants and warp reductions for K9b. The flash forward (K2)
// and the dq backward (K9a) have moved to the tensor-core tile of
// attention_mma.cuh.
//
// A block owns AT_BQ = 16 query rows of one (batch, head): 8 warps, 2 rows
// each. Keys and values stream through shared memory in tiles of 32 (one key
// per lane). For each tile a lane computes its key's score against the
// warp's rows in f32, the warp keeps an online softmax in base 2 (running
// max and sum, rescaled per tile), and lane l accumulates output dims
// l, l + 32, ... so the score matrix never reaches device memory.
//
// Masked scores are -inf; a row that has seen no visible key keeps p = 0,
// and a row with no visible key at all writes zeros (its sum stays 0 and is
// replaced by 1), the l == 0 guard of the TPU kernels.
//
// With a non-null ``lse`` the block also writes each row's natural-log
// log-sum-exp of the scaled scores, m * ln 2 + ln(l) (m is the base-2 max),
// which the backward kernels consume; a row with no visible key writes -inf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace a3 {

constexpr int AT_WARPS = 8;
constexpr int AT_RPW = 2;                 // query rows per warp
constexpr int AT_BQ = AT_WARPS * AT_RPW;  // query rows per block
constexpr int AT_BK = 32;                 // keys per tile
constexpr int AT_DMAX = 128;              // largest head dim
constexpr float AT_LN2 = 0.6931471805599453f;
constexpr float AT_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, o point at row 0 of this (batch, head); rows are row_stride elements
// apart. Query row r may see key c iff c < kv_len and, when causal,
// c <= r + offset (right-aligned: offset = kv_len - q_len). NC = ceil(D/32).
// ``lse``, when not null, points at row 0's entry; rows are contiguous.
template <int NC>
__device__ void attention_block(const __nv_bfloat16* __restrict__ q, long q_stride,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, long kv_stride,
                                __nv_bfloat16* __restrict__ o, long o_stride,
                                int q0, int n_rows, int kv_len, int D,
                                float scale_log2, bool causal, int offset,
                                float* __restrict__ lse = nullptr) {
  __shared__ float qs[AT_BQ][AT_DMAX];
  __shared__ float ks[AT_BK][AT_DMAX + 1];
  __shared__ float vs[AT_BK][AT_DMAX];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < AT_BQ * AT_DMAX; i += AT_WARPS * 32) {
    const int r = i / AT_DMAX, d = i % AT_DMAX;
    float val = 0.f;
    if (q0 + r < n_rows && d < D)
      val = __bfloat162float(q[(long)(q0 + r) * q_stride + d]) * scale_log2;
    qs[r][d] = val;
  }

  float m_i[AT_RPW], l_i[AT_RPW], acc[AT_RPW][NC];
#pragma unroll
  for (int rr = 0; rr < AT_RPW; ++rr) {
    m_i[rr] = -INFINITY;
    l_i[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  int kv_end = kv_len;
  if (causal) {
    const int last = min(q0 + AT_BQ, n_rows) - 1;
    kv_end = min(kv_len, last + offset + 1);
  }

  for (int kt = 0; kt < kv_end; kt += AT_BK) {
    __syncthreads();  // the previous tile (and, first time, qs) is settled
    for (int i = tid; i < AT_BK * AT_DMAX; i += AT_WARPS * 32) {
      const int j = i / AT_DMAX, d = i % AT_DMAX;
      float kv = 0.f, vv = 0.f;
      if (kt + j < kv_end && d < D) {
        kv = __bfloat162float(k[(long)(kt + j) * kv_stride + d]);
        vv = __bfloat162float(v[(long)(kt + j) * kv_stride + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    const int c = kt + lane;
#pragma unroll
    for (int rr = 0; rr < AT_RPW; ++rr) {
      const int rl = warp * AT_RPW + rr;
      const int r = q0 + rl;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[rl][d], ks[lane][d], s);
      const bool ok = c < kv_end && (!causal || c <= r + offset);
      s = ok ? s : -INFINITY;
      const float m_new = fmaxf(m_i[rr], warp_max(s));
      float p, alpha;
      if (m_new == -INFINITY) {
        p = 0.f;
        alpha = 1.f;
      } else {
        p = exp2f(s - m_new);
        alpha = exp2f(m_i[rr] - m_new);
      }
      l_i[rr] = l_i[rr] * alpha + warp_sum(p);
      m_i[rr] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[rr][cc] *= alpha;
#pragma unroll 8
      for (int j = 0; j < AT_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[rr][cc] = fmaf(pj, vs[j][lane + 32 * cc], acc[rr][cc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < AT_RPW; ++rr) {
    const int r = q0 + warp * AT_RPW + rr;
    if (r >= n_rows) continue;
    const float inv = 1.f / (l_i[rr] == 0.f ? 1.f : l_i[rr]);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) o[(long)r * o_stride + d] = __float2bfloat16_rn(acc[rr][cc] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[r] = l_i[rr] == 0.f ? -INFINITY : m_i[rr] * AT_LN2 + logf(l_i[rr]);
  }
}

}  // namespace a3
