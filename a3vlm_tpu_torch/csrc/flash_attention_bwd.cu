// Flash-attention backward for Hopper (sm_90a): K9a (dq) and K9b (dk, dv).
//
// Replaces a3vlm_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:358)
// and ::_flash_bwd_dkv_kernel (:414), reached through _flash_backward_bhsd.
// Inputs: q, do [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] bf16; lse (the
// forward's natural-log log-sum-exp, flash_attention.cu) and
// delta = rowsum(do * o) [B, Hq, Sq] f32. Outputs dq [B, Hq, Sq, D] and
// dk, dv [B, Hkv, Skv, D] bf16, the GQA group already summed. The mask is
// K2's: row r sees key c iff c < skv_actual and, when causal,
// c <= r + skv_actual - sq_actual; a row with lse = -inf (no visible key)
// contributes nothing.
//
// Per visible (row, key) pair both kernels recompute the score s = q.k,
// p = exp2(s * scale * log2 e - lse * log2 e), dp = do.v and
// ds = p (dp - delta) scale, rounding p and ds to bf16 before the products
// that consume them, as the TPU kernels do (:385, :440, :450).
//
// What bounds them on an H100: like K2, the products (per pair 4 D-long
// multiply-adds in each kernel, ~2.5x K2's work in all), run here on the
// SIMT units far below the tensor-core rate; device memory is not the
// limit, since every staged tile is reused by 16 or 32 rows or keys from
// shared memory and no score leaves the SM. Blocks run unordered, so the
// TPU grid's carried accumulators become loops inside the block, and each
// output element is owned by one thread and written once: no atomics, so
// the result is deterministic.
//
// - K9a: one block per (b, q head, 16-row query tile), 2 rows per warp;
//   keys stream in tiles of 32 (one per lane) up to the tile's causal
//   limit; lane l accumulates dq dims l, l + 32, ... in f32.
// - K9b: one block per (b, kv head, 32-key tile), 4 keys per warp; the
//   block loops over the q heads of the GQA group and over 32-row query
//   tiles (one row per lane) from the first row that can see the tile, so
//   the group sum the TPU caller does over a [B, Hq, Skv, D] buffer
//   (:615-617) happens in registers.
// mma.sync / wgmma for the products is later work.

#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = a3::AT_WARPS * 32;
constexpr int RPW = a3::AT_RPW;           // K9a: query rows per warp
constexpr int DQ_BQ = a3::AT_BQ;          // K9a: query rows per block
constexpr int BK = 32;                    // K9a: keys per tile
constexpr int KPW = 4;                    // K9b: keys per warp
constexpr int KV_BK = a3::AT_WARPS * KPW; // K9b: keys per block
constexpr int KV_BQ = 32;                 // K9b: query rows per tile
constexpr int DMAX = a3::AT_DMAX;
constexpr int DPAD = DMAX + 1;            // row stride of lane-indexed tiles

constexpr size_t DQ_SMEM = sizeof(float) * (2 * DQ_BQ * DMAX + 2 * BK * DPAD);
constexpr size_t DKV_SMEM =
    sizeof(float) * (2 * KV_BQ * DPAD + 2 * KV_BK * DMAX);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
                    int skv_actual, float scale_log2, float scale,
                    int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [DQ_BQ][DMAX], read as a broadcast
  float* dos = qs + DQ_BQ * DMAX;    // [DQ_BQ][DMAX]
  float* ks = dos + DQ_BQ * DMAX;    // [BK][DPAD], key j in row j
  float* vs = ks + BK * DPAD;        // [BK][DPAD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * DQ_BQ;
  const long row0 = ((long)b * Hq + h) * Sq;
  const long kv0 = ((long)b * Hkv + h / (Hq / Hkv)) * Skv;
  const int offset = skv_actual - sq_actual;

  for (int i = tid; i < DQ_BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    float qv = 0.f, gv = 0.f;
    if (q0 + r < Sq && d < D) {
      const long at = (row0 + q0 + r) * D + d;
      qv = __bfloat162float(q[at]);
      gv = __bfloat162float(dout[at]);
    }
    qs[i] = qv;
    dos[i] = gv;
  }

  bool live[RPW];
  float lse2[RPW], dlt[RPW], acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    const float l = r < Sq ? lse[row0 + r] : -INFINITY;
    live[rr] = l > -INFINITY;
    lse2[rr] = live[rr] ? l * a3::AT_LOG2E : 0.f;
    dlt[rr] = live[rr] ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[rr][cc] = 0.f;
  }

  int kv_end = skv_actual;
  if (causal) {
    const int last = min(q0 + DQ_BQ, Sq) - 1;
    kv_end = min(skv_actual, last + offset + 1);
  }

  for (int kt = 0; kt < kv_end; kt += BK) {
    __syncthreads();  // the previous tile (and, first time, qs/dos) settled
    for (int i = tid; i < BK * DMAX; i += THREADS) {
      const int j = i / DMAX, d = i % DMAX;
      float kv = 0.f, vv = 0.f;
      if (kt + j < kv_end && d < D) {
        kv = __bfloat162float(k[(kv0 + kt + j) * D + d]);
        vv = __bfloat162float(v[(kv0 + kt + j) * D + d]);
      }
      ks[j * DPAD + d] = kv;
      vs[j * DPAD + d] = vv;
    }
    __syncthreads();

    const int c = kt + lane;
    const float* kr = ks + lane * DPAD;
    const float* vr = vs + lane * DPAD;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int rl = warp * RPW + rr;
      const int r = q0 + rl;
      const float* qr = qs + rl * DMAX;
      const float* gr = dos + rl * DMAX;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(gr[d], vr[d], dp);
      }
      const bool ok = live[rr] && c < kv_end && (!causal || c <= r + offset);
      const float p = ok ? exp2f(s * scale_log2 - lse2[rr]) : 0.f;
      const float ds = bf16_round(p * (dp - dlt[rr]) * scale);
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[rr][cc] = fmaf(dsj, ks[j * DPAD + lane + 32 * cc], acc[rr][cc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    if (r >= Sq) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) dq[(row0 + r) * D + d] = __float2bfloat16_rn(acc[rr][cc]);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                     int D, int sq_actual, int skv_actual, float scale_log2,
                     float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [KV_BQ][DPAD], row j of the q tile
  float* dos = qs + KV_BQ * DPAD;    // [KV_BQ][DPAD]
  float* ks = dos + KV_BQ * DPAD;    // [KV_BK][DMAX], read as a broadcast
  float* vs = ks + KV_BK * DMAX;     // [KV_BK][DMAX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * KV_BK;
  const int group = Hq / Hkv;
  const long kv0 = ((long)b * Hkv + kvh) * Skv;
  const int offset = skv_actual - sq_actual;

  for (int i = tid; i < KV_BK * DMAX; i += THREADS) {
    const int j = i / DMAX, d = i % DMAX;
    float kv = 0.f, vv = 0.f;
    if (k0 + j < skv_actual && d < D) {
      kv = __bfloat162float(k[(kv0 + k0 + j) * D + d]);
      vv = __bfloat162float(v[(kv0 + k0 + j) * D + d]);
    }
    ks[i] = kv;
    vs[i] = vv;
  }

  float dka[KPW][NC], dva[KPW][NC];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dka[kk][cc] = dva[kk][cc] = 0.f;

  // a key tile gets gradient only from rows r >= c - offset (causal), and
  // none at all when it lies wholly in the padding
  const int r_begin = causal ? max(0, k0 - offset) : 0;
  const int rt_begin = k0 < skv_actual ? r_begin / KV_BQ * KV_BQ : Sq;
  const float* kw = ks + warp * KPW * DMAX;
  const float* vw = vs + warp * KPW * DMAX;

  for (int g = 0; g < group; ++g) {
    const long row0 = ((long)b * Hq + kvh * group + g) * Sq;
    for (int rt = rt_begin; rt < Sq; rt += KV_BQ) {
      __syncthreads();  // the previous tile (and, first time, ks/vs) settled
      for (int i = tid; i < KV_BQ * DMAX; i += THREADS) {
        const int j = i / DMAX, d = i % DMAX;
        float qv = 0.f, gv = 0.f;
        if (rt + j < Sq && d < D) {
          const long at = (row0 + rt + j) * D + d;
          qv = __bfloat162float(q[at]);
          gv = __bfloat162float(dout[at]);
        }
        qs[j * DPAD + d] = qv;
        dos[j * DPAD + d] = gv;
      }
      __syncthreads();

      const int r = rt + lane;
      const float l = r < Sq ? lse[row0 + r] : -INFINITY;
      const bool live = l > -INFINITY;
      const float l2 = live ? l * a3::AT_LOG2E : 0.f;
      const float dl = live ? delta[row0 + r] : 0.f;

      float s[KPW], dp[KPW];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) s[kk] = dp[kk] = 0.f;
      const float* qr = qs + lane * DPAD;
      const float* gr = dos + lane * DPAD;
      for (int d = 0; d < D; ++d) {
        const float qv = qr[d], gv = gr[d];
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          s[kk] = fmaf(qv, kw[kk * DMAX + d], s[kk]);
          dp[kk] = fmaf(gv, vw[kk * DMAX + d], dp[kk]);
        }
      }
      float pb[KPW], dsb[KPW];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        const int c = k0 + warp * KPW + kk;
        const bool ok = live && c < skv_actual && (!causal || c <= r + offset);
        const float p = ok ? exp2f(s[kk] * scale_log2 - l2) : 0.f;
        pb[kk] = bf16_round(p);
        dsb[kk] = bf16_round(p * (dp[kk] - dl) * scale);
      }

#pragma unroll 4
      for (int j = 0; j < KV_BQ; ++j) {
        float qj[NC], gj[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          qj[cc] = qs[j * DPAD + lane + 32 * cc];
          gj[cc] = dos[j * DPAD + lane + 32 * cc];
        }
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const float pj = __shfl_sync(0xffffffffu, pb[kk], j);
          const float dsj = __shfl_sync(0xffffffffu, dsb[kk], j);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            dva[kk][cc] = fmaf(pj, gj[cc], dva[kk][cc]);
            dka[kk][cc] = fmaf(dsj, qj[cc], dka[kk][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int c = k0 + warp * KPW + kk;
    if (c >= Skv) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) {
        dk[(kv0 + c) * D + d] = __float2bfloat16_rn(dka[kk][cc]);
        dv[(kv0 + c) * D + d] = __float2bfloat16_rn(dva[kk][cc]);
      }
    }
  }
}

template <int NC>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, int D, int sq_actual, int skv_actual,
              float scale_log2, float scale, int causal, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, Hq, B);
  flash_bwd_dq_kernel<NC><<<grid, THREADS, DQ_SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Hq, Hkv, Sq, Skv, D, sq_actual, skv_actual,
      scale_log2, scale, causal);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
               int skv_actual, float scale_log2, float scale, int causal,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + KV_BK - 1) / KV_BK, Hkv, B);
  flash_bwd_dkv_kernel<NC><<<grid, THREADS, DKV_SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq, Hkv, Sq, Skv, D,
      sq_actual, skv_actual, scale_log2, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// K9a. scale = D^-0.5, scale_log2 = scale * log2 e.
extern "C" int a3_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int Hq,
                               int Hkv, int Sq, int Skv, int D, int sq_actual,
                               int skv_actual, float scale_log2, float scale,
                               int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq<2>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, D,
                        sq_actual, skv_actual, scale_log2, scale, causal, s);
  if (D <= 96)
    return launch_dq<3>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, D,
                        sq_actual, skv_actual, scale_log2, scale, causal, s);
  return launch_dq<4>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, D,
                      sq_actual, skv_actual, scale_log2, scale, causal, s);
}

// K9b: dk, dv per kv head.
extern "C" int a3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Hq, int Hkv, int Sq, int Skv, int D,
                                int sq_actual, int skv_actual,
                                float scale_log2, float scale, int causal,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv<2>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                         Skv, D, sq_actual, skv_actual, scale_log2, scale,
                         causal, s);
  if (D <= 96)
    return launch_dkv<3>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                         Skv, D, sq_actual, skv_actual, scale_log2, scale,
                         causal, s);
  return launch_dkv<4>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Skv,
                       D, sq_actual, skv_actual, scale_log2, scale, causal, s);
}
