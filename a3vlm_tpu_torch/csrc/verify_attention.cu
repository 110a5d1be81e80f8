// Multi-token verify attention over the decode cache for Hopper (sm_90a):
// a window of `span` query tokens (2..16, the speculative draft) attends
// over the cache, causal within the window.
//
// Replaces a3vlm_tpu/ops/decode_attention.py::_verify_kernel_blocked
// (reached through verify_attention) and ::_verify_kernel_blocked_q8
// (verify_attention_quant). q [B, Hkv, R, D] bf16 with R = G * span and row
// r = g * span + i; caches [B, Hkv, S, D] bf16, or int8 with f32 scales
// [B, Hkv, S]; valid [B] int32 counts the populated prefix, window
// included. Row r sees cache columns < valid[b] - span + 1 + (r % span).
// The int8 form folds the scales in at score level as decode_attention_q8.cu
// does. A row with no visible column gives zeros.
//
// What bounds it on an H100: reading the cache once, while R query rows
// need it. So a block stages a 64-row chunk of K and V (and their scales)
// in shared memory once, 32 KB in bf16, and its 4 warps share the query
// rows between them and walk the staged chunk, lane l holding dims
// 4l..4l+3, with an f32 online softmax in base 2. The grid is (S / 64
// splits, Hkv, B); chunks past valid[b] are not read. The mask threshold is
// per row, so a block stages up to the span's largest threshold, valid[b],
// and each row stops at its own. One partial (max, sum, acc) per (row,
// split) goes to an f32 scratch that decode_common.cuh's pass combines.
// Requires D == 128.

#include "decode_common.cuh"

namespace {

constexpr int VF_WARPS = 4;
constexpr int VF_CHUNK = 64;  // cache rows staged per block

__device__ __forceinline__ void load4_any(const __nv_bfloat16* p, float* out) {
  load4(p, out);
}
__device__ __forceinline__ void load4_any(const int8_t* p, float* out) {
  load4_i8(p, out);
}

// T is the cache element: __nv_bfloat16, or int8_t with scales.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(VF_WARPS * 32)
verify_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ ck,
              const T* __restrict__ cv, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ valid,
              float* __restrict__ part_m, float* __restrict__ part_l,
              float* __restrict__ part_acc, int Hkv, int R, int span, int S,
              float scale_log2, int P) {
  __shared__ __align__(16) unsigned char sk_raw[VF_CHUNK * DC_D * sizeof(T)];
  __shared__ __align__(16) unsigned char sv_raw[VF_CHUNK * DC_D * sizeof(T)];
  const T* sk = reinterpret_cast<const T*>(sk_raw);
  const T* sv = reinterpret_cast<const T*>(sv_raw);
  __shared__ float sks[VF_CHUNK];
  __shared__ float svs[VF_CHUNK];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bh = (long)b * Hkv + h;
  const int v_b = valid[b];
  const int c0 = split * VF_CHUNK;
  // rows of this chunk that some query row of the window may see
  const int n = max(min(min(S, c0 + VF_CHUNK), v_b) - c0, 0);

  if (n > 0) {
    const uint4* gk = reinterpret_cast<const uint4*>(ck + (bh * S + c0) * DC_D);
    const uint4* gv = reinterpret_cast<const uint4*>(cv + (bh * S + c0) * DC_D);
    uint4* dk = reinterpret_cast<uint4*>(sk_raw);
    uint4* dv = reinterpret_cast<uint4*>(sv_raw);
    const int n16 = n * DC_D * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += VF_WARPS * 32) {
      dk[i] = gk[i];
      dv[i] = gv[i];
    }
    if (QUANT) {
      for (int i = tid; i < n; i += VF_WARPS * 32) {
        sks[i] = ks[bh * S + c0 + i];
        svs[i] = vs[bh * S + c0 + i];
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < R; r += VF_WARPS) {
    // this row's visible columns end before thr; local count within the chunk
    const int thr = v_b - span + 1 + (r % span);
    const int hi = max(min(n, thr - c0), 0);
    float qv[4];
    load4(q + (bh * R + r) * DC_D + lane * 4, qv);
#pragma unroll
    for (int j = 0; j < 4; ++j) qv[j] *= scale_log2;
    float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int c = 0; c < hi; c += DC_UNROLL) {
      float s[DC_UNROLL], vsc[DC_UNROLL];
      float vrow[DC_UNROLL][4];
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const int row = c + u;
        float kr[4] = {0.f, 0.f, 0.f, 0.f};
        vrow[u][0] = vrow[u][1] = vrow[u][2] = vrow[u][3] = 0.f;
        if (row < hi) {
          load4_any(sk + row * DC_D + lane * 4, kr);
          load4_any(sv + row * DC_D + lane * 4, vrow[u]);
        }
        s[u] = qv[0] * kr[0] + qv[1] * kr[1] + qv[2] * kr[2] + qv[3] * kr[3];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < DC_UNROLL; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const bool live = c + u < hi;
        vsc[u] = 1.f;
        if (QUANT) {
          s[u] *= live ? sks[c + u] : 0.f;
          vsc[u] = live ? svs[c + u] : 0.f;
        }
        if (!live) s[u] = -INFINITY;
        tmax = fmaxf(tmax, s[u]);
      }
      const float m_new = fmaxf(m, tmax);
      const float alpha = exp2f(m - m_new);  // m_new is finite: row c is live
      l *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] *= alpha;
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const float p = exp2f(s[u] - m_new);
        l += p;
        const float pw = p * vsc[u];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(pw, vrow[u][j], acc[j]);
      }
      m = m_new;
    }

    const long prow = (bh * R + r) * P + split;
    if (lane == 0) {
      part_m[prow] = m;
      part_l[prow] = l;
    }
    *reinterpret_cast<float4*>(part_acc + prow * DC_D + lane * 4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <typename T, bool QUANT>
int launch_verify(const void* q, const void* ck, const void* cv,
                  const void* ks, const void* vs, const void* valid,
                  void* part_m, void* part_l, void* part_acc, void* out, int B,
                  int Hkv, int R, int span, int S, float scale_log2,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = (S + VF_CHUNK - 1) / VF_CHUNK;
  dim3 grid(P, Hkv, B);
  verify_kernel<T, QUANT><<<grid, VF_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(valid),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), Hkv, R, span, S, scale_log2, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * Hkv * R, DC_D, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), P);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of per-(b, h, row) partials the wrapper must allocate scratch for.
extern "C" int a3_verify_partials(int S) {
  return (S + VF_CHUNK - 1) / VF_CHUNK;
}

extern "C" int a3_verify_attend(const void* q, const void* ck, const void* cv,
                                const void* valid, void* part_m, void* part_l,
                                void* part_acc, void* out, int B, int Hkv,
                                int R, int span, int S, float scale_log2,
                                void* stream) {
  return launch_verify<__nv_bfloat16, false>(
      q, ck, cv, nullptr, nullptr, valid, part_m, part_l, part_acc, out, B,
      Hkv, R, span, S, scale_log2, stream);
}

extern "C" int a3_verify_attend_q8(const void* q, const void* ck,
                                   const void* cv, const void* ks,
                                   const void* vs, const void* valid,
                                   void* part_m, void* part_l, void* part_acc,
                                   void* out, int B, int Hkv, int R, int span,
                                   int S, float scale_log2, void* stream) {
  return launch_verify<int8_t, true>(q, ck, cv, ks, vs, valid, part_m, part_l,
                                     part_acc, out, B, Hkv, R, span, S,
                                     scale_log2, stream);
}
