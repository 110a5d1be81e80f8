// Single-query attention over the bf16 decode cache for Hopper (sm_90a),
// with and without the fused cache write.
//
// Replaces a3vlm_tpu/ops/decode_attention.py::_decode_kernel_fused and
// _decode_kernel_blocked_fused (reached through decode_attention_update)
// and, with the write switched off (null pos), ::_decode_kernel and
// _decode_kernel_blocked (reached through decode_attention).
// q [B, Hkv, G, D], caches [B, Hkv, S, D] bf16, new k/v [B, Hkv, D],
// pos/valid [B] int32. Row pos[b] of both caches is overwritten in place
// with the new k/v, then each of the G query heads of a kv head attends over
// cache rows [0, valid[b]). Without the write the arithmetic is the same
// instruction for instruction, so on a cache that already holds the row the
// two forms give the same bits.
//
// What bounds it on an H100: reading the cache, 4 * B * Hkv * S * D bytes
// per layer and step, against a few FLOPs per byte. The design is
// flash-decoding: the grid is (S / 256 splits, Hkv, B), so even batch 4
// fills the card; each of a block's 4 warps walks 64 cache rows, one
// 256-byte row per step across the warp (coalesced, lane l holds dims
// 4l..4l+3), four rows in flight for latency, with an f32 online softmax in
// base 2. Per-warp partial (max, sum, acc) go to an f32 scratch that a second
// pass combines. The block that owns row pos[b] writes it; every block
// takes that row from the new k/v instead of the cache, so no block reads a
// row another block is writing. Rows of a fully masked query divide by 1.
// Requires D == 128.

#include "decode_common.cuh"

namespace {

__global__ void __launch_bounds__(DC_WARPS * 32)
decode_update_attend_kernel(const __nv_bfloat16* __restrict__ q,
                            __nv_bfloat16* __restrict__ ck,
                            __nv_bfloat16* __restrict__ cv,
                            const __nv_bfloat16* __restrict__ nk,
                            const __nv_bfloat16* __restrict__ nv,
                            const int* __restrict__ pos,
                            const int* __restrict__ valid,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            float* __restrict__ part_acc, int Hkv, int G,
                            int S, float scale_log2, int P) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bh = (long)b * Hkv + h;
  const int p_b = pos ? pos[b] : -1;  // null pos: attend only, no write
  const int v_b = min(valid[b], S);
  __nv_bfloat16* ckb = ck + bh * S * DC_D;
  __nv_bfloat16* cvb = cv + bh * S * DC_D;
  const __nv_bfloat16* nkb = pos ? nk + bh * DC_D : nullptr;
  const __nv_bfloat16* nvb = pos ? nv + bh * DC_D : nullptr;
  const int c0 = split * DC_CHUNK;
  const int c1 = min(S, c0 + DC_CHUNK);

  if (p_b >= c0 && p_b < c1) {  // c0 >= 0, so never without a write
    for (int i = tid; i < DC_D; i += DC_WARPS * 32) {
      ckb[(long)p_b * DC_D + i] = nkb[i];
      cvb[(long)p_b * DC_D + i] = nvb[i];
    }
  }

  const int lo = c0 + warp * DC_SUB;
  const int hi = min(min(c1, lo + DC_SUB), v_b);
  const int pidx = split * DC_WARPS + warp;

  for (int g = 0; g < G; ++g) {
    float qv[4];
    load4(q + (bh * G + g) * DC_D + lane * 4, qv);
#pragma unroll
    for (int j = 0; j < 4; ++j) qv[j] *= scale_log2;
    float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int c = lo; c < hi; c += DC_UNROLL) {
      float s[DC_UNROLL];
      float vrow[DC_UNROLL][4];
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const int row = c + u;
        float kr[4] = {0.f, 0.f, 0.f, 0.f};
        vrow[u][0] = vrow[u][1] = vrow[u][2] = vrow[u][3] = 0.f;
        if (row < hi) {
          const __nv_bfloat16* kp = row == p_b ? nkb : ckb + (long)row * DC_D;
          const __nv_bfloat16* vp = row == p_b ? nvb : cvb + (long)row * DC_D;
          load4(kp + lane * 4, kr);
          load4(vp + lane * 4, vrow[u]);
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
        if (c + u >= hi) s[u] = -INFINITY;
        tmax = fmaxf(tmax, s[u]);
      }
      const float m_new = fmaxf(m, tmax);
      const float alpha = exp2f(m - m_new);  // m_new is finite: row c is valid
      l *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] *= alpha;
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const float p = exp2f(s[u] - m_new);
        l += p;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(p, vrow[u][j], acc[j]);
      }
      m = m_new;
    }

    const long prow = (bh * G + g) * P + pidx;
    if (lane == 0) {
      part_m[prow] = m;
      part_l[prow] = l;
    }
    *reinterpret_cast<float4*>(part_acc + prow * DC_D + lane * 4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

}  // namespace

// Number of per-(b, h, g) partials the wrapper must allocate scratch for.
extern "C" int a3_decode_partials(int S) {
  return ((S + DC_CHUNK - 1) / DC_CHUNK) * DC_WARPS;
}

// pos, nk and nv null: attention only (the caches are not written).
extern "C" int a3_decode_update_attend(const void* q, void* ck, void* cv,
                                       const void* nk, const void* nv,
                                       const void* pos, const void* valid,
                                       void* part_m, void* part_l,
                                       void* part_acc, void* out, int B,
                                       int Hkv, int G, int S,
                                       float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (S + DC_CHUNK - 1) / DC_CHUNK;
  const int P = splits * DC_WARPS;
  dim3 grid(splits, Hkv, B);
  decode_update_attend_kernel<<<grid, DC_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(ck),
      static_cast<__nv_bfloat16*>(cv), static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<const int*>(pos),
      static_cast<const int*>(valid), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), Hkv, G, S,
      scale_log2, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * Hkv * G, DC_D, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), P);
  return (int)cudaGetLastError();
}
