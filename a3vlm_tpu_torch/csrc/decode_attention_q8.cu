// Single-query attention over the int8 decode cache for Hopper (sm_90a),
// with and without the fused quantize-and-write of the new token.
//
// Replaces a3vlm_tpu/ops/decode_attention.py::_decode_kernel_q8 and
// _decode_kernel_blocked_q8 (reached through decode_attention_quant) and
// ::_decode_kernel_q8_fused and _decode_kernel_blocked_q8_fused with
// _quantize_new_kv (reached through decode_attention_update_quant).
// q [B, Hkv, G, D] bf16; cache panels int8 [B, Hkv, S, D] with one f32 scale
// per (b, h, row), [B, Hkv, S]; new k/v [B, Hkv, D] bf16; pos/valid [B]
// int32. The scales never touch a dequantized panel: a row's score is
// (q . k_int8) * sm_scale * kscale[row], and its softmax weight is
// multiplied by vscale[row] before it meets the int8 v row.
//
// What bounds it on an H100: reading the cache, 2 * B * Hkv * S * (D + 4)
// bytes per layer and step, half of the bf16 cache's. The design is
// decode_attention.cu's: grid (S / 256 splits, Hkv, B), a warp walks 64 rows
// with lane l holding dims 4l..4l+3, here one 32-bit load (char4) per lane
// and row, four rows in flight, an f32 online softmax in base 2, per-warp
// partials combined by a second pass.
//
// The fused form: blocks run in no order, so no block may read row pos[b]
// while another writes it. Every warp quantizes the new 128-element row
// itself (a warp max-reduction, then f32 math that matches
// quantize_kv_tokens bit for bit: max(absmax, 1e-8) / 127, a true division
// x / scale, round half to even, clip to +-127) and takes row pos[b] from
// those registers; the block that owns the row alone writes its int8 values
// and its two scales. Requires D == 128.

#include "decode_common.cuh"

namespace {

template <bool FUSED>
__global__ void __launch_bounds__(DC_WARPS * 32)
decode_q8_kernel(const __nv_bfloat16* __restrict__ q, int8_t* __restrict__ ck,
                 int8_t* __restrict__ cv, float* __restrict__ ks,
                 float* __restrict__ vs, const __nv_bfloat16* __restrict__ nk,
                 const __nv_bfloat16* __restrict__ nv,
                 const int* __restrict__ pos, const int* __restrict__ valid,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int Hkv, int G, int S,
                 float scale_log2, int P) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bh = (long)b * Hkv + h;
  const int p_b = FUSED ? pos[b] : -1;
  const int v_b = min(valid[b], S);
  int8_t* ckb = ck + bh * S * DC_D;
  int8_t* cvb = cv + bh * S * DC_D;
  float* ksb = ks + bh * S;
  float* vsb = vs + bh * S;
  const int c0 = split * DC_CHUNK;
  const int c1 = min(S, c0 + DC_CHUNK);

  // the new token's row, quantized: this lane's four values and the scales
  float nkq[4] = {0.f, 0.f, 0.f, 0.f}, nvq[4] = {0.f, 0.f, 0.f, 0.f};
  float nks = 0.f, nvs = 0.f;
  if (FUSED) {
    float kr[4], vr[4];
    load4(nk + bh * DC_D + lane * 4, kr);
    load4(nv + bh * DC_D + lane * 4, vr);
    float ka = fmaxf(fmaxf(fabsf(kr[0]), fabsf(kr[1])),
                     fmaxf(fabsf(kr[2]), fabsf(kr[3])));
    float va = fmaxf(fmaxf(fabsf(vr[0]), fabsf(vr[1])),
                     fmaxf(fabsf(vr[2]), fabsf(vr[3])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ka = fmaxf(ka, __shfl_xor_sync(0xffffffffu, ka, o));
      va = fmaxf(va, __shfl_xor_sync(0xffffffffu, va, o));
    }
    nks = __fdiv_rn(fmaxf(ka, 1e-8f), 127.0f);
    nvs = __fdiv_rn(fmaxf(va, 1e-8f), 127.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nkq[j] = fminf(fmaxf(rintf(__fdiv_rn(kr[j], nks)), -127.f), 127.f);
      nvq[j] = fminf(fmaxf(rintf(__fdiv_rn(vr[j], nvs)), -127.f), 127.f);
    }
    if (p_b >= c0 && p_b < c1 && warp == 0) {
      *reinterpret_cast<char4*>(ckb + (long)p_b * DC_D + lane * 4) =
          make_char4((signed char)nkq[0], (signed char)nkq[1],
                     (signed char)nkq[2], (signed char)nkq[3]);
      *reinterpret_cast<char4*>(cvb + (long)p_b * DC_D + lane * 4) =
          make_char4((signed char)nvq[0], (signed char)nvq[1],
                     (signed char)nvq[2], (signed char)nvq[3]);
      if (lane == 0) {
        ksb[p_b] = nks;
        vsb[p_b] = nvs;
      }
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
      float s[DC_UNROLL], ksc[DC_UNROLL], vsc[DC_UNROLL];
      float vrow[DC_UNROLL][4];
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const int row = c + u;
        float kr[4] = {0.f, 0.f, 0.f, 0.f};
        vrow[u][0] = vrow[u][1] = vrow[u][2] = vrow[u][3] = 0.f;
        ksc[u] = vsc[u] = 0.f;
        if (row < hi) {
          if (FUSED && row == p_b) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              kr[j] = nkq[j];
              vrow[u][j] = nvq[j];
            }
            ksc[u] = nks;
            vsc[u] = nvs;
          } else {
            load4_i8(ckb + (long)row * DC_D + lane * 4, kr);
            load4_i8(cvb + (long)row * DC_D + lane * 4, vrow[u]);
            ksc[u] = ksb[row];
            vsc[u] = vsb[row];
          }
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
        s[u] = c + u < hi ? s[u] * ksc[u] : -INFINITY;
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
        const float pw = p * vsc[u];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(pw, vrow[u][j], acc[j]);
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

template <bool FUSED>
int launch_q8(const void* q, void* ck, void* cv, void* ks, void* vs,
              const void* nk, const void* nv, const void* pos,
              const void* valid, void* part_m, void* part_l, void* part_acc,
              void* out, int B, int Hkv, int G, int S, float scale_log2,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (S + DC_CHUNK - 1) / DC_CHUNK;
  const int P = splits * DC_WARPS;
  dim3 grid(splits, Hkv, B);
  decode_q8_kernel<FUSED><<<grid, DC_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<int8_t*>(ck),
      static_cast<int8_t*>(cv), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const __nv_bfloat16*>(nk),
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

}  // namespace

// Scratch as for a3_decode_update_attend: a3_decode_partials(S) per row.
extern "C" int a3_decode_attend_q8(const void* q, const void* ck,
                                   const void* cv, const void* ks,
                                   const void* vs, const void* valid,
                                   void* part_m, void* part_l, void* part_acc,
                                   void* out, int B, int Hkv, int G, int S,
                                   float scale_log2, void* stream) {
  return launch_q8<false>(q, const_cast<void*>(ck), const_cast<void*>(cv),
                          const_cast<void*>(ks), const_cast<void*>(vs),
                          nullptr, nullptr, nullptr, valid, part_m, part_l,
                          part_acc, out, B, Hkv, G, S, scale_log2, stream);
}

extern "C" int a3_decode_update_attend_q8(
    const void* q, void* ck, void* cv, void* ks, void* vs, const void* nk,
    const void* nv, const void* pos, const void* valid, void* part_m,
    void* part_l, void* part_acc, void* out, int B, int Hkv, int G, int S,
    float scale_log2, void* stream) {
  return launch_q8<true>(q, ck, cv, ks, vs, nk, nv, pos, valid, part_m,
                         part_l, part_acc, out, B, Hkv, G, S, scale_log2,
                         stream);
}
