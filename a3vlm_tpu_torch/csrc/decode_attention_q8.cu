// Single-query attention over the int8 decode cache for Hopper (sm_90a), K4
// and K4 fused: decode_cluster_kernel<true, GT> of decode_common.cuh, whose
// header note holds the design (a thread block cluster per kv head, bulk
// copies of the int8 rows and of the scale slices into a ring of stages,
// the combine through distributed shared memory; one launch a call).
//
// Replaces a3vlm_tpu/ops/decode_attention.py::_decode_kernel_q8 and
// _decode_kernel_blocked_q8 (reached through decode_attention_quant) and
// ::_decode_kernel_q8_fused and _decode_kernel_blocked_q8_fused with
// _quantize_new_kv (reached through decode_attention_update_quant).
// q [B, Hkv, G, D] bf16; cache panels int8 [B, Hkv, S, D] with one f32 scale
// per (b, h, row), [B, Hkv, S]; new k/v [B, Hkv, D] bf16; pos/valid [B]
// int32. The scales never touch a dequantized panel: a row's score is
// (q . k_int8) * sm_scale * kscale[row], and its softmax weight is
// multiplied by vscale[row] before it meets the int8 v row. The fused form
// quantizes the new row in every block (quantize_kv_tokens's math, bit for
// bit) and takes it from shared memory; the block whose range holds pos[b]
// writes its int8 values and two scales.
//
// What bounds it on an H100: reading the cache, 2 * Hkv * (D + 4) bytes per
// visible row of each batch row, half of the bf16 cache's.

#include "decode_common.cuh"

extern "C" int a3_decode_slots_q8(int G, int D) {
  return dc_slots_any<true>(G, D);
}

// As a3_decode_attend over int8 panels with float32 scales; pos, nk and nv
// null: attention only.
extern "C" int a3_decode_attend_q8(const void* q, void* ck, void* cv,
                                   void* ks, void* vs, const void* nk,
                                   const void* nv, const void* pos,
                                   const void* valid, void* out, int B,
                                   int Hkv, int G, int S, int D, int C,
                                   float scale_log2, void* stream) {
  DcArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.ck = static_cast<uint8_t*>(ck);
  a.cv = static_cast<uint8_t*>(cv);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
  a.nk = static_cast<const bf16*>(nk);
  a.nv = static_cast<const bf16*>(nv);
  a.pos = static_cast<const int*>(pos);
  a.valid = static_cast<const int*>(valid);
  a.out = static_cast<bf16*>(out);
  a.Hkv = Hkv;
  a.G = G;
  a.S = S;
  // a stage's scale slices start on 16 bytes only if S % 4 == 0; else the
  // warps read the scales from device memory
  a.staged = S % 4 == 0;
  a.scale_log2 = scale_log2;
  return dc_launch_any<true>(a, B, D, C, stream);
}
