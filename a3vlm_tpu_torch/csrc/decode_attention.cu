// Single-query attention over the bf16 decode cache for Hopper (sm_90a), K3
// and K3u: decode_cluster_kernel<false, GT> of decode_common.cuh, whose
// header note holds the design (a thread block cluster per kv head, bulk
// copies into a ring of stages, the combine through distributed shared
// memory; one launch a call).
//
// Replaces a3vlm_tpu/ops/decode_attention.py::_decode_kernel_fused and
// _decode_kernel_blocked_fused (reached through decode_attention_update)
// and, with the write switched off (null pos), ::_decode_kernel and
// _decode_kernel_blocked (reached through decode_attention). Row pos[b] of
// both caches is overwritten in place with the new k/v, then each of the G
// query heads of a kv head attends over cache rows [0, valid[b]). Without
// the write the arithmetic is the same instruction for instruction, so on a
// cache that already holds the row the two forms give the same bits.
//
// What bounds it on an H100: reading the cache, 4 * Hkv * D bytes per
// visible row of each batch row, against a few FLOPs per byte.

#include "decode_common.cuh"

// Blocks of the kernel for G query rows per kv head at head dim D that the
// card holds at once; the wrapper sizes the cluster from it. A negative value is a
// cudaError_t.
extern "C" int a3_decode_slots(int G, int D) {
  return dc_slots_any<false>(G, D);
}

// q [B, Hkv, G, D]; caches [B, Hkv, S, D]; nk/nv [B, Hkv, D]; pos/valid [B];
// out [B, Hkv, G, D]; D 64 or 128; C blocks a cluster (1..8). pos, nk and
// nv null: attention only (the caches are not written).
extern "C" int a3_decode_attend(const void* q, void* ck, void* cv,
                                const void* nk, const void* nv,
                                const void* pos, const void* valid, void* out,
                                int B, int Hkv, int G, int S, int D, int C,
                                float scale_log2, void* stream) {
  DcArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.ck = static_cast<uint8_t*>(ck);
  a.cv = static_cast<uint8_t*>(cv);
  a.nk = static_cast<const bf16*>(nk);
  a.nv = static_cast<const bf16*>(nv);
  a.pos = static_cast<const int*>(pos);
  a.valid = static_cast<const int*>(valid);
  a.out = static_cast<bf16*>(out);
  a.Hkv = Hkv;
  a.G = G;
  a.S = S;
  a.scale_log2 = scale_log2;
  return dc_launch_any<false>(a, B, D, C, stream);
}
