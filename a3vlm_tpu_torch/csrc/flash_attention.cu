// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces a3vlm_tpu/ops/flash_attention.py::_flash_kernel (reached through
// flash_attention_bhsd). q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] bf16 ->
// o [B, Hq, Sq, D] bf16, with the right-aligned causal mask over the actual
// lengths (row r sees key c iff c < skv_actual and
// r - sq_actual >= c - skv_actual) and GQA as kv_head = h / (Hq / Hkv).
//
// What bounds it on an H100: at the decoder prefill (B=4, H=40, S~1500,
// D=128) the score and value products, ~45 GFLOP per layer, which a SIMT
// kernel runs far below the tensor-core rate; device memory is not the limit
// because every key/value tile is reused by 16 query rows from shared memory
// and the scores never leave the SM. The design (attention_tile.cuh): one
// block per (b, h, 16-row query tile), a loop over 32-key tiles that stops
// at the causal limit of the tile's last row, an f32 online softmax in base
// 2, and ragged Sq/Skv masked in the kernel so no caller pads. mma.sync or
// wgmma for the two products is later work.
//
// Training also asks for the natural-log log-sum-exp of each row's scaled
// scores (the TPU kernel's ``return_lse``, flash_attention.py:184-187),
// which the backward kernels (flash_attention_bwd.cu) consume: ``lse``
// [B, Hq, Sq] f32, written when the pointer is not null. Serving passes
// null and writes nothing more.

#include "attention_tile.cuh"

namespace {

template <int NC>
__global__ void __launch_bounds__(a3::AT_WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
                 int skv_actual, float scale_log2, int causal) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const long row0 = ((long)b * Hq + h) * Sq;
  const long qoff = row0 * D;
  const long kvoff = ((long)b * Hkv + kvh) * Skv * D;
  a3::attention_block<NC>(q + qoff, D, k + kvoff, v + kvoff, D, o + qoff, D,
                          blockIdx.x * a3::AT_BQ, Sq, skv_actual, D,
                          scale_log2, causal != 0, skv_actual - sq_actual,
                          lse == nullptr ? nullptr : lse + row0);
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, int D, int sq_actual,
           int skv_actual, float scale_log2, int causal, cudaStream_t s) {
  dim3 grid((Sq + a3::AT_BQ - 1) / a3::AT_BQ, Hq, B);
  flash_fwd_kernel<NC><<<grid, a3::AT_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, D, sq_actual, skv_actual,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// ``lse`` may be null (serving); otherwise [B, Hq, Sq] f32.
extern "C" int a3_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Hq, int Hkv,
                            int Sq, int Skv, int D, int sq_actual,
                            int skv_actual, float scale_log2, int causal,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<2>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, sq_actual,
                     skv_actual, scale_log2, causal, s);
  if (D <= 96)
    return launch<3>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, sq_actual,
                     skv_actual, scale_log2, causal, s);
  return launch<4>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, sq_actual,
                   skv_actual, scale_log2, causal, s);
}
