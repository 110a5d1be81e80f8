// A check of the register-A products of attention_mma.cuh at the 64- and
// 128-wide tiles, called only by the card tests
// (tests/test_torch_kernels_cuda.py::test_wgmma_register_a_probe_cuda).
//
// One warpgroup forms, for three B tiles t in turn and with the same A,
//   C_t = A B_t^T  (A [64][DP], B_t [64][DP], both K-major; m64n64k16 over
//                   DP / 16 steps), and
//   C_t = A2 B_t   (A2 [64][64], B_t [64 rows][DP] read MN-major through the
//                   transpose flag; m64nDPk16 over 4 steps),
// each once with A read from shared memory through a descriptor and once
// with A as register fragments: an accumulator-layout copy of A (each
// thread holds the elements the accumulator layout gives it) rounded by
// pack_a, as K2, K9a, K9b and K10 form P and dS. The fragments are built
// once and reused for all three tiles, as a kernel reuses them across key
// tiles. Tensor cores sum a k16 step the same way whichever side A comes
// from, so each pair must agree bit for bit.
//
// out (f32): [0] A B^T from shared memory, [1] the same with A from
// registers, each [3][64][64]; then [2] A2 B from shared memory, [3] from
// registers, each [3][64][DP].

#include "attention_mma.cuh"

namespace {

using namespace a3mma;

constexpr int TILES = 3;

#define A3_ACC8(d, o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),           \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (+)= A B^T, A (16 columns) from registers, B K-major from shared
// memory; n = 64. No kernel of the library uses this form.
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (+)= A B, A from shared memory K-major, B MN-major (transpose flag).
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tb(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24),
        A3_ACC8(d, 32), A3_ACC8(d, 40), A3_ACC8(d, 48), A3_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef A3_ACC8

// Row and column of accumulator element i of this thread (header note).
__device__ __forceinline__ int acc_row(int tid, int i) {
  return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

template <int N>
__device__ __forceinline__ void write_acc(const float (&d)[N / 2],
                                          float* __restrict__ out, int tid) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    out[acc_row(tid, i) * N + acc_col(tid, i)] = d[i];
}

// The accumulator-layout copy of a [64][N] bf16 matrix, as A fragments.
template <int N>
__device__ __forceinline__ void frags_of(const bf16* __restrict__ a,
                                         uint32_t (&f)[N / 16][4], int tid) {
  float s[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    s[i] = __bfloat162float(a[acc_row(tid, i) * N + acc_col(tid, i)]);
  pack_a(s, f);
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS)
probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ a2,
             const bf16* __restrict__ b, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = align_smem(smem_raw);        // A [64][DP]
  uint8_t* a2s = as + 64 * DP * 2;           // A2 [64][64]
  uint8_t* bs = a2s + 64 * 64 * 2;           // B_t [64][DP], t < TILES
  const int tid = threadIdx.x;
  load_rows<DP>(as, 64, 0, 64, a, DP, 64, DP, tid, WG_THREADS);
  load_rows<64>(a2s, 64, 0, 64, a2, 64, 64, 64, tid, WG_THREADS);
  for (int t = 0; t < TILES; ++t)
    load_rows<DP>(bs + t * 64 * DP * 2, 64, 0, 64, b + t * 64 * DP, DP, 64,
                  DP, tid, WG_THREADS);
  fence_proxy_async();
  __syncthreads();

  uint32_t fa[DP / 16][4], fa2[4][4];
  frags_of<DP>(a, fa, tid);
  frags_of<64>(a2, fa2, tid);
  const uint32_t as_u = smem_u32(as), a2s_u = smem_u32(a2s);
  float* o0 = out;
  float* o1 = o0 + TILES * 64 * 64;
  float* o2 = o1 + TILES * 64 * 64;
  float* o3 = o2 + TILES * 64 * DP;
  for (int t = 0; t < TILES; ++t) {
    const uint32_t bt = smem_u32(bs + t * 64 * DP * 2);
    float d[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wgmma_ss_n64(d, desc_kmajor(as_u, 64, 0, ks), desc_kmajor(bt, 64, 0, ks),
                   ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    write_acc<64>(d, o0 + t * 64 * 64, tid);

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wgmma_rs_kb(d, fa[ks], desc_kmajor(bt, 64, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_frags(fa);
    write_acc<64>(d, o1 + t * 64 * 64, tid);

    float c[DP / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_tb(c, desc_kmajor(a2s_u, 64, 0, ks), desc_mnmajor(bt, 64, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(c);
    write_acc<DP>(c, o2 + t * 64 * DP, tid);

#pragma unroll
    for (int i = 0; i < DP / 2; ++i) c[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_tb(c, fa2[ks], desc_mnmajor(bt, 64, ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(c);
    fence_frags(fa2);
    write_acc<DP>(c, o3 + t * 64 * DP, tid);
  }
}

template <int DP>
int launch(const void* a, const void* a2, const void* b, void* out,
           cudaStream_t s) {
  constexpr int SMEM = SWIZZLE_ALIGN + (64 * DP + 64 * 64 + TILES * 64 * DP) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<DP><<<1, WG_THREADS, SMEM, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(a2),
      static_cast<const bf16*>(b), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// a [64][DP], a2 [64][64], b [3][64][DP] bf16 contiguous; out f32 as the
// header note lays it out. DP is 64 or 128.
extern "C" int a3_probe_wgmma(const void* a, const void* a2, const void* b,
                              void* out, int DP, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (DP == 64) return launch<64>(a, a2, b, out, s);
  if (DP == 128) return launch<128>(a, a2, b, out, s);
  return (int)cudaErrorInvalidValue;
}
