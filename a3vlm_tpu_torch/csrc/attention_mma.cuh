// Tensor-core building blocks of the flash-attention forward
// (flash_attention.cu, K2) and its dq backward (flash_attention_bwd.cu, K9a)
// on Hopper (sm_90a): bf16 tiles in shared memory in the 128-byte swizzle,
// brought in by asynchronous copies (TMA boxes for the K and V ring,
// cp.async.cg for the tiles a block loads once), and warpgroup matrix
// products (wgmma) that read them through matrix descriptors.
//
// Tiles. A tile of ROWS rows and DP (64 or 128) columns of bf16 is stored as
// DP / 64 panels of [ROWS][64]: a panel row is 128 bytes, and the 16-byte
// chunk c of row r sits at chunk c ^ (r & 7) (the B128 swizzle, taken over
// the absolute shared address, so every tile starts on a 1024-byte
// boundary). A TMA box of 64 columns x 64 rows with the 128-byte swizzle is
// one such panel. Columns d >= D and rows past the end come in as zeros
// (out of the tensor map's bounds, or cp.async with a source size of 0).
// Where D % 8 != 0 a row does not start on 16 bytes in device memory, and
// load_tile fills the chunks with plain 2-byte loads instead (the slow load
// path; same tile, same kernel).
//
// Products, all m64 x n x k16 in f32 over bf16, one warpgroup per 64 rows:
// - S = A B^T with B [64 keys][DP] read from shared memory as a K-major
//   operand (the tile layout above is exactly that): descriptor start += 32
//   bytes per 16 columns inside a panel, stride between 8-row groups (SBO)
//   1024 bytes. A [64][DP] likewise.
// - O += P V with P taken from registers (the accumulator layout of S maps
//   onto the A fragment: see pack_a) and the V tile [64 keys][DP] read as an
//   MN-major B operand through the transpose flag: start += 2048 bytes per
//   16 keys, SBO 1024 bytes (8 keys), LBO the panel stride (next 64 columns).
//
// Accumulator layout of m64nN (thread t of the warpgroup, warp w = t / 32,
// g = (t % 32) / 4, c = t % 4): d[4 j + e] is row 16 w + g + 8 (e / 2),
// column 8 j + 2 c + (e % 2). A row is shared by the four lanes of a quad.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace a3mma {

using bf16 = __nv_bfloat16;

constexpr int WG_ROWS = 64;   // query rows per warpgroup
constexpr int WG_THREADS = 128;
constexpr int SWIZZLE_ALIGN = 1024;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + SWIZZLE_ALIGN - 1) & ~(SWIZZLE_ALIGN - 1)) - a);
}

// ------------------------------------------------------------ async copies
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes shared-memory writes of this thread visible to the asynchronous
// proxy through which wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(WG_THREADS) : "memory");
}

// ------------------------------------------------ mbarrier and TMA loads
__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// After the last mbar_init, before any thread or copy uses a barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces ``bytes`` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "A3_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra A3_DONE;\n"
      "bra A3_WAIT;\n"
      "A3_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a rank-3 tensor map (columns, rows, heads) into shared memory;
// the copy's bytes complete on ``bar``. Rows and columns outside the map's
// extents arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row,
                                            int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// A [ROWS keys][DP] tile of head ``head`` from key ``row`` on, one box of
// 64 columns x ROWS rows per panel, into the tile layout of the header note
// (the map's 128-byte swizzle is that layout). Issued by one thread.
template <int ROWS, int DP>
__device__ __forceinline__ void tma_load_tile(uint8_t* tile,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row,
                                              int head) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
    tma_load_3d(smem_u32(tile) + p * (ROWS * 128), map, bar, 64 * p, row,
                head);
}

// Host side: the tensor map of k or v [heads][rows_alloc][D] bf16 for boxes
// of 64 columns x box_rows rows in the 128-byte swizzle. Only ``rows`` rows of
// each head are in bounds, so later rows read as zeros. D % 8 == 0 (a row
// is a multiple of 16 bytes). cuTensorMapEncodeTiled is looked up in the
// libcuda that the process has loaded already. Returns a cudaError_t.
inline int make_kv_map(CUtensorMap* map, const void* base, int D, int rows,
                       int rows_alloc, int heads, int box_rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows_alloc * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ int tile_offset(int rows, int r, int c) {
  return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [0, ROWS) of g (row stride D elements) into ``tile``; rows from
// rows_valid on and columns from D on are zero. ``vec`` (D % 8 == 0) takes
// the asynchronous 16-byte copies, otherwise plain loads fill the chunk.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(uint8_t* tile,
                                          const bf16* __restrict__ g,
                                          int rows_valid, int D, bool vec,
                                          int tid) {
  constexpr int CH = DP / 8;
  static_assert((ROWS * CH) % THREADS == 0, "tile does not divide");
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int n = 0; n < ROWS * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH, c = i % CH;
    const int off = tile_offset(ROWS, r, c);
    if (vec) {
      const bool ok = r < rows_valid && c * 8 < D;
      cp_async16(base + off, ok ? g + (long)r * D + c * 8 : g, ok ? 16 : 0);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = c * 8 + e;
        tmp[e] = (r < rows_valid && d < D) ? g[(long)r * D + d]
                                          : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(tile + off) = *reinterpret_cast<uint4*>(tmp);
    }
  }
}

// The warpgroup's [64][DP] f32 accumulator (layout in the header note) to
// ``stage``, its own 64 rows of a [ROWS][DP] tile, as bf16 scaled per row,
// then to g (row stride D) in 16-byte pieces: rows < rows_valid, columns
// < D. ``stage`` must no longer be read by any product.
template <int ROWS, int DP>
__device__ __forceinline__ void store_rows(uint8_t* tile, int row_base,
                                           const float (&acc)[DP / 2],
                                           float s0, float s1,
                                           bf16* __restrict__ g,
                                           int rows_valid, int D, bool vec,
                                           int wg, int tid_wg) {
  const int warp = tid_wg >> 5, lane = tid_wg & 31;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_base + warp * 16 + gq + 8 * h;
      const float s = h ? s1 : s0;
      *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset(ROWS, r, j) +
                                         cq * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * s,
                                acc[4 * j + 2 * h + 1] * s);
    }
  }
  warpgroup_sync(wg);
  constexpr int CH = DP / 8;
#pragma unroll
  for (int n = 0; n < WG_ROWS * CH / WG_THREADS; ++n) {
    const int i = tid_wg + n * WG_THREADS;
    const int rl = i / CH, c = i % CH;
    if (rl >= rows_valid || c * 8 >= D) continue;
    const uint8_t* src = tile + tile_offset(ROWS, row_base + rl, c);
    bf16* dst = g + (long)rl * D + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(src);
      for (int d = 0; d < 8 && c * 8 + d < D; ++d) dst[d] = e[d];
    }
  }
}

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator after wgmma_wait: the compiler may not read or move
// the registers across the asynchronous product's window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. lbo/sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: 16 columns from column 16 * ks of rows [row0, row0 + 64)
// (A) or of 64 keys (B) of a [ROWS][DP] tile.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int row0, int ks) {
  return make_desc(tile + (ks >> 2) * (rows * 128) + row0 * 128 + (ks & 3) * 32,
                   16, 1024);
}

// MN-major B operand: keys [16 * ks, 16 * ks + 16) of a [rows][DP] tile,
// all DP columns.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int ks) {
  return make_desc(tile + ks * 2048, rows * 128, 1024);
}

#define A3_ACC8(d, o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),           \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (+)= A B^T, both operands from shared memory, K-major; n = 64.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with n = 128.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24),
        A3_ACC8(d, 32), A3_ACC8(d, 40), A3_ACC8(d, 48), A3_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (16 columns) from registers, B from shared memory MN-major
// (transpose flag); n = 64.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with n = 128.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : A3_ACC8(d, 0), A3_ACC8(d, 8), A3_ACC8(d, 16), A3_ACC8(d, 24),
        A3_ACC8(d, 32), A3_ACC8(d, 40), A3_ACC8(d, 48), A3_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef A3_ACC8

// Keeps A fragments alive (and in their registers) until here: an
// asynchronous product still reads them after the statement that issued it.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The [64][N] f32 accumulator of S (NS = N / 2 values a thread), rounded to
// bf16, as the N / 16 A fragments (16 keys each) of the product that
// consumes it: the quad that holds row g's columns 8 j + 2 c, + 1 in d[4 j],
// d[4 j + 1] is the quad the A fragment wants them from, so no value
// changes lane.
template <int NS>
__device__ __forceinline__ void pack_a(const float (&s)[NS],
                                       uint32_t (&a)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Keys [0, kv_end) are the ones a block must visit: all visible keys of its
// last row. <= 0 when the block sees no key at all.
__device__ __forceinline__ int visible_end(int q0, int block_rows, int Sq,
                                           int skv_actual, int offset,
                                           bool causal) {
  if (!causal) return skv_actual;
  return min(skv_actual, min(q0 + block_rows, Sq) + offset);
}

}  // namespace a3mma
