// Hopper building blocks (sm_90a) of the port's warpgroup kernels: mbarriers,
// TMA tensor loads, warpgroup MMA (wgmma) on 128-byte-swizzled operands, and
// the host's tensor maps. mlp_stack.cu (the layer-stack probe), raw_bwd.cu
// (bwd_stash) and fine_raw.cu (fine_raw_t) run them.
//
// Operand layouts in shared memory, both under the 128-byte swizzle (16-byte
// chunk k of the 128-byte row r lands at chunk k ^ (r % 8); tiles start
// 1024-byte aligned):
//   - K-major (desc_sw128): rows of 128 bytes of K, 8-row groups 1024 bytes
//     apart. An activation tile (64 rows, wgmma's A) or a forward weight panel
//     (N rows of an (out, in) matrix, wgmma's B) is one such block per 64
//     columns of K; a k-step advances the start address by 32 bytes;
//   - MN-major (desc_sw128_mn, wgmma's B with imm-trans-b = 1): rows of 128
//     bytes of N (64 outputs), one row per k, 8-row groups 1024 bytes apart
//     (the stride byte offset), 64-output blocks 64 rows x 128 bytes apart
//     (the leading byte offset). A TMA box of 64 x 64 elements of a row-major
//     (K, N) matrix lands as one such block; a 16-deep k-step advances the
//     start address by 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage, as panel.cuh: each including source's kernels sit in an
// anonymous namespace of their own.
namespace {

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers and TMA ----------------------------------------------------

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ inline void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the barrier's phase of this parity has completed; traps
// (a launch error, not a hung card) if it never does.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n > (1 << 26)) __trap();
  }
}
// A 2D box of the tensor map at (c0 columns, c1 rows) into shared memory,
// its bytes reported to the barrier.
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ---- warpgroup MMA --------------------------------------------------------

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The sums are written by the asynchronous MMA: after a wait, tie every
// register to that point so that no read of it moves above the wait.
template <int N>
__device__ inline void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ inline void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor of a K-major operand under the 128-byte swizzle: start
// address >> 4, leading byte offset 1 (unused by this layout), stride byte
// offset 1024 (8 rows of 128 B) >> 4, layout type 1 (128-byte swizzle).
// The tiles start 1024-byte aligned; a k-step inside a panel advances the
// start address by its 32 bytes.
__device__ inline uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Matrix descriptor of an MN-major B operand under the 128-byte swizzle:
// leading byte offset 8192 (from one 64-output block to the next: 64 rows of
// k at 128 B), stride byte offset 1024 (8 rows of k), layout type 1.
__device__ inline uint64_t desc_sw128_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define WG_R8(C, i) C(i), C(i + 1), C(i + 2), C(i + 3), C(i + 4), C(i + 5), C(i + 6), C(i + 7)
#define WG_R32(C, i) WG_R8(C, i), WG_R8(C, i + 8), WG_R8(C, i + 16), WG_R8(C, i + 24)
#define WG_OF(i) "+f"(d[i])
#define WG_OI(i) "+r"(d[i])
#define WG_REGS0 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS1 \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_REGS2 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_REGS3 \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
  "%125, %126, %127"
#define WG_PRED(i) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #i ", 0;\n"
#define WG_BF16(n) "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32.bf16.bf16 {"

// d[0 .. N/2) (+)= A . B over one 16-deep k-step, bf16 operands, float32
// sums: A 64 x 16 K-major, B N x 16, K-major (TB = 0) or MN-major (TB = 1),
// both in shared memory; scale = 0 starts the sums afresh. N in {64, 128,
// 192, 256}; d may be longer than N/2.
template <int N, int TB, int M>
__device__ inline void wgmma_bf16(float (&d)[M], uint64_t a, uint64_t b, int scale) {
  static_assert(M >= N / 2, "accumulator");
  if constexpr (N == 64) {
    asm volatile(WG_PRED(34) WG_BF16(64) WG_REGS0 "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
                 : WG_R32(WG_OF, 0) : "l"(a), "l"(b), "r"(scale), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(WG_PRED(66) WG_BF16(128) WG_REGS0 ", " WG_REGS1
                 "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
                 : WG_R32(WG_OF, 0), WG_R32(WG_OF, 32) : "l"(a), "l"(b), "r"(scale), "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(WG_PRED(98) WG_BF16(192) WG_REGS0 ", " WG_REGS1 ", " WG_REGS2
                 "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
                 : WG_R32(WG_OF, 0), WG_R32(WG_OF, 32), WG_R32(WG_OF, 64)
                 : "l"(a), "l"(b), "r"(scale), "n"(TB));
  } else {
    static_assert(N == 256, "wgmma_bf16 takes N in {64, 128, 192, 256}");
    asm volatile(WG_PRED(130) WG_BF16(256) WG_REGS0 ", " WG_REGS1 ", " WG_REGS2 ", " WG_REGS3
                 "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
                 : WG_R32(WG_OF, 0), WG_R32(WG_OF, 32), WG_R32(WG_OF, 64), WG_R32(WG_OF, 96)
                 : "l"(a), "l"(b), "r"(scale), "n"(TB));
  }
}

// ---- a consumer warpgroup's tiles in shared memory ------------------------
// raw_bwd.cu (bwd_stash) and fine_raw.cu: 64-point tiles of bf16 columns
// under the 128-byte swizzle, one 64-column block 8 KB.

constexpr int WGT = 128;                 // threads a warpgroup
constexpr int SWZ = 128;                 // bytes of a swizzled row
constexpr int PBYTES = 64 * SWZ;         // 64 rows x 64 bf16: a tile's block, a TMA box

// Named barrier 1 + c of consumer warpgroup c's 128 threads.
__device__ __forceinline__ void csync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WGT) : "memory");
}
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Byte address of element (r, col) of a tile under the 128-byte swizzle.
__device__ __forceinline__ uint32_t tile_at(uint32_t tile, int r, int col) {
  return tile + (col >> 6) * PBYTES + r * SWZ + ((((col & 63) >> 3) ^ (r & 7)) << 4) +
         (col & 7) * 2;
}
__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts16(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts_pair(uint32_t a, float v0, float v1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
               "r"(*reinterpret_cast<const uint32_t*>(&p))
               : "memory");
}
__device__ __forceinline__ void sts_bf16(uint32_t a, __nv_bfloat16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a),
               "h"(*reinterpret_cast<const unsigned short*>(&v))
               : "memory");
}

// bf16 halves of a 32-bit pair, as float; a float pair rounded to bf16
__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf_pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A generic pointer to the dynamic shared memory at shared address a.
template <typename T>
__device__ __forceinline__ T* sptr(uint32_t a) {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw + (a - smem_u32(smem_raw)));
}

// Consumer warpgroups a persistent block takes for `tiles` 64-point tiles
// over `sms` SMs, at most `most`: the fewest rounds of blocks, a block
// costing its consumers plus one (its fixed latencies); ties to more
// consumers.
inline int consumers_for(long long tiles, int sms, int most) {
  int ncw = 1;
  long long best = -1;
  for (int k = 1; k <= most; ++k) {
    const long long blocks = (tiles + k - 1) / k;
    const long long cost = (blocks + sms - 1) / sms * (k + 1);
    if (best < 0 || cost <= best) {
      best = cost;
      ncw = k;
    }
  }
  return ncw;
}

// ---- host side: tensor maps -----------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A row-major (rows, cols) matrix of E-byte elements, read in boxes of
// 128 bytes of columns by box_rows rows under the 128-byte swizzle; a box's
// elements past the matrix's edge arrive as zeros.
template <typename T>
bool tensor_map(CUtensorMap* m, const void* ptr, long long rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return fn(m, dt, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
