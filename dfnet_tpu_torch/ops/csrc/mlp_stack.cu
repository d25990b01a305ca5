// mlp_stack_bf16 / mlp_stack_int8: D stacked W x W layers, the bf16 and the
// int8 variant of the layer-stack probe.
//
// Replaces scripts/bench_int8_wide.py::build (Pallas kernels _kernel_bf16
// and _kernel_int8). Points-major: x is (P, W), each weight (W, W) is
// (out, in), so the reference's W . h is h . W^T here.
//   bf16: h <- bf16(relu(h . W^T)), products summed in float32;
//   int8: h <- int8(clip((h . W^T) >> 7, 0, 127)), summed in int32 (an
//         arithmetic shift, then the clip: the cheapest requantisation).
// Output: the first 8 features of each point after the last layer, (P, 8)
// float32.
//
// Bound on the card: operations. A layer is 2 W^2 operations a point
// against W (int8) or 2 W (bf16) bytes of input read once for the whole
// stack: at W=256, D=6 about 3e3 operations a byte, far above the card's
// ~295 flop/B balance point. Peaks: 989 TFLOP/s bf16, 1,979 TOP/s int8.
// What binds a design short of that is the weights: every tile of rows
// reads the whole stack (D W^2 elements) from L2 again, so a tile's
// operations per L2 byte are its rows (bf16) or twice its rows (int8).
//
// Design (Hopper's warpgroup MMA; the first version ran WMMA 16x16x16
// with every B fragment read from L2 at every k-step, at 9% of the bound):
//   - a block is one producer warpgroup and NCW consumer warpgroups
//     (NCW = 4 at W <= 128, 2 above, where the 64 x W accumulator takes
//     W/2 registers a thread); each consumer owns 64 rows of a tile of
//     64 NCW rows. Blocks are persistent, one an SM, and walk the tiles;
//   - a consumer's activations stay in shared memory as its wgmma A
//     operand: K-major, in 128-byte panels of 64 rows under the 128-byte
//     swizzle, read through matrix descriptors. The input tile arrives by
//     TMA (a 2D tensor map, CU_TENSOR_MAP_SWIZZLE_128B, rows past P
//     zero-filled), so it lands swizzled as the descriptor expects;
//   - the weights arrive in panels of W output rows by 128 bytes of input
//     columns ((out, in) row-major is K-major already), by TMA into a ring
//     of STAGES buffers with a full and an empty mbarrier each. One
//     producer thread keeps the ring full across layers and tiles, another
//     loads each consumer's next input tile as soon as the consumer frees
//     it; every consumer of the block reads each panel, so a panel serves
//     64 NCW rows;
//   - a layer is wgmma.mma_async m64nWk16 (bf16 -> f32) or m64nWk32 (s8 ->
//     s32), four a panel, the sums in registers. A stage returns to the
//     producer once the wgmma group that read it has completed (wait_group
//     1 after the next panel's group is committed);
//   - the epilogue works in place: after the layer's last group completes,
//     the warpgroup writes requant(sum) over its own A tile in the
//     swizzled layout, then fence.proxy.async and a named barrier of its
//     128 threads before the next layer's wgmma reads it. After the last
//     layer the first 8 columns go to global memory straight from the
//     registers that hold them (0 .. 3 of every thread);
//   - setmaxnreg gives the producer 40 registers and the consumers the
//     rest. Widths whose K is not a whole number of 128-byte panels (int8
//     at W = 64, 192) run on zero-filled columns up to the next panel.
// Measured and kept (PERF.md, Findings): a wgmma.fence before
// every panel's group (without it ptxas serialised the products, C7520);
// the int8 requantisation packed by cvt.pack.sat (22% at W = 256); four
// consumers at W <= 128 rather than two. Measured and not kept: consumers
// taking turns at the tensor cores (no gain at W = 256, 10% slower at W = 128); a
// cluster of two blocks sharing each panel by TMA multicast (half the L2
// reads, but twice the time, loads alone included); three consumers at
// W = 256 (ptxas needs 154 registers a thread, the cap is 128).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;               // threads a warpgroup
constexpr int ROWS = 64;              // rows a consumer warpgroup owns (wgmma's M)
constexpr int PANEL = 128;            // bytes of K a panel row holds (the swizzle span)
constexpr int ATOM = ROWS * PANEL;    // bytes of one 64-row panel of an A tile
constexpr int N_OUT = 8;              // features written a point
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;    // dynamic shared bytes a block may ask for
constexpr int ALIGN = 1024;           // the 128-byte swizzle repeats every 8 rows
constexpr int BAR_BYTES = 256;        // the mbarriers
constexpr int PRODUCER_REGS = 40;

// The shared-memory geometry of the kernel of a type and width
// (ops/mlp_stack.py::mlp_stack_geometry mirrors it).
template <typename T, int W>
struct Geo {
  static constexpr int E = sizeof(T);
  static constexpr int NCW = W <= 128 ? 4 : 2;                  // consumer warpgroups
  static constexpr int KP = (W * E + PANEL - 1) / PANEL;        // panels a layer
  static constexpr int A_BYTES = KP * ATOM;                     // a consumer's tile
  static constexpr int STAGE_BYTES = W * PANEL;                 // a weight panel
  static constexpr int FREE = SMEM_LIMIT - ALIGN - BAR_BYTES - NCW * A_BYTES;
  static constexpr int STAGES = FREE / STAGE_BYTES < MAX_STAGES ? FREE / STAGE_BYTES
                                                                 : MAX_STAGES;
  static constexpr int SMEM = ALIGN + NCW * A_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
  static constexpr int THREADS = (NCW + 1) * WG;
  // registers a consumer thread gets: the block's share (the launch bound,
  // in steps of 8) less the producer's 40, over the consumers
  static constexpr int CONSUMER_REGS =
      ((65536 / THREADS / 8 * 8) * THREADS - PRODUCER_REGS * WG) / (NCW * WG) / 8 * 8 > 232
          ? 232
          : ((65536 / THREADS / 8 * 8) * THREADS - PRODUCER_REGS * WG) / (NCW * WG) / 8 * 8;
  static_assert(STAGES >= 2, "the weight ring needs two stages");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

template <typename T> struct Acc;
template <> struct Acc<bf16> { typedef float type; };
template <> struct Acc<int8_t> { typedef int type; };

// d (+)= A . B over one k-step: A 64 x k, B W x k, both K-major in shared
// memory; scale = 0 starts the sums afresh. One overload a type and width
// (bf16: hopper.cuh's wgmma_bf16).
template <int M>
__device__ inline void mma(float (&d)[M], uint64_t a, uint64_t b, int scale) {
  wgmma_bf16<2 * M, 0>(d, a, b, scale);
}
#define WG_S8(n) "wgmma.mma_async.sync.aligned.m64n" #n "k32.s32.s8.s8 {"
__device__ inline void mma(int (&d)[32], uint64_t a, uint64_t b, int scale) {
  asm volatile(WG_PRED(34) WG_S8(64) WG_REGS0 "}, %32, %33, p;\n}\n"
               : WG_R32(WG_OI, 0) : "l"(a), "l"(b), "r"(scale));
}
__device__ inline void mma(int (&d)[64], uint64_t a, uint64_t b, int scale) {
  asm volatile(WG_PRED(66) WG_S8(128) WG_REGS0 ", " WG_REGS1 "}, %64, %65, p;\n}\n"
               : WG_R32(WG_OI, 0), WG_R32(WG_OI, 32) : "l"(a), "l"(b), "r"(scale));
}
__device__ inline void mma(int (&d)[96], uint64_t a, uint64_t b, int scale) {
  asm volatile(WG_PRED(98) WG_S8(192) WG_REGS0 ", " WG_REGS1 ", " WG_REGS2 "}, %96, %97, p;\n}\n"
               : WG_R32(WG_OI, 0), WG_R32(WG_OI, 32), WG_R32(WG_OI, 64)
               : "l"(a), "l"(b), "r"(scale));
}
__device__ inline void mma(int (&d)[128], uint64_t a, uint64_t b, int scale) {
  asm volatile(WG_PRED(130) WG_S8(256) WG_REGS0 ", " WG_REGS1 ", " WG_REGS2 ", " WG_REGS3
               "}, %128, %129, p;\n}\n"
               : WG_R32(WG_OI, 0), WG_R32(WG_OI, 32), WG_R32(WG_OI, 64), WG_R32(WG_OI, 96)
               : "l"(a), "l"(b), "r"(scale));
}

// ---- requantisation and the in-place epilogue -----------------------------

// bf16 ReLU: max.NaN.f32 returns NaN for a NaN v, as jnp.maximum(v, 0)
// does in the probe's _kernel_bf16, and otherwise what max.f32 (the
// instruction fmaxf compiles to) returns, so every other v keeps its bits.
__device__ inline float relu_nan(float v) {
  float y;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(y) : "f"(v));
  return y;
}
__device__ inline bf16 requant(float v) { return __float2bfloat16(relu_nan(v)); }
__device__ inline int8_t requant(int v) { return (int8_t)min(max(v >> 7, 0), 127); }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(int8_t v) { return (float)v; }

// Registers (4j + 2h, 4j + 2h + 1) of thread (warp, lane) hold row 16 warp
// + lane / 4 + 8 h, columns 8 j + 2 (lane % 4) + {0, 1}. Writes their
// requantised pair over the A tile at `tile`, at the byte the 128-byte
// swizzle gives the pair's first element (row r at 128 r in its 64-row
// panel, 16-byte chunk k at chunk k ^ (r % 8)).
__device__ inline void store_pair(uint32_t tile, int warp, int lane, int j, int h, float v0,
                                  float v1) {
  const int r = 16 * warp + lane / 4 + 8 * h;
  const uint32_t at = tile + (j / 8) * ATOM + r * PANEL + (((j % 8) ^ (r % 8)) << 4) +
                      (lane % 4) * 4;
  const __nv_bfloat162 p = __floats2bfloat162_rn(relu_nan(v0), relu_nan(v1));
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
               "r"(*reinterpret_cast<const uint32_t*>(&p))
               : "memory");
}
__device__ inline void store_pair(uint32_t tile, int warp, int lane, int j, int h, int v0,
                                  int v1) {
  const int r = 16 * warp + lane / 4 + 8 * h;
  const uint32_t at = tile + (j / 16) * ATOM + r * PANEL + ((((j / 2) % 8) ^ (r % 8)) << 4) +
                      (j % 2) * 8 + (lane % 4) * 2;
  // requant of both: max(v >> 7, 0), then cvt.pack's saturation at 127;
  // v0 in the low byte
  uint32_t p;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(p)
      : "r"(max(v1 >> 7, 0)), "r"(max(v0 >> 7, 0)), "r"(0));
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(at), "h"((uint16_t)p) : "memory");
}

template <typename T, int W>
__global__ void __launch_bounds__(Geo<T, W>::THREADS, 1)
mlp_stack_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, int P, int D,
                 float* __restrict__ out) {
  typedef Geo<T, W> G;
  typedef typename Acc<T>::type A;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) / ALIGN * ALIGN;
  const uint32_t a0 = base;                                   // NCW A tiles
  const uint32_t ring = base + G::NCW * G::A_BYTES;           // STAGES weight panels
  const uint32_t bars = ring + G::STAGES * G::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (G::STAGES + s); };
  auto xfull = [&](int c) { return bars + 8 * (2 * G::STAGES + c); };
  auto xempty = [&](int c) { return bars + 8 * (2 * G::STAGES + G::NCW + c); };
  const int tile_rows = ROWS * G::NCW;
  const int tiles = (P + tile_rows - 1) / tile_rows;
  constexpr int PANEL_ELEMS = PANEL / G::E;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), G::NCW);
    }
    for (int c = 0; c < G::NCW; ++c) {
      mbar_init(xfull(c), 1);
      mbar_init(xempty(c), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // the producer warpgroup: thread 0 streams the weight panels, thread
    // 32 the consumers' input tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int l = 0; l < D; ++l)
          for (int p = 0; p < G::KP; ++p) {
            mbar_wait(empty(stage), phase ^ 1);
            mbar_expect_tx(full(stage), G::STAGE_BYTES);
            tma_load(ring + stage * G::STAGE_BYTES, &wmap, p * PANEL_ELEMS, l * W, full(stage));
            if (++stage == G::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
    } else if (threadIdx.x == 32) {
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int c = 0; c < G::NCW; ++c) {
          mbar_wait(xempty(c), phase ^ 1);
          mbar_expect_tx(xfull(c), G::A_BYTES);
          for (int p = 0; p < G::KP; ++p)
            tma_load(a0 + c * G::A_BYTES + p * ATOM, &xmap, p * PANEL_ELEMS,
                     tile * tile_rows + c * ROWS, xfull(c));
        }
        phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS));
  const int c = wg - 1;                       // this consumer
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const uint32_t tile_a = a0 + c * G::A_BYTES;
  A d[W / 2];
  int stage = 0;
  uint32_t phase = 0, xphase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    mbar_wait(xfull(c), xphase);
    xphase ^= 1;
    for (int l = 0; l < D; ++l) {
      int prev = 0;
      for (int p = 0; p < G::KP; ++p) {
        mbar_wait(full(stage), phase);
        const uint32_t pa = tile_a + p * ATOM, pb = ring + stage * G::STAGE_BYTES;
        // a fence before every panel's group, as the barrier wait and the
        // release are divergent code between groups
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < PANEL / 32; ++k)
          mma(d, desc_sw128(pa + 32 * k), desc_sw128(pb + 32 * k), (p | k) != 0);
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();                 // the previous panel's group is done
          fence_acc(d);
          if (t == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == G::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (t == 0) mbar_arrive(empty(prev));
      // every warp's products of the layer have read the A tile
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG) : "memory");
      if (l + 1 == D) break;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(tile_a, warp, lane, j, h, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      // the generic stores, visible to the next layer's asynchronous reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG) : "memory");
    }
    if (t == 0) mbar_arrive(xempty(c));      // the A tile is free for the next input
    // the last layer's columns 0 .. 7: registers 0 .. 3
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row =
          (long long)tile * tile_rows + c * ROWS + 16 * warp + lane / 4 + 8 * h;
      if (row < P) {
        const float2 v = make_float2(to_f32(requant(d[2 * h])), to_f32(requant(d[2 * h + 1])));
        *reinterpret_cast<float2*>(out + row * N_OUT + 2 * (lane % 4)) = v;
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

template <typename T, int W>
int launch(const void* x, const void* w, int P, int D, float* out, cudaStream_t stream) {
  typedef Geo<T, W> G;
  if (D < 1 || P < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mlp_stack_kernel<T, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess || P == 0) return (int)e;
  CUtensorMap xmap, wmap;
  if (!tensor_map<T>(&xmap, x, P, W, ROWS) || !tensor_map<T>(&wmap, w, (long long)D * W, W, W))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (P + ROWS * G::NCW - 1) / (ROWS * G::NCW);
  mlp_stack_kernel<T, W><<<tiles < sms ? tiles : sms, G::THREADS, G::SMEM, stream>>>(
      xmap, wmap, P, D, out);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int occupancy(int* blocks_per_sm, int* smem_bytes) {
  typedef Geo<T, W> G;
  *smem_bytes = G::SMEM;
  cudaError_t e = cudaFuncSetAttribute(mlp_stack_kernel<T, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, mlp_stack_kernel<T, W>,
                                                      G::THREADS, G::SMEM);
  return (int)e;
}

template <typename T>
int dispatch(const void* x, const void* w, int P, int W, int D, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64: return launch<T, 64>(x, w, P, D, out, st);
    case 128: return launch<T, 128>(x, w, P, D, out, st);
    case 192: return launch<T, 192>(x, w, P, D, out, st);
    case 256: return launch<T, 256>(x, w, P, D, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (P, W) and w (D, W, W) row-major, 16-byte aligned; W in {64, 128,
// 192, 256} (the wrapper checks it too).
extern "C" int dfn_mlp_stack_bf16(const void* x, const void* w, int P, int W, int D,
                                  float* out, void* stream) {
  return dispatch<bf16>(x, w, P, W, D, out, stream);
}

extern "C" int dfn_mlp_stack_int8(const void* x, const void* w, int P, int W, int D,
                                  float* out, void* stream) {
  return dispatch<int8_t>(x, w, P, W, D, out, stream);
}

// Blocks of the kernel of a type (int8 != 0) and width that an SM holds,
// and its shared memory a block (bytes).
extern "C" int dfn_mlp_stack_occupancy(int int8, int W, int* blocks_per_sm, int* smem_bytes) {
  switch (W * 2 + (int8 != 0)) {
    case 128: return occupancy<bf16, 64>(blocks_per_sm, smem_bytes);
    case 256: return occupancy<bf16, 128>(blocks_per_sm, smem_bytes);
    case 384: return occupancy<bf16, 192>(blocks_per_sm, smem_bytes);
    case 512: return occupancy<bf16, 256>(blocks_per_sm, smem_bytes);
    case 129: return occupancy<int8_t, 64>(blocks_per_sm, smem_bytes);
    case 257: return occupancy<int8_t, 128>(blocks_per_sm, smem_bytes);
    case 385: return occupancy<int8_t, 192>(blocks_per_sm, smem_bytes);
    case 513: return occupancy<int8_t, 256>(blocks_per_sm, smem_bytes);
  }
  return (int)cudaErrorInvalidValue;
}
