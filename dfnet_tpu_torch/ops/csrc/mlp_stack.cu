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
// Layout: a block owns TP = 64 points; their activations stay in shared
// memory between layers (two ping-pong tiles). Tiles and weights are stored
// k-blocked, [W/16][rows][16]: a 16 x 16 fragment is one contiguous block
// (ldm 16) that starts on a multiple of 256 elements, so every WMMA load
// and store gets the 256-bit aligned pointer it requires. (Row-major int8
// would put every odd 16-element k step on a 16-byte boundary.) The
// wrapper repacks the weights, (D, W, W) -> (D, W/16, W, 16). Each warp
// takes 16 x 16 output tiles in turn: WMMA 16x16x16 fragments (bf16 ->
// float32, or s8 -> int32) with the activations from shared memory and the
// weights from global memory (at most 6 x 128 KB in bf16, so they stay in
// L2); the epilogue requantises into the other tile, where an output tile
// is again one contiguous block.
//
// Bound on the card: operations. A layer is 2 W^2 operations a point
// against W (int8) or 2 W (bf16) bytes of input read once for the whole
// stack: at W=256, D=6 about 3e3 operations a byte, far above the card's
// ~295 flop/B balance point. Peaks: 989 TFLOP/s bf16, 1,979 TOP/s int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TP = 64;        // points per block
constexpr int N_OUT = 8;      // features written per point

template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> { typedef float acc; };
template <> struct Traits<signed char> { typedef int acc; };

__device__ inline __nv_bfloat16 requant(float v) { return __float2bfloat16(fmaxf(v, 0.f)); }
__device__ inline signed char requant(int v) { return (signed char)min(max(v >> 7, 0), 127); }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(signed char v) { return (float)v; }

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
__host__ __device__ inline size_t tile_bytes(int W) {
  return align128((size_t)TP * W * sizeof(T));
}

// element (r, c) of a k-blocked tile with `rows` rows
__device__ inline int kblocked(int r, int c, int rows) {
  return ((c / 16) * rows + r) * 16 + c % 16;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
mlp_stack_kernel(const T* __restrict__ x, const T* __restrict__ w, int P, int W, int D,
                 float* __restrict__ out) {
  typedef typename Traits<T>::acc A;
  extern __shared__ __align__(128) unsigned char smem[];
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = reinterpret_cast<T*>(smem + tile_bytes<T>(W));
  A* scratch = reinterpret_cast<A*>(smem + 2 * tile_bytes<T>(W));
  const long long p0 = (long long)blockIdx.x * TP;

  // the block's input rows, 16 B a thread (within one k-block); rows past
  // P are zero
  const int vec = 16 / sizeof(T), per_row = W / vec;
  for (int idx = threadIdx.x; idx < TP * per_row; idx += NTHREADS) {
    const int r = idx / per_row, c = (idx % per_row) * vec;
    int4 v = make_int4(0, 0, 0, 0);
    if (p0 + r < P) v = *reinterpret_cast<const int4*>(x + (p0 + r) * W + c);
    *reinterpret_cast<int4*>(cur + kblocked(r, c, TP)) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = TP / 16, nt = W / 16;
  A* scr = scratch + warp * 256;
  for (int l = 0; l < D; ++l) {
    const T* wl = w + (size_t)l * W * W;
    for (int tile = warp; tile < mt * nt; tile += NWARPS) {
      const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, A> acc;
      wmma::fill_fragment(acc, (A)0);
      for (int kb = 0; kb < W / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(a, cur + kblocked(m0, kb * 16, TP), 16);
        wmma::load_matrix_sync(b, wl + (size_t)kblocked(n0, kb * 16, W), 16);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      T* dst = nxt + kblocked(m0, n0, TP);     // the output tile's block
      for (int e = lane; e < 256; e += 32) dst[e] = requant(scr[e]);
      __syncwarp();
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int idx = threadIdx.x; idx < TP * N_OUT; idx += NTHREADS) {
    const int r = idx / N_OUT, c = idx % N_OUT;
    if (p0 + r < P) out[(p0 + r) * N_OUT + c] = to_f32(cur[kblocked(r, c, TP)]);
  }
}

template <typename T>
int launch(const void* x, const void* w, int P, int W, int D, float* out, void* stream) {
  if (W < 16 || W % 16 != 0 || D < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * tile_bytes<T>(W) +
                      (size_t)NWARPS * 256 * sizeof(typename Traits<T>::acc);
  cudaError_t e = cudaFuncSetAttribute(mlp_stack_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return 0;
  const int grid = (P + TP - 1) / TP;
  mlp_stack_kernel<T><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, P, W, D, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dfn_mlp_stack_bf16(const void* x, const void* w, int P, int W, int D,
                                  float* out, void* stream) {
  return launch<__nv_bfloat16>(x, w, P, W, D, out, stream);
}

extern "C" int dfn_mlp_stack_int8(const void* x, const void* w, int P, int W, int D,
                                  float* out, void* stream) {
  return launch<signed char>(x, w, P, W, D, out, stream);
}
