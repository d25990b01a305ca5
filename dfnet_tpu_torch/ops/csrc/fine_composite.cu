// fine_composite_t: the fine sweep plus test-time NeRF-W compositing.
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::fine_composite_t (Pallas kernel
// _fine_composite_kernel_t). Per ray of sorted z (N, S): fine_raw_t's
// pre-activation outputs at each sample, then sigmoid / softplus, deltas
// with a 1e2 terminal, the combined and the static-only exclusive
// transmittances, and the per-ray sums. Output: (8, N) float32 rows rgb
// 0:3, acc 3, static depth 4, static rgb 5:8.
//
// Bound on the card: operations, as fine_raw (~3.2e5 bf16 flop a point at
// W=128); it writes 32 B a ray instead of 36 B a point.
//
// Design. The first version ran nerf_mlp.cuh's generic layer code over one
// tile of round16(R S) points, R = max(1, 64 / S); at S = 128 that was one
// ray a 128-point block, and one thread ran the ray's whole composite
// while 255 waited (2.6x fine_raw_t's time at that shape). Here:
//   - the sweep is sweep.cuh::fine_sweep over panel.cuh's layers: the PE,
//     k order, bias, dpt and ReLU of fine_raw_t's warpgroup kernel, so a
//     point's trunk, dt and transient activations are fine_raw_t's bit for
//     bit; the heads sum in another order, and a card test
//     (test_fine_composite_kernel_matches_plain_shipped_depth) holds the
//     composite to that of fine_raw_t's rows at 1e-5;
//   - a block owns R whole rays (the wrapper's fine_composite_geometry
//     chooses R; the entry point checks it) and runs their R S points
//     through ceil(R S / 64) sub-tiles of 64 rows in turn, the dead rows
//     of the last masked. Each sub-tile leaves its 8 composite inputs (the
//     raw rows 0:8, bias added) in a per-block buffer of R S points,
//     beside the rays' z;
//   - the composite is parallel: one warp a ray (the warps loop over the
//     block's rays), each lane over a contiguous run of ceil(S / 32)
//     samples. A lane takes its run's products of (1 - alpha) and of
//     (1 - alpha_static); an exclusive multiplicative warp scan
//     (__shfl_up_sync) gives each lane its entering transmittances; the
//     lane then accumulates its run, and a warp sum (__shfl_xor_sync) ends
//     the ray. The terms are the reference's, with expf and log1pf (no
//     fast-math intrinsics).

#include "sweep.cuh"

using namespace dfn;

namespace {

constexpr int MAX_BLOCK_POINTS = 256;   // R S when a block holds more than one ray
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }
__device__ inline float softplusf_(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

// Shared bytes a block: the sweep's, then z and the 8 composite inputs of
// its R S points (float32).
__host__ __device__ inline size_t comp_smem(int K0, int W, int RS) {
  return fwd_layout(K0, W).total + align128((size_t)(1 + N_COMP) * RS * sizeof(float));
}

// The alphas of sample s of the ray whose first point is b in the block's
// buffer (zb: z; q: the 8 composite inputs, row c at q + c RS).
__device__ inline void alphas(const float* zb, const float* q, int RS, int S, int b, int s,
                              float& sa, float& ta, float& al) {
  const int i = b + s;
  const float zs = zb[i];
  const float dz = s == S - 1 ? 1e2f : zb[i + 1] - zs;
  const float ssig = softplusf_(q[3 * RS + i]), tsig = softplusf_(q[7 * RS + i]);
  sa = 1.f - expf(-dz * ssig);
  ta = 1.f - expf(-dz * tsig);
  al = 1.f - expf(-dz * (ssig + tsig));
}

// NJ: output fragments a warp holds (2 for W <= 128, 4 for W <= 256).
template <int NJ>
__global__ void __launch_bounds__(NTHREADS, NJ <= 2 ? 2 : 1)
fine_composite_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                      const float* __restrict__ z, const float* __restrict__ dpt,
                      int N, int S, int R, const bf16* __restrict__ wts,
                      const float* __restrict__ bias, const float* __restrict__ freqs,
                      Dims dm, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(dm.K0, dm.W);
  const SweepTile t = carve_sweep(smem, L);
  const int RS = R * S;
  float* zb = reinterpret_cast<float*>(smem + L.total);   // (R S) the rays' z
  float* q = zb + RS;                                       // (8, R S) composite inputs
  const int ray0 = blockIdx.x * R;
  const int rays = min(R, N - ray0);                        // live rays of the block
  const int live = rays * S;                                // their points
  for (int i = threadIdx.x; i < live; i += blockDim.x) zb[i] = z[(size_t)ray0 * S + i];
  const Offsets of = offsets(dm, 0);
  stage_fine_heads(t.heads, wts + of.w_heads, dm.W, 0);
  __syncthreads();
  // the sub-tiles: block point i is row i % 64 of sub-tile i / 64
  for (int i0 = 0; i0 < live; i0 += TP) {
    for (int r = threadIdx.x; r < TP; r += blockDim.x) {
      const int i = i0 + r;
      t.tl.ray[r] = i < live ? ray0 + i / S : -1;
      t.tl.rz[r] = i < live ? zb[i] : 0.f;
    }
    __syncthreads();
    fine_sweep<NJ>(t, dm, 0, ro, rd, dpt, wts, bias, freqs);
    for (int idx = threadIdx.x; idx < N_COMP * TP; idx += blockDim.x) {
      const int c = idx / TP, r = idx % TP, i = i0 + r;
      if (i < live) q[c * RS + i] = t.hout[r * HEAD_LD + c] + bias[of.b_heads + c];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run = (S + 31) / 32;
  for (int lr = warp; lr < rays; lr += NWARPS) {
    const int b = lr * S;
    const int s0 = min(S, lane * run), s1 = min(S, s0 + run);
    float sa, ta, al;
    // the run's products, then the exclusive scan of them over the lanes
    float T = 1.f, Ts = 1.f;
    for (int s = s0; s < s1; ++s) {
      alphas(zb, q, RS, S, b, s, sa, ta, al);
      T *= 1.f - al;
      Ts *= 1.f - sa;
    }
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, T, o), us = __shfl_up_sync(FULL, Ts, o);
      if (lane >= o) {
        T *= u;
        Ts *= us;
      }
    }
    T = __shfl_up_sync(FULL, T, 1);
    Ts = __shfl_up_sync(FULL, Ts, 1);
    if (lane == 0) T = Ts = 1.f;
    // the run's sums: rgb 0:3, acc 3, static depth 4, static rgb 5:8
    float v[N_COMP] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = s0; s < s1; ++s) {
      alphas(zb, q, RS, S, b, s, sa, ta, al);
      const int i = b + s;
      const float sw = sa * T, tw = ta * T, swo = sa * Ts;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float sc = sigmoidf_(q[c * RS + i]);
        v[c] += sw * sc + tw * sigmoidf_(q[(4 + c) * RS + i]);
        v[5 + c] += swo * sc;
      }
      v[3] += al * T;
      v[4] += swo * zb[i];
      T *= 1.f - al;
      Ts *= 1.f - sa;
    }
#pragma unroll
    for (int c = 0; c < N_COMP; ++c)
      for (int o = 16; o > 0; o >>= 1) v[c] += __shfl_xor_sync(FULL, v[c], o);
    if (lane < N_COMP) {
      float x = v[0];
#pragma unroll
      for (int c = 1; c < N_COMP; ++c)
        if (lane == c) x = v[c];
      out[(size_t)lane * N + ray0 + lr] = x;
    }
  }
}

template <int NJ>
int launch(const float* ro, const float* rd, const float* z, const float* dpt, int N, int S,
           int R, const bf16* wts, const float* bias, const float* freqs, Dims dm, float* out,
           cudaStream_t stream) {
  dm.TP = TP;
  const size_t smem = comp_smem(dm.K0, dm.W, R * S);
  cudaError_t e = cudaFuncSetAttribute(fine_composite_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((N + R - 1) / R);
  fine_composite_kernel<NJ><<<grid, NTHREADS, smem, stream>>>(ro, rd, z, dpt, N, S, R, wts,
                                                              bias, freqs, dm, out);
  return (int)cudaGetLastError();
}

template <int NJ>
int occupancy(int W, int K0, int RS, int* blocks_per_sm, int* smem_bytes) {
  const size_t smem = comp_smem(K0, W, RS);
  *smem_bytes = (int)smem;
  cudaError_t e = cudaFuncSetAttribute(fine_composite_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fine_composite_kernel<NJ>,
                                                      NTHREADS, smem);
  return (int)e;
}

// The wrapper's geometry: W a multiple of 32, at most 256; R >= 1 rays a
// block, R S <= MAX_BLOCK_POINTS unless R = 1.
bool valid(int W, int S, int R) {
  return W <= 256 && W % 32 == 0 && S >= 2 && R >= 1 && (R == 1 || R * S <= MAX_BLOCK_POINTS);
}

}  // namespace

// R: rays a block (ops/nerf_kernels.py::fine_composite_geometry). NJ = 2
// at W <= 128 (two blocks an SM), 4 at W <= 256 (one block).
extern "C" int dfn_fine_composite(const float* ro, const float* rd, const float* z,
                                  const float* dpt, int N, int S, const void* wts,
                                  const float* bias, const float* freqs, int D, int W,
                                  int skip, int F, int R, float* out, void* stream) {
  if (!valid(W, S, R)) return (int)cudaErrorInvalidValue;
  const Dims dm{D, W, skip, F, pe_cols(F), 0};
  const bf16* w = (const bf16*)wts;
  cudaStream_t st = (cudaStream_t)stream;
  return W > 128 ? launch<4>(ro, rd, z, dpt, N, S, R, w, bias, freqs, dm, out, st)
                 : launch<2>(ro, rd, z, dpt, N, S, R, w, bias, freqs, dm, out, st);
}

// Blocks of the kernel a width runs that an SM holds, and its shared
// memory a block (bytes), at S samples a ray and R rays a block.
extern "C" int dfn_fine_composite_occupancy(int W, int F, int S, int R, int* blocks_per_sm,
                                            int* smem_bytes) {
  if (!valid(W, S, R)) return (int)cudaErrorInvalidValue;
  return W > 128 ? occupancy<4>(W, pe_cols(F), R * S, blocks_per_sm, smem_bytes)
                 : occupancy<2>(W, pe_cols(F), R * S, blocks_per_sm, smem_bytes);
}
