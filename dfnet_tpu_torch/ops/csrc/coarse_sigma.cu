// coarse_sigma_t: sigma-only MLP sweep at in-kernel uniform z.
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::coarse_sigma_t (Pallas kernel
// _coarse_kernel_t). Point p of the (N, S) sweep is ray p / S at sample
// s = p % S, z = near (1 - t) + far t with t = s / (S - 1) (lindisp:
// 1 / (1/near (1 - t) + 1/far t)). Steps: o + d z -> PE -> D-layer trunk
// -> sigma head. Output: (N, S) float32 PRE-softplus sigma.
//
// Bound on the card: operations. Per point the trunk does
// 2 (K0 W + (D - 1) W^2 [+ K0 W at the skip]) flops in bf16 and reads
// 24 B of rays amortized over S points; it writes 4 B. On the proposal
// net (D=2, W=64, F=4) that is ~1.2e4 flop per point against 4 B out,
// ~3e3 flop/B, above the card's ~295 flop/B balance point.
//
// Design. The first version ran nerf_mlp.cuh's generic layer code (every
// WMMA B fragment read from L2 once per 16-row m-tile) and a sigma head of
// one sequential dot a point; it ran at 2-4% of the bound. Here the sweep
// is sweep.cuh::sigma_sweep, fine_raw_t's trunk plus one head: 64-point
// tiles, each layer's weights streamed through two cp.async panels
// (panel.cuh::panel_layer), the PE with one sincosf a (point, frequency,
// axis), and the sigma head as one WMMA fragment a 16-point m-tile against
// a 16-row head matrix whose row 0 is w_sigma. A warp holds NJ 16-column
// output fragments: 1 at W <= 64 (the proposal net), 2 at W <= 128 (the
// coarse net), 4 at W <= 256. Measured and kept (PERF.md, Findings): three
// blocks an SM at NJ = 1 rather than two.

#include "sweep.cuh"

using namespace dfn;

namespace {

// Three blocks an SM at W <= 64 (the proposal net: two short layers a tile,
// so latency, not the tensor cores, bounds a block), two at W <= 128, one
// at W <= 256.
template <int NJ>
__global__ void __launch_bounds__(NTHREADS, NJ == 1 ? 3 : (NJ <= 2 ? 2 : 1))
coarse_sigma_kernel(const float* __restrict__ ro, const float* __restrict__ rd, int N,
                    int S, float near, float far, float inv_s1, int lindisp,
                    const bf16* __restrict__ wts, const float* __restrict__ bias,
                    const float* __restrict__ freqs, Dims dm, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(dm.K0, dm.W);
  const SweepTile t = carve_sweep(smem, L);
  const long long P = (long long)N * S;
  const long long p0 = (long long)blockIdx.x * TP;
  for (int r = threadIdx.x; r < TP; r += blockDim.x) {
    const long long p = p0 + r;
    int ray = -1;
    float z = 0.f;
    if (p < P) {
      ray = (int)(p / S);
      const float tt = (float)(int)(p % S) * inv_s1;
      z = lindisp ? 1.f / (1.f / near * (1.f - tt) + 1.f / far * tt)
                  : near * (1.f - tt) + far * tt;
    }
    t.tl.ray[r] = ray;
    t.tl.rz[r] = z;
  }
  // after the trunk: w_sigma (W), b_sigma (1)
  stage_sigma_head(t.heads, wts + trunk_off(dm, dm.D), dm.W);
  __syncthreads();
  sigma_sweep<NJ>(t, dm, ro, rd, wts, bias, freqs);
  const float b_sigma = bias[dm.D * dm.W];
  for (int r = threadIdx.x; r < TP; r += blockDim.x)
    if (p0 + r < P) out[p0 + r] = t.hout[r * HEAD_LD] + b_sigma;
}

template <int NJ>
int launch(const float* ro, const float* rd, int N, int S, float near, float far,
           float inv_s1, int lindisp, const bf16* wts, const float* bias,
           const float* freqs, Dims dm, float* out, cudaStream_t stream) {
  dm.TP = TP;
  const FwdLayout L = fwd_layout(dm.K0, dm.W);
  cudaError_t e = cudaFuncSetAttribute(coarse_sigma_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const long long P = (long long)N * S;
  const unsigned grid = (unsigned)((P + TP - 1) / TP);
  coarse_sigma_kernel<NJ><<<grid, NTHREADS, L.total, stream>>>(
      ro, rd, N, S, near, far, inv_s1, lindisp, wts, bias, freqs, dm, out);
  return (int)cudaGetLastError();
}

template <int NJ>
int occupancy(int W, int K0, int* blocks_per_sm, int* smem_bytes) {
  const FwdLayout L = fwd_layout(K0, W);
  *smem_bytes = (int)L.total;
  cudaError_t e = cudaFuncSetAttribute(coarse_sigma_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, coarse_sigma_kernel<NJ>,
                                                      NTHREADS, L.total);
  return (int)e;
}

}  // namespace

// W: a multiple of 32, at most 256 (the wrapper checks it too).
extern "C" int dfn_coarse_sigma(const float* ro, const float* rd, int N, int S,
                                float near, float far, float inv_s1, int lindisp,
                                const void* wts, const float* bias, const float* freqs,
                                int D, int W, int skip, int F, float* out, void* stream) {
  if (W > 256 || W % 32) return (int)cudaErrorInvalidValue;
  const Dims dm{D, W, skip, F, pe_cols(F), 0};
  const bf16* w = (const bf16*)wts;
  cudaStream_t st = (cudaStream_t)stream;
  if (W > 128)
    return launch<4>(ro, rd, N, S, near, far, inv_s1, lindisp, w, bias, freqs, dm, out, st);
  if (W > 64)
    return launch<2>(ro, rd, N, S, near, far, inv_s1, lindisp, w, bias, freqs, dm, out, st);
  return launch<1>(ro, rd, N, S, near, far, inv_s1, lindisp, w, bias, freqs, dm, out, st);
}

// Blocks of the kernel a width runs that an SM holds, and its shared
// memory a block (bytes).
extern "C" int dfn_coarse_sigma_occupancy(int W, int F, int* blocks_per_sm, int* smem_bytes) {
  if (W > 256 || W % 32) return (int)cudaErrorInvalidValue;
  if (W > 128) return occupancy<4>(W, pe_cols(F), blocks_per_sm, smem_bytes);
  if (W > 64) return occupancy<2>(W, pe_cols(F), blocks_per_sm, smem_bytes);
  return occupancy<1>(W, pe_cols(F), blocks_per_sm, smem_bytes);
}
