// fine_raw_t: NeRF-W MLP per point, fine (transient) or static pack.
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::fine_raw_t (Pallas kernel
// _fine_kernel_t, body _fine_raw_rows). Point p of the (N, S) sweep is ray
// p / S at the given sorted z[p]. Steps (fine pack): o + d z -> PE ->
// D-layer trunk with skip -> folded xyz_final . [dir | trans_0] + per-ray
// row dpt -> transient chain (3 layers at W/2) -> heads. Output: (9, N, S)
// float32 PRE-activation rows rgb 0:3, sigma 3, t-rgb 4:7, t-sigma 7,
// t-beta 8. The static pack (stat = 1, the train-time coarse sweep) stops
// after the dir half of the dt layer (W/2 outputs) and writes (4, N, S)
// rows rgb 0:3, sigma 3.
//
// Bound on the card: operations. At W=128, D=8 (skip 4), F=10 a point
// costs ~3.2e5 bf16 flop and writes 36 B (reads 4 B of z, rays and dpt
// amortized per ray): 16384 rays x 128 samples is ~0.68 ms at the card's
// 989 TFLOP/s bf16 peak, ~0.09 ms of memory traffic.
//
// Design. The first version (nerf_mlp.cuh's generic layer code) read
// every WMMA B fragment of every layer straight from L2, 16 strided rows
// of 32 B, once per 16-row m-tile; its heads ran on the CUDA cores with
// 4-way bank conflicts. It ran at 3.9% of the bound. Here (the sweep is
// sweep.cuh::fine_sweep, which fine_composite.cu runs too):
//   - every layer goes through panel.cuh::panel_layer: each layer's
//     weights stream through two double-buffered cp.async panels, so a
//     weight is read from L2 once a tile, into conflict-free shared rows.
//     raw_bwd.cu's bwd_stash recomputes the trunk, dt and transient
//     activations (hence the ReLU masks of the backward under RawSweep) on
//     warpgroup MMA in the same k order; a card test holds its trunk
//     activations to these bit for bit;
//   - 64-point tiles with 2 output fragments a warp at W <= 128 (two
//     blocks an SM, at most 128 registers), 4 at W = 256 (one block);
//   - the PE takes one sincosf a (point, frequency, axis), full range
//     reduction as before (panel.cuh::build_pe_sincos, whose arithmetic
//     bwd_stash repeats);
//   - the heads are tensor-core products: one 16-column fragment a 16-point
//     m-tile sums sigma over h, rgb over d and the transient rows over t3
//     against a 16-row head matrix staged in shared memory (zero outside
//     each row's inputs); sigma's share is taken before the transient chain
//     overwrites h and parked in shared memory;
//   - the head outputs leave through a shared float tile, each output row
//     as the tile's consecutive points.
// Variants measured and dropped (PERF.md, Findings): heads on the CUDA cores,
// 128-point tiles at one block an SM, separate sinf and cosf.

#include "sweep.cuh"

using namespace dfn;

namespace {

// NJ: output fragments a warp holds (2 for W <= 128, 4 for W = 256).
template <int NJ>
__global__ void __launch_bounds__(NTHREADS, NJ <= 2 ? 2 : 1)
fine_raw_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ z, const float* __restrict__ dpt,
                int N, int S, const bf16* __restrict__ wts,
                const float* __restrict__ bias, const float* __restrict__ freqs,
                Dims dm, int stat, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(dm.K0, dm.W);
  const SweepTile t = carve_sweep(smem, L);
  const int NR = stat ? N_STATIC : N_RAW;
  const long long P = (long long)N * S;
  const long long p0 = (long long)blockIdx.x * TP;
  for (int r = threadIdx.x; r < TP; r += blockDim.x) {
    const long long p = p0 + r;
    t.tl.ray[r] = p < P ? (int)(p / S) : -1;
    t.tl.rz[r] = p < P ? z[p] : 0.f;
  }
  const Offsets of = offsets(dm, stat);
  stage_fine_heads(t.heads, wts + of.w_heads, dm.W, stat);
  __syncthreads();
  fine_sweep<NJ>(t, dm, stat, ro, rd, dpt, wts, bias, freqs);
  for (int idx = threadIdx.x; idx < TP * NR; idx += blockDim.x) {
    const int c = idx / TP, r = idx % TP;
    if (p0 + r < P) out[(size_t)c * P + p0 + r] = t.hout[r * HEAD_LD + c] + bias[of.b_heads + c];
  }
}

template <int NJ>
int launch(const float* ro, const float* rd, const float* z, const float* dpt, int N, int S,
           const bf16* wts, const float* bias, const float* freqs, Dims dm, int stat,
           float* out, cudaStream_t stream) {
  dm.TP = TP;
  const FwdLayout L = fwd_layout(dm.K0, dm.W);
  cudaError_t e = cudaFuncSetAttribute(fine_raw_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const long long P = (long long)N * S;
  const unsigned grid = (unsigned)((P + dm.TP - 1) / dm.TP);
  fine_raw_kernel<NJ><<<grid, NTHREADS, L.total, stream>>>(ro, rd, z, dpt, N, S, wts, bias,
                                                           freqs, dm, stat, out);
  return (int)cudaGetLastError();
}

template <int NJ>
int occupancy(int W, int K0, int* blocks_per_sm, int* smem_bytes) {
  const FwdLayout L = fwd_layout(K0, W);
  *smem_bytes = (int)L.total;
  cudaError_t e = cudaFuncSetAttribute(fine_raw_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fine_raw_kernel<NJ>,
                                                      NTHREADS, L.total);
  return (int)e;
}

}  // namespace

// W: a multiple of 32, at most 256 (the wrapper checks it too). NJ = 2 at
// W <= 128 (two blocks an SM), 4 at W <= 256 (one block).
extern "C" int dfn_fine_raw(const float* ro, const float* rd, const float* z,
                            const float* dpt, int N, int S, const void* wts,
                            const float* bias, const float* freqs, int D, int W,
                            int skip, int F, int stat, float* out, void* stream) {
  if (W > 256 || W % 32) return (int)cudaErrorInvalidValue;
  const Dims dm{D, W, skip, F, pe_cols(F), 0};
  const bf16* w = (const bf16*)wts;
  cudaStream_t st = (cudaStream_t)stream;
  return W > 128 ? launch<4>(ro, rd, z, dpt, N, S, w, bias, freqs, dm, stat, out, st)
                 : launch<2>(ro, rd, z, dpt, N, S, w, bias, freqs, dm, stat, out, st);
}

// Blocks of the kernel a width runs that an SM holds, and its shared
// memory a block (bytes).
extern "C" int dfn_fine_raw_occupancy(int W, int F, int* blocks_per_sm, int* smem_bytes) {
  if (W > 256 || W % 32) return (int)cudaErrorInvalidValue;
  return W > 128 ? occupancy<4>(W, pe_cols(F), blocks_per_sm, smem_bytes)
                 : occupancy<2>(W, pe_cols(F), blocks_per_sm, smem_bytes);
}
