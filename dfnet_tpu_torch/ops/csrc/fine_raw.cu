// fine_raw_t: NeRF-W MLP per point, fine (transient) or static pack.
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::fine_raw_t (Pallas kernel
// _fine_kernel_t, body _fine_raw_rows). Point p of the (N, S) sweep is ray
// p / S at the given sorted z[p]. Steps (fine pack): o + d z -> PE ->
// D-layer trunk with skip -> folded xyz_final . [dir | trans_0] + per-ray
// row dpt -> transient chain (3 layers at W/2) -> heads. Output: (9, N, S)
// float32 PRE-activation rows rgb 0:3, sigma 3, t-rgb 4:7, t-sigma 7,
// t-beta 8. The static pack (mode 1, the train-time coarse sweep) stops
// after the dir half of the dt layer (W/2 outputs) and writes (4, N, S)
// rows rgb 0:3, sigma 3.
//
// Bound on the card: operations. At W=128, D=8 (skip 4), F=10 a point
// costs ~3.2e5 bf16 flop and writes 36 B (reads 4 B of z, rays and dpt
// amortized per ray): 16384 rays x 128 samples is ~0.68 ms at the
// card's 989 TFLOP/s bf16 peak, ~0.09 ms of memory traffic.

#include "nerf_mlp.cuh"

using namespace dfn;

__global__ void __launch_bounds__(NTHREADS)
fine_raw_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ z, const float* __restrict__ dpt,
                int N, int S, const bf16* __restrict__ wts,
                const float* __restrict__ bias, const float* __restrict__ freqs,
                Dims dm, int stat, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout L = smem_layout(dm.TP, dm.K0, dm.W);
  const Tile t = carve(smem, L);
  const long long P = (long long)N * S;
  const long long p0 = (long long)blockIdx.x * dm.TP;
  for (int r = threadIdx.x; r < dm.TP; r += blockDim.x) {
    const long long p = p0 + r;
    t.ray[r] = p < P ? (int)(p / S) : -1;
    t.rz[r] = p < P ? z[p] : 0.f;
  }
  __syncthreads();
  build_pe(dm, t, ro, rd, freqs);
  if (stat)
    static_tile(dm, t, wts, bias, dpt);
  else
    fine_tile(dm, t, wts, bias, dpt);
  const int rows = stat ? N_STATIC : N_RAW;
  for (int idx = threadIdx.x; idx < dm.TP * rows; idx += blockDim.x) {
    const int c = idx / dm.TP, r = idx % dm.TP;
    if (p0 + r < P) out[(size_t)c * P + p0 + r] = t.raw[r * N_RAW + c];
  }
}

extern "C" int dfn_fine_raw(const float* ro, const float* rd, const float* z,
                            const float* dpt, int N, int S, const void* wts,
                            const float* bias, const float* freqs, int D, int W,
                            int skip, int F, int stat, float* out, void* stream) {
  Dims dm{D, W, skip, F, pe_cols(F), FLAT_TP};
  const SmemLayout L = smem_layout(dm.TP, dm.K0, dm.W);
  cudaError_t e = cudaFuncSetAttribute(fine_raw_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const long long P = (long long)N * S;
  const int grid = (int)((P + dm.TP - 1) / dm.TP);
  fine_raw_kernel<<<grid, NTHREADS, L.total, (cudaStream_t)stream>>>(
      ro, rd, z, dpt, N, S, (const bf16*)wts, bias, freqs, dm, stat, out);
  return (int)cudaGetLastError();
}
