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
// Design. The first version (nerf_mlp.cuh::fine_tile, which
// fine_composite_t still runs) read every WMMA B fragment of every layer
// straight from L2, 16 strided rows of 32 B, once per 16-row m-tile; its
// heads ran on the CUDA cores with 4-way bank conflicts. It ran at 3.9% of
// the bound. Here:
//   - every layer goes through panel.cuh::panel_layer (the arithmetic of
//     raw_bwd.cu's bwd_stash, without its stash stores): each layer's
//     weights stream through two double-buffered cp.async panels, so a
//     weight is read from L2 once a tile, into conflict-free shared rows.
//     The k order of every sum is bwd_stash's, so the trunk, dt and
//     transient activations (hence the ReLU masks the backward recomputes
//     under RawSweep) are bit-equal to the ones it stashes;
//   - 64-point tiles with 2 output fragments a warp at W <= 128 (two
//     blocks an SM, at most 128 registers), 4 at W = 256 (one block);
//   - the PE takes one sincosf a (point, frequency, axis), full range
//     reduction as before (panel.cuh::build_pe_sincos, which bwd_stash
//     runs too);
//   - the heads are tensor-core products: one 16-column fragment a 16-point
//     m-tile sums sigma over h, rgb over d and the transient rows over t3
//     against a 16-row head matrix staged in shared memory (zero outside
//     each row's inputs); sigma's share is taken before the transient chain
//     overwrites h and parked in shared memory;
//   - the head outputs leave through a shared float tile, each output row
//     as the tile's consecutive points.
// Variants measured and dropped (PERF.md, Findings): heads on the CUDA cores,
// 128-point tiles at one block an SM, separate sinf and cosf.

#include "panel.cuh"

using namespace dfn;

namespace {

constexpr int TP = 64;        // points a tile (panel_layer's rows)
constexpr int HEAD_LD = 20;   // row stride of the shared head-output tile (16 used)

struct FwdLayout {
  size_t x0, hA, hB, pan0, pan1, scratch, heads, hout, pts, rz, ray, total;
};

// heads: the 16-row head matrix, columns [0, W) over h (sigma), [W, W + W/2)
// over d (rgb), [W + W/2, 2W) over t3 (transient); hout: (TP, HEAD_LD) float
__host__ __device__ inline FwdLayout fwd_layout(int K0, int W) {
  FwdLayout L;
  const size_t b = sizeof(bf16);
  size_t o = 0;
  L.x0 = o;      o = align128(o + (size_t)TP * (K0 + PAD) * b);
  L.hA = o;      o = align128(o + (size_t)TP * (W + PAD) * b);
  L.hB = o;      o = align128(o + (size_t)TP * (W + PAD) * b);
  L.pan0 = o;    o = align128(o + panel_elems(W) * b);
  L.pan1 = o;    o = align128(o + panel_elems(W) * b);
  L.scratch = o; o = align128(o + (size_t)NWARPS * 256 * sizeof(float));
  L.heads = o;   o = align128(o + (size_t)16 * (2 * W + PAD) * b);
  L.hout = o;    o = align128(o + (size_t)TP * HEAD_LD * sizeof(float));
  L.pts = o;     o = align128(o + (size_t)TP * 3 * sizeof(float));
  L.rz = o;      o = align128(o + (size_t)TP * sizeof(float));
  L.ray = o;     o = align128(o + (size_t)TP * sizeof(int));
  L.total = o;
  return L;
}

// acc (+)= in[m0:m0+16, 0:K] . heads[:, c0:c0+K]^T for the warp's m-tile
__device__ inline void head_product(wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc,
                                    const bf16* in, int ld, int m0, int K,
                                    const bf16* heads, int ldw, int c0) {
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(a, in + (size_t)m0 * ld + k, ld);
    wmma::load_matrix_sync(b, heads + c0 + k, ldw);
    wmma::mma_sync(acc, a, b, acc);
  }
}

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
  const int W = dm.W, half = W / 2, K0 = dm.K0, D = dm.D;
  const int Wd = stat ? half : W, NR = stat ? N_STATIC : N_RAW;
  const int ldx = K0 + PAD, ldh = W + PAD, ldw = 2 * W + PAD;
  bf16* x0 = reinterpret_cast<bf16*>(smem + L.x0);
  bf16* hA = reinterpret_cast<bf16*>(smem + L.hA);
  bf16* hB = reinterpret_cast<bf16*>(smem + L.hB);
  bf16* pan0 = reinterpret_cast<bf16*>(smem + L.pan0);
  bf16* pan1 = reinterpret_cast<bf16*>(smem + L.pan1);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  bf16* heads = reinterpret_cast<bf16*>(smem + L.heads);
  float* hout = reinterpret_cast<float*>(smem + L.hout);
  Tile tl{};
  tl.x0 = x0;
  tl.pts = reinterpret_cast<float*>(smem + L.pts);
  tl.rz = reinterpret_cast<float*>(smem + L.rz);
  tl.ray = reinterpret_cast<int*>(smem + L.ray);
  tl.scratch = scratch;

  const long long P = (long long)N * S;
  const long long p0 = (long long)blockIdx.x * TP;
  for (int r = threadIdx.x; r < TP; r += blockDim.x) {
    const long long p = p0 + r;
    tl.ray[r] = p < P ? (int)(p / S) : -1;
    tl.rz[r] = p < P ? z[p] : 0.f;
  }
  const Offsets of = offsets(dm, stat);
  const bf16* w_heads = wts + of.w_heads;
  // the head matrix: row c holds head row c's weights over its input's
  // columns of [h | d | t3], zero elsewhere
  for (int idx = threadIdx.x; idx < 16 * 2 * W; idx += blockDim.x) {
    const int c = idx / (2 * W), k = idx % (2 * W);
    bf16 v = __float2bfloat16(0.f);
    if (k < W) {
      if (c == 3) v = w_heads[(size_t)3 * W + k];
    } else if (k < W + half) {
      if (c < 3) v = w_heads[(size_t)c * W + k - W];
    } else if (!stat && c >= 4 && c < N_RAW) {
      v = w_heads[(size_t)c * W + k - W];
    }
    heads[c * ldw + k] = v;
  }
  __syncthreads();

  build_pe_sincos(dm, tl, ro, rd, freqs);
  const StashOut none{nullptr, 0};
  panel_layer<false, NJ, false>(x0, ldx, K0, wts, nullptr, 0, 0, nullptr, W, pan0, pan1,
                                bias, nullptr, 0, nullptr, nullptr, 0, nullptr, 0,
                                nullptr, hA, ldh, none, scratch);
  bf16* X = hA;
  bf16* Y = hB;
  for (int i = 1; i < D; ++i) {
    const bf16* wi = wts + trunk_off(dm, i);
    if (i == dm.skip)
      panel_layer<false, NJ, false>(x0, ldx, K0, wi, X, ldh, W, wi + (size_t)W * K0, W,
                                    pan0, pan1, bias + i * W, nullptr, 0, nullptr,
                                    nullptr, 0, nullptr, 0, nullptr, Y, ldh, none,
                                    scratch);
    else
      panel_layer<false, NJ, false>(X, ldh, W, wi, nullptr, 0, 0, nullptr, W, pan0,
                                    pan1, bias + i * W, nullptr, 0, nullptr, nullptr, 0,
                                    nullptr, 0, nullptr, Y, ldh, none, scratch);
    bf16* t = X;
    X = Y;
    Y = t;
  }
  // X = h_{D-1}; Y = dt0 = [d | t0] (d only in the static pack)
  panel_layer<false, NJ, false>(X, ldh, W, wts + of.w_dt, nullptr, 0, 0, nullptr, Wd,
                                pan0, pan1, bias + of.b_dt, dpt, Wd, tl.ray, nullptr, 0,
                                nullptr, 0, nullptr, Y, ldh, none, scratch);
  const int warp = threadIdx.x / 32;
  // sigma over h, before the transient chain overwrites h
  if (warp < TP / 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    head_product(acc, X, ldh, warp * 16, W, heads, ldw, 0);
    wmma::store_matrix_sync(hout + warp * 16 * HEAD_LD, acc, HEAD_LD, wmma::mem_row_major);
  }
  if (!stat) {
    // t1 over h's first half, t2 over its second, t3 over the first
    const bf16* w_tr = wts + of.w_tr;
    const float* b_tr = bias + of.b_tr;
    const size_t hh = (size_t)half * half;
    panel_layer<false, NJ, false>(Y + half, ldh, half, w_tr, nullptr, 0, 0, nullptr, half,
                                  pan0, pan1, b_tr, nullptr, 0, nullptr, nullptr, 0,
                                  nullptr, 0, nullptr, X, ldh, none, scratch);
    panel_layer<false, NJ, false>(X, ldh, half, w_tr + hh, nullptr, 0, 0, nullptr, half,
                                  pan0, pan1, b_tr + half, nullptr, 0, nullptr, nullptr,
                                  0, nullptr, 0, nullptr, X + half, ldh, none, scratch);
    panel_layer<false, NJ, false>(X + half, ldh, half, w_tr + 2 * hh, nullptr, 0, 0,
                                  nullptr, half, pan0, pan1, b_tr + 2 * half, nullptr, 0,
                                  nullptr, nullptr, 0, nullptr, 0, nullptr, X, ldh, none,
                                  scratch);
  } else {
    __syncthreads();   // hout's sigma share is complete
  }
  // rgb over d (Y), transient rows over t3 (X)
  if (warp < TP / 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* ho = hout + warp * 16 * HEAD_LD;
    wmma::load_matrix_sync(acc, ho, HEAD_LD, wmma::mem_row_major);
    head_product(acc, Y, ldh, warp * 16, half, heads, ldw, W);
    if (!stat) head_product(acc, X, ldh, warp * 16, half, heads, ldw, W + half);
    wmma::store_matrix_sync(ho, acc, HEAD_LD, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TP * NR; idx += blockDim.x) {
    const int c = idx / TP, r = idx % TP;
    if (p0 + r < P) out[(size_t)c * P + p0 + r] = hout[r * HEAD_LD + c] + bias[of.b_heads + c];
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
