// The sweep of a 64-point tile through a NeRF-H MLP (sm_90a), over
// panel.cuh's layer code: the PE and the trunk, then either the NeRF-W
// tail (fine_sweep: the dt layer, the transient chain and the heads) or
// the sigma head alone (sigma_sweep). fine_composite.cu runs fine_sweep;
// coarse_sigma.cu and proposal_z.cu run sigma_sweep. A row's products do
// not depend on the other rows of its tile, so two kernels that run a
// point through one sweep give it the same bits. fine_raw_t no longer
// runs fine_sweep: fine_raw.cu is a warpgroup kernel of its own (wgmma fed
// by a TMA weight ring), with the same PE, k order, bias, dpt and ReLU, so
// its trunk, dt and transient activations are fine_sweep's bit for bit;
// its heads sum in another order.
//
// Shared memory a block (fwd_layout): x0, two activation tiles, two weight
// panels, the epilogue scratch, a 16-row head matrix, the head-output
// tile, and the tile's positions, z and rays.

#pragma once

#include "panel.cuh"

// Internal linkage, as panel.cuh; the including source's kernels sit in
// the same anonymous namespace.
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

// The tile's shared buffers; tl is build_pe_sincos' view (x0, pts, rz,
// ray: rz[r] and ray[r] are row r's z and ray, -1 for a dead row).
struct SweepTile {
  bf16 *x0, *hA, *hB, *pan0, *pan1, *heads;
  float *scratch, *hout;
  Tile tl;
};

__device__ inline SweepTile carve_sweep(unsigned char* smem, const FwdLayout& L) {
  SweepTile t;
  t.x0 = reinterpret_cast<bf16*>(smem + L.x0);
  t.hA = reinterpret_cast<bf16*>(smem + L.hA);
  t.hB = reinterpret_cast<bf16*>(smem + L.hB);
  t.pan0 = reinterpret_cast<bf16*>(smem + L.pan0);
  t.pan1 = reinterpret_cast<bf16*>(smem + L.pan1);
  t.heads = reinterpret_cast<bf16*>(smem + L.heads);
  t.scratch = reinterpret_cast<float*>(smem + L.scratch);
  t.hout = reinterpret_cast<float*>(smem + L.hout);
  t.tl = Tile{};
  t.tl.x0 = t.x0;
  t.tl.pts = reinterpret_cast<float*>(smem + L.pts);
  t.tl.rz = reinterpret_cast<float*>(smem + L.rz);
  t.tl.ray = reinterpret_cast<int*>(smem + L.ray);
  t.tl.scratch = t.scratch;
  return t;
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

// The fine (or static) pack's head matrix: row c holds head row c's
// weights over its input's columns of [h | d | t3], zero elsewhere.
__device__ inline void stage_fine_heads(bf16* heads, const bf16* w_heads, int W, int stat) {
  const int half = W / 2, ldw = 2 * W + PAD;
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
}

// The sigma-only pack's head matrix: row 0 is w_sigma over h, the rest zero.
__device__ inline void stage_sigma_head(bf16* heads, const bf16* w_sigma, int W) {
  const int ldw = 2 * W + PAD;
  for (int idx = threadIdx.x; idx < 16 * W; idx += blockDim.x) {
    const int c = idx / W, k = idx % W;
    heads[c * ldw + k] = c == 0 ? w_sigma[k] : __float2bfloat16(0.f);
  }
}

// The PE of the tile's rows and the D-layer trunk with its skip layer as
// x0 . Wx + h . Wh. On return X holds h_{D-1}, Y the other activation tile.
template <int NJ>
__device__ __forceinline__ void sweep_trunk(const SweepTile& t, const Dims& dm,
                                            const float* ro, const float* rd,
                                            const bf16* wts, const float* bias,
                                            const float* freqs, bf16*& X, bf16*& Y) {
  const int W = dm.W, K0 = dm.K0, D = dm.D;
  const int ldx = K0 + PAD, ldh = W + PAD;
  build_pe_sincos(dm, t.tl, ro, rd, freqs);
  panel_layer<NJ>(t.x0, ldx, K0, wts, nullptr, 0, 0, nullptr, W, t.pan0, t.pan1, bias, nullptr, 0,
                  nullptr, t.hA, ldh, t.scratch);
  X = t.hA;
  Y = t.hB;
  for (int i = 1; i < D; ++i) {
    const bf16* wi = wts + trunk_off(dm, i);
    if (i == dm.skip)
      panel_layer<NJ>(t.x0, ldx, K0, wi, X, ldh, W, wi + (size_t)W * K0, W, t.pan0, t.pan1,
                      bias + i * W, nullptr, 0, nullptr, Y, ldh, t.scratch);
    else
      panel_layer<NJ>(X, ldh, W, wi, nullptr, 0, 0, nullptr, W, t.pan0, t.pan1, bias + i * W,
                      nullptr, 0, nullptr, Y, ldh, t.scratch);
    bf16* tmp = X;
    X = Y;
    Y = tmp;
  }
}

// A tile of a fine (stat = 0) or static (stat = 1) pack: the tile's rows
// (t.tl.ray, t.tl.rz) and the head matrix (stage_fine_heads) in place and
// visible (a __syncthreads() before the call). Runs the PE, the trunk,
// the folded xyz_final . [dir | trans_0] layer plus the per-ray row dpt,
// the transient chain at W/2 (fine pack) and the heads as tensor-core
// products; leaves row r's head output c, bias not added, at
// t.hout[r * HEAD_LD + c]. Ends with __syncthreads(). NJ: output
// fragments a warp holds (2 for W <= 128, 4 for W <= 256).
template <int NJ>
__device__ __forceinline__ void fine_sweep(const SweepTile& t, const Dims& dm, int stat,
                                           const float* ro, const float* rd,
                                           const float* dpt, const bf16* wts,
                                           const float* bias, const float* freqs) {
  const int W = dm.W, half = W / 2;
  const int Wd = stat ? half : W;
  const int ldh = W + PAD, ldw = 2 * W + PAD;
  const Offsets of = offsets(dm, stat);
  bf16 *X, *Y;
  sweep_trunk<NJ>(t, dm, ro, rd, wts, bias, freqs, X, Y);
  // X = h_{D-1}; Y = dt0 = [d | t0] (d only in the static pack)
  panel_layer<NJ>(X, ldh, W, wts + of.w_dt, nullptr, 0, 0, nullptr, Wd, t.pan0, t.pan1,
                  bias + of.b_dt, dpt, Wd, t.tl.ray, Y, ldh, t.scratch);
  const int warp = threadIdx.x / 32;
  // sigma over h, before the transient chain overwrites h
  if (warp < TP / 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    head_product(acc, X, ldh, warp * 16, W, t.heads, ldw, 0);
    wmma::store_matrix_sync(t.hout + warp * 16 * HEAD_LD, acc, HEAD_LD,
                            wmma::mem_row_major);
  }
  if (!stat) {
    // t1 over h's first half, t2 over its second, t3 over the first
    const bf16* w_tr = wts + of.w_tr;
    const float* b_tr = bias + of.b_tr;
    const size_t hh = (size_t)half * half;
    panel_layer<NJ>(Y + half, ldh, half, w_tr, nullptr, 0, 0, nullptr, half, t.pan0, t.pan1, b_tr,
                    nullptr, 0, nullptr, X, ldh, t.scratch);
    panel_layer<NJ>(X, ldh, half, w_tr + hh, nullptr, 0, 0, nullptr, half, t.pan0, t.pan1,
                    b_tr + half, nullptr, 0, nullptr, X + half, ldh, t.scratch);
    panel_layer<NJ>(X + half, ldh, half, w_tr + 2 * hh, nullptr, 0, 0, nullptr, half, t.pan0,
                    t.pan1, b_tr + 2 * half, nullptr, 0, nullptr, X, ldh, t.scratch);
  } else {
    __syncthreads();   // hout's sigma share is complete
  }
  // rgb over d (Y), transient rows over t3 (X)
  if (warp < TP / 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* ho = t.hout + warp * 16 * HEAD_LD;
    wmma::load_matrix_sync(acc, ho, HEAD_LD, wmma::mem_row_major);
    head_product(acc, Y, ldh, warp * 16, half, t.heads, ldw, W);
    if (!stat) head_product(acc, X, ldh, warp * 16, half, t.heads, ldw, W + half);
    wmma::store_matrix_sync(ho, acc, HEAD_LD, wmma::mem_row_major);
  }
  __syncthreads();
}

// A tile of a sigma-only pack (the proposal or the coarse net): the rows
// and the head matrix (stage_sigma_head) in place and visible. Runs the
// PE, the trunk and the sigma head as one tensor-core fragment a 16-row
// m-tile; leaves row r's sigma, bias not added, at t.hout[r * HEAD_LD].
// Ends with __syncthreads(). NJ: output fragments a warp holds (1 for
// W <= 64, 2 for W <= 128, 4 for W <= 256).
template <int NJ>
__device__ __forceinline__ void sigma_sweep(const SweepTile& t, const Dims& dm,
                                            const float* ro, const float* rd,
                                            const bf16* wts, const float* bias,
                                            const float* freqs) {
  const int W = dm.W, ldh = W + PAD, ldw = 2 * W + PAD;
  bf16 *X, *Y;
  sweep_trunk<NJ>(t, dm, ro, rd, wts, bias, freqs, X, Y);
  const int warp = threadIdx.x / 32;
  if (warp < TP / 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    head_product(acc, X, ldh, warp * 16, W, t.heads, ldw, 0);
    wmma::store_matrix_sync(t.hout + warp * 16 * HEAD_LD, acc, HEAD_LD,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

}  // namespace
