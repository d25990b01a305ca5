// Shared device code of the NeRF-H MLP sweep kernels (sm_90a): the
// constants, the packed-weight layout and the tile descriptor of every
// sweep kernel, and the first, generic layer code (smem_layout, carve,
// build_pe, layer, run_trunk, dot_bf16), which only proposal_z.cu still
// runs: fine_raw, fine_composite, coarse_sigma and raw_bwd's bwd_stash run
// panel.cuh's layers through sweep.cuh.
//
// Layout: point-major tiles. A block owns TP points (rows); point p of a
// sweep belongs to ray p / S. Activations live in shared memory as bf16
// row-major tiles (TP x width, rows padded by PAD elements). A dense
// layer is out = relu(in . W^T + b): WMMA 16x16x16 bf16 fragments with
// float32 accumulators, `in` from shared memory, W from global memory
// (the whole fine net is ~0.3 MB in bf16, so it stays resident in L2).
// Each warp takes 16x16 output tiles in turn; its epilogue adds the bias
// (and the per-ray conditioning row where asked), applies ReLU and
// rounds to bf16 -- the precision contract of the JAX package's kernels:
// bf16 operands, float32 accumulation, activations rounded to bf16 after
// each ReLU, positions / PE arguments / sines in float32 (sinf and cosf
// with full range reduction; arguments reach ~1e3 rad).
//
// Packed weights (bf16, each matrix (out, in) row-major, in-dims padded
// to 16; see ops/nerf_kernels.py::_layout, which builds the same order):
//   w0 (W, K0) | per trunk layer i in 1..D-1: skip ? [wx (W, K0), wh (W, W)]
//   : (W, W) | coarse: w_sigma (W) | fine: w_dt (W, W), 3 x (W/2, W/2),
//   heads (9, W) | static: w_dt (W/2, W), heads (4, W).
// Biases (float32): b_trunk (D, W) | coarse: b_sigma (1) | fine: b_dt (W),
//   b_trans (3, W/2), b_heads (9) | static: b_dt (W/2), b_heads (4).
// Heads rows: rgb 0:3 over d (columns 0:W/2), sigma 3 over h (0:W),
// fine only: t-rgb 4:7, t-sigma 7, t-beta 8 over t (columns W/2:W).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dfn {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;        // bf16 row padding: spreads banks, keeps 32 B alignment
constexpr int N_RAW = 9;      // rgb 0:3, sigma 3, t-rgb 4:7, t-sigma 7, t-beta 8
constexpr int N_STATIC = 4;   // static pack: rgb 0:3, sigma 3
constexpr int N_COMP = 8;     // rgb 0:3, acc 3, static depth 4, static rgb 5:8

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int pe_cols(int F) { return round16(6 * F + 3); }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

struct Dims {
  int D, W, skip, F, K0, TP;
};

struct SmemLayout {
  size_t x0, hA, hB, pts, rz, ray, scratch, raw, total;
};

__host__ __device__ inline SmemLayout smem_layout(int TP, int K0, int W) {
  SmemLayout L;
  size_t o = 0;
  L.x0 = o;      o = align128(o + (size_t)TP * (K0 + PAD) * sizeof(bf16));
  L.hA = o;      o = align128(o + (size_t)TP * (W + PAD) * sizeof(bf16));
  L.hB = o;      o = align128(o + (size_t)TP * (W + PAD) * sizeof(bf16));
  L.pts = o;     o = align128(o + (size_t)TP * 3 * sizeof(float));
  L.rz = o;      o = align128(o + (size_t)TP * sizeof(float));
  L.ray = o;     o = align128(o + (size_t)TP * sizeof(int));
  L.scratch = o; o = align128(o + (size_t)NWARPS * 256 * sizeof(float));
  L.raw = o;     o = align128(o + (size_t)TP * N_RAW * sizeof(float));
  L.total = o;
  return L;
}

struct Tile {
  bf16* x0;
  bf16* hA;
  bf16* hB;
  float* pts;
  float* rz;     // z of each row
  int* ray;      // ray of each row, -1 for a dead row
  float* scratch;
  float* raw;    // (TP, N_RAW) pre-activation outputs
};

__device__ inline Tile carve(unsigned char* smem, const SmemLayout& L) {
  Tile t;
  t.x0 = reinterpret_cast<bf16*>(smem + L.x0);
  t.hA = reinterpret_cast<bf16*>(smem + L.hA);
  t.hB = reinterpret_cast<bf16*>(smem + L.hB);
  t.pts = reinterpret_cast<float*>(smem + L.pts);
  t.rz = reinterpret_cast<float*>(smem + L.rz);
  t.ray = reinterpret_cast<int*>(smem + L.ray);
  t.scratch = reinterpret_cast<float*>(smem + L.scratch);
  t.raw = reinterpret_cast<float*>(smem + L.raw);
  return t;
}

// Positions o + d.z and PE features [xyz, sin f0 (3), cos f0 (3), ...],
// the reference embedder's order, zero-padded to K0 and rounded to bf16.
// Needs t.ray / t.rz filled and a __syncthreads() before the call.
__device__ inline void build_pe(const Dims& dm, const Tile& t, const float* ro,
                                const float* rd, const float* freqs) {
  for (int r = threadIdx.x; r < dm.TP; r += blockDim.x) {
    int ray = t.ray[r];
    float z = t.rz[r];
    for (int c = 0; c < 3; ++c)
      t.pts[r * 3 + c] = ray >= 0 ? ro[(size_t)ray * 3 + c] + rd[(size_t)ray * 3 + c] * z : 0.f;
  }
  __syncthreads();
  const int ld = dm.K0 + PAD;
  const int live = 6 * dm.F + 3;
  for (int idx = threadIdx.x; idx < dm.TP * dm.K0; idx += blockDim.x) {
    int r = idx / dm.K0, f = idx % dm.K0;
    float v = 0.f;
    if (f < 3) {
      v = t.pts[r * 3 + f];
    } else if (f < live) {
      int g = f - 3, k = g / 6, j = g % 6;
      float arg = freqs[k] * t.pts[r * 3 + (j % 3)];
      v = j < 3 ? sinf(arg) : cosf(arg);
    }
    t.x0[r * ld + f] = __float2bfloat16(v);
  }
  __syncthreads();
}

// out[:, :Nout] = relu(in1 . W1^T (+ in2 . W2^T) + bias (+ dpt[ray]))
// in*: shared bf16 (TP, ld*) tiles; W*: global bf16 (Nout, K*) row-major;
// out: shared bf16 (TP, ldo). Ends with __syncthreads().
__device__ inline void layer(const bf16* in1, int ld1, int K1, const bf16* W1,
                             const bf16* in2, int ld2, int K2, const bf16* W2,
                             int TP, int Nout, const float* bias,
                             const float* dpt, int ld_dpt, const int* row_ray,
                             bf16* out, int ldo, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = scratch + warp * 256;
  const int mt = TP / 16, nt = Nout / 16;
  for (int tile = warp; tile < mt * nt; tile += NWARPS) {
    const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K1; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, in1 + m0 * ld1 + k, ld1);
      wmma::load_matrix_sync(b, W1 + (size_t)n0 * K1 + k, K1);
      wmma::mma_sync(acc, a, b, acc);
    }
    if (in2 != nullptr) {
      for (int k = 0; k < K2; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, in2 + m0 * ld2 + k, ld2);
        wmma::load_matrix_sync(b, W2 + (size_t)n0 * K2 + k, K2);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = m0 + e / 16, col = n0 + e % 16;
      float v = scr[e] + bias[col];
      if (dpt != nullptr) {
        const int ray = row_ray[row];
        if (ray >= 0) v += dpt[(size_t)ray * ld_dpt + col];
      }
      out[row * ldo + col] = __float2bfloat16(fmaxf(v, 0.f));
    }
    __syncwarp();
  }
  __syncthreads();
}

// D-layer ReLU trunk with the skip layer split as x0 . Wx + h . Wh.
// Advances w / b past the trunk; returns the buffer holding the last h.
__device__ inline bf16* run_trunk(const Dims& dm, const Tile& t, const bf16*& w,
                                  const float*& b) {
  const int ldx = dm.K0 + PAD, ldh = dm.W + PAD;
  layer(t.x0, ldx, dm.K0, w, nullptr, 0, 0, nullptr, dm.TP, dm.W, b,
        nullptr, 0, nullptr, t.hA, ldh, t.scratch);
  w += (size_t)dm.W * dm.K0;
  b += dm.W;
  bf16* cur = t.hA;
  bf16* nxt = t.hB;
  for (int i = 1; i < dm.D; ++i) {
    if (i == dm.skip) {
      const bf16* wx = w;
      w += (size_t)dm.W * dm.K0;
      const bf16* wh = w;
      w += (size_t)dm.W * dm.W;
      layer(t.x0, ldx, dm.K0, wx, cur, ldh, dm.W, wh, dm.TP, dm.W, b,
            nullptr, 0, nullptr, nxt, ldh, t.scratch);
    } else {
      layer(cur, ldh, dm.W, w, nullptr, 0, 0, nullptr, dm.TP, dm.W, b,
            nullptr, 0, nullptr, nxt, ldh, t.scratch);
      w += (size_t)dm.W * dm.W;
    }
    b += dm.W;
    bf16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

__device__ inline float dot_bf16(const bf16* x, const bf16* w, int n) {
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += __bfloat162float(x[j]) * __bfloat162float(w[j]);
  return s;
}

}  // namespace dfn
