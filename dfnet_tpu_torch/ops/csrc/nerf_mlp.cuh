// Shared device definitions of the NeRF-H MLP sweep kernels (sm_90a): the
// constants, the packed-weight layout, the sweep dimensions (Dims) and the
// tile view of the PE (Tile). The layer code is panel.cuh's and the
// forward sweep sweep.cuh's; every kernel of ops/csrc but mlp_stack.cu runs
// them.
//
// Layout: point-major tiles. Point p of a sweep belongs to ray p / S.
// Activations live in shared memory as bf16 row-major tiles (rows padded
// by PAD elements). The precision contract of the JAX package's kernels:
// bf16 operands, float32 accumulation, activations rounded to bf16 after
// each ReLU, positions / PE arguments / sines in float32 (full range
// reduction; arguments reach ~1e3 rad).
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

// A tile's PE inputs and output (panel.cuh::build_pe_sincos): x0 (TP rows
// of K0 + PAD), the rows' positions, z and rays, and the epilogue scratch.
struct Tile {
  bf16* x0;
  float* pts;
  float* rz;     // z of each row
  int* ray;      // ray of each row, -1 for a dead row
  float* scratch;
};

}  // namespace dfn
