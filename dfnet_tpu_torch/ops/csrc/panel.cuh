// Weight panels (sm_90a): one dense layer's product over a tile of points,
// the layer's weights streamed through shared memory, and the tile's PE.
// The WMMA sweep's layer code (sweep.cuh: fine_composite.cu, coarse_sigma.cu
// and proposal_z.cu). fine_raw.cu (fine_raw_t) and raw_bwd.cu's bwd_stash
// run the same forward on warpgroup MMA with the same PE, k order, bias,
// dpt and ReLU, and take relu_nan, the packed offsets and the PE's
// arithmetic from here; tests/test_torch_port_gpu.py holds bwd_stash's trunk
// activations to fine_raw_t's bit for bit, so the backward's ReLU masks are
// the forward's.
//
// The whole fine net (~0.32 MB bf16 at W=128, D=8) does not fit in a
// block's shared memory, so each layer's weights pass through two panels
// 64 input columns wide (cp.async, double-buffered: the copy of panel p+1
// overlaps the products of panel p). Panel rows are padded by PAD, so a
// WMMA fragment read from a panel is conflict-free. A tile's activations
// stay in shared memory between layers; every weight is read from L2 once
// a tile.

#pragma once

#include "nerf_mlp.cuh"

// Internal linkage: the including source's kernels sit in the same
// anonymous namespace.
namespace {

using namespace dfn;

constexpr int KP = 64;       // weight panel width (reduction slice)

// The forward epilogue's ReLU: max.NaN.f32 returns NaN for a NaN x, as
// jnp.maximum(x, 0) and torch.relu do, and otherwise what max.f32 (the
// instruction fmaxf compiles to) returns, so every other x keeps its bits.
__device__ inline float relu_nan(float x) {
  float y;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(y) : "f"(x));
  return y;
}

// Offset of trunk layer i's first matrix in the packed weights (i >= 1;
// i == D gives the end of the trunk).
__host__ __device__ inline size_t trunk_off(const Dims& dm, int i) {
  size_t off = (size_t)dm.W * dm.K0;
  for (int j = 1; j < i; ++j)
    off += (size_t)dm.W * (j == dm.skip ? dm.K0 + dm.W : dm.W);
  return off;
}

struct Offsets {
  size_t w_dt, w_tr, w_heads, nw;   // weights (bf16 elements)
  int b_dt, b_tr, b_heads, nb;      // biases (floats)
};

__host__ __device__ inline Offsets offsets(const Dims& dm, int stat) {
  const int W = dm.W, half = W / 2, Wd = stat ? half : W;
  Offsets o;
  o.w_dt = trunk_off(dm, dm.D);
  o.w_tr = o.w_dt + (size_t)Wd * W;
  o.w_heads = o.w_tr + (stat ? 0 : (size_t)3 * half * half);
  o.nw = o.w_heads + (size_t)(stat ? N_STATIC : N_RAW) * W;
  o.b_dt = dm.D * W;
  o.b_tr = o.b_dt + Wd;
  o.b_heads = o.b_tr + (stat ? 0 : 3 * half);
  o.nb = o.b_heads + (stat ? N_STATIC : N_RAW);
  return o;
}

__device__ inline float bf(bf16 x) { return __bfloat162float(x); }

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// bf16 elements of one panel buffer: W rows of KP, or at least KP rows of W
// (the sweeps' shared-memory layout, which ops/nerf_kernels.py mirrors)
__host__ __device__ inline size_t panel_elems(int W) {
  const size_t fwd = (size_t)W * (KP + PAD), bwd = (size_t)KP * (W + PAD);
  return fwd > bwd ? fwd : bwd;
}

// 8 floats from a 16-byte aligned address
__device__ inline void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The tile's x0 = [xyz | sin, cos of each frequency times xyz | zero
// pad] (the reference embedder's order), with one sincosf a (point,
// frequency, axis): full range reduction, float32 arguments (they reach
// ~1e3 rad). Needs t.ray / t.rz filled and a __syncthreads() before the
// call.
__device__ inline void build_pe_sincos(const Dims& dm, const Tile& t, const float* ro,
                                       const float* rd, const float* freqs) {
  for (int r = threadIdx.x; r < dm.TP; r += blockDim.x) {
    int ray = t.ray[r];
    float z = t.rz[r];
    for (int c = 0; c < 3; ++c)
      t.pts[r * 3 + c] = ray >= 0 ? ro[(size_t)ray * 3 + c] + rd[(size_t)ray * 3 + c] * z : 0.f;
  }
  __syncthreads();
  const int ld = dm.K0 + PAD, live = 6 * dm.F + 3;
  for (int idx = threadIdx.x; idx < dm.TP * dm.F * 3; idx += blockDim.x) {
    const int r = idx / (dm.F * 3), k = (idx / 3) % dm.F, j = idx % 3;
    float s, c;
    sincosf(freqs[k] * t.pts[r * 3 + j], &s, &c);
    t.x0[r * ld + 3 + 6 * k + j] = __float2bfloat16(s);
    t.x0[r * ld + 6 + 6 * k + j] = __float2bfloat16(c);
  }
  for (int idx = threadIdx.x; idx < dm.TP * (3 + dm.K0 - live); idx += blockDim.x) {
    const int r = idx / (3 + dm.K0 - live), f = idx % (3 + dm.K0 - live);
    t.x0[r * ld + (f < 3 ? f : live + f - 3)] =
        __float2bfloat16(f < 3 ? t.pts[r * 3 + f] : 0.f);
  }
  __syncthreads();
}

// A layer's product over a tile, its weights streamed through two panels:
// out = relu(in1 . W1^T (+ in2 . W2^T) + bias (+ dpt[ray])), W_s (Nout, K_s)
// row-major; a panel is W_s[:, k0:k0+64] (Nout rows). in*: shared bf16 (64
// rows, ld*); out: shared bf16 (64 rows, ldo). 8 warps: 2 along the points,
// two 16-row fragments each; 4 along the outputs, NJ 16-column fragments
// each (columns 16 (wn + 4 j)), so Nout <= 64 NJ. Ends with __syncthreads().
template <int NJ>
__device__ void panel_layer(const bf16* in1, int ld1, int K1, const bf16* W1,
                            const bf16* in2, int ld2, int K2, const bf16* W2,
                            int Nout, bf16* pan0, bf16* pan1, const float* bias,
                            const float* dpt, int ld_dpt, const int* row_ray, bf16* out,
                            int ldo, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 1, wn = warp >> 1;
  const int nt = Nout / 16;
  const int np1 = (K1 + KP - 1) / KP;
  const int np = np1 + (in2 != nullptr ? (K2 + KP - 1) / KP : 0);
  const int ldp = KP + PAD;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NJ];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[mi][j], 0.f);

  auto fetch = [&](int p, bf16* dst) {
    const bool second = p >= np1;
    const bf16* Wm = second ? W2 : W1;
    const int K = second ? K2 : K1;
    const int k0 = (second ? p - np1 : p) * KP;
    const int kp = min(KP, K - k0);
    const int cpr = kp / 8;
    for (int i = threadIdx.x; i < Nout * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i % cpr) * 8;
      cp_async16(dst + (size_t)r * ldp + c, Wm + (size_t)r * K + k0 + c);
    }
    cp_commit();
  };

  fetch(0, pan0);
  for (int p = 0; p < np; ++p) {
    bf16* cur = (p & 1) ? pan1 : pan0;
    if (p + 1 < np) {
      fetch(p + 1, (p & 1) ? pan0 : pan1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bool second = p >= np1;
    const bf16* in = second ? in2 : in1;
    const int ld = second ? ld2 : ld1;
    const int K = second ? K2 : K1;
    const int k0 = (second ? p - np1 : p) * KP;
    const int kp = min(KP, K - k0);
    for (int kk = 0; kk < kp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wmma::load_matrix_sync(fa[mi], in + (size_t)(wm * 32 + mi * 16) * ld + k0 + kk, ld);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ni = wn + 4 * j;
        if (ni < nt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, cur + (size_t)(ni * 16) * ldp + kk, ldp);
          wmma::mma_sync(acc[0][j], fa[0], fb, acc[0][j]);
          wmma::mma_sync(acc[1][j], fa[1], fb, acc[1][j]);
        }
      }
    }
    __syncthreads();   // the panel is free for the copy two panels on
  }

  // epilogue: 8 columns a lane, 16-byte reads and writes
  float* scr = scratch + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int ni = wn + 4 * j;
      if (ni >= nt) continue;
      wmma::store_matrix_sync(scr, acc[mi][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * 32 + mi * 16 + r, col = ni * 16 + c8;
      float v[8];
      const float4 s0 = *reinterpret_cast<const float4*>(scr + r * 16 + c8);
      const float4 s1 = *reinterpret_cast<const float4*>(scr + r * 16 + c8 + 4);
      v[0] = s0.x; v[1] = s0.y; v[2] = s0.z; v[3] = s0.w;
      v[4] = s1.x; v[5] = s1.y; v[6] = s1.z; v[7] = s1.w;
      __align__(16) bf16 o[8];
      const int ray = dpt != nullptr ? row_ray[row] : -1;
      float bv[8], dv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      load8(bias + col, bv);
      if (ray >= 0) load8(dpt + (size_t)ray * ld_dpt + col, dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float x = v[e] + bv[e];
        if (ray >= 0) x += dv[e];
        o[e] = __float2bfloat16(relu_nan(x));
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * ldo + col) =
          *reinterpret_cast<const uint4*>(o);
      __syncwarp();
    }
  }
  __syncthreads();
}

}  // namespace
