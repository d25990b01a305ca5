// raw_bwd_t: backward of fine_raw_t (fine or static pack).
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::raw_bwd_t (Pallas kernel
// _bwd_kernel_t). Given the float32 cotangent g (rows, N, S) of
// fine_raw_t's pre-activation output, it returns the gradients of every
// packed weight (bf16, the flat layout of nerf_mlp.cuh), every packed bias
// (float32) and the per-ray rows dpt (N, Wd) (float32); none for rays, z
// or the PE frequencies (the stage-1 contract of the JAX package).
//
// Per tile of TP points (TP = 32 at W <= 128, 16 at W = 256):
//   1. recompute the forward exactly as fine_raw_t does (same layer code),
//      stashing every post-ReLU activation in shared memory as bf16: x0,
//      the D trunk layers, the dt layer and (fine pack) the three
//      transient layers;
//   2. backpropagate from g through the heads (CUDA cores: at most 9
//      rows), the transient chain, the dt layer, the trunk (skip layer
//      split [x0 | h]) and layer 0. Each layer's cotangent is masked by its
//      stashed activation > 0 and rounded to bf16 in the epilogue of the
//      product that makes it; g itself is rounded to bf16 first. This is
//      the JAX kernel's precision contract: bf16 operands, float32 sums;
//   3. accumulate dW += g_pre^T . a_prev (WMMA, float32) and
//      db += sum(g_pre) into this block's own float32 slab of all weight
//      and bias grads, and write the tile's per-ray sums of the dt layer's
//      cotangent (the d_dpt partials of the rays it touches).
// The grid is persistent (one block per SM, each looping over tiles), so
// the sums are deterministic: a second kernel adds the slabs in block
// order and casts the weight grads to bf16, a third adds each ray's
// d_dpt partials in tile order. The products are all computed here.
//
// Bound on the card: operations. At W=128, D=8 (skip 4), F=10 a point
// costs ~3 forward passes of bf16 flop (recompute, input grads, weight
// grads): ~9.6e5 (fine) / ~8.4e5 (static). Bytes per point are the 36 B
// (fine) cotangent in and 12 B of rays/z; grads out are < 1 MB. Known
// costs of this simple design: each tile reads and writes its block's
// slab (~0.64 MB at W=128) once, and weights are read from L2 per 16x16
// fragment, as in the forward kernels.
//
// Shared memory at TP=32, W=128, D=8: ~124 KB (one block per SM); at
// TP=16, W=256: ~117 KB. Both need the opt-in above 48 KB.

#include "nerf_mlp.cuh"

using namespace dfn;

namespace {

struct BwdLayout {
  size_t x0, hs, dt0, ts, g0, g1, g16, pts, rz, ray, scratch, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int TP, int K0, int W, int D) {
  BwdLayout L;
  const size_t b = sizeof(bf16);
  size_t o = 0;
  L.x0 = o;      o = align128(o + (size_t)TP * (K0 + PAD) * b);
  L.hs = o;      o = align128(o + (size_t)D * TP * (W + PAD) * b);
  L.dt0 = o;     o = align128(o + (size_t)TP * (W + PAD) * b);
  L.ts = o;      o = align128(o + (size_t)3 * TP * (W / 2 + PAD) * b);
  L.g0 = o;      o = align128(o + (size_t)TP * (W + PAD) * b);
  L.g1 = o;      o = align128(o + (size_t)TP * (W + PAD) * b);
  L.g16 = o;     o = align128(o + (size_t)TP * N_RAW * sizeof(float));
  L.pts = o;     o = align128(o + (size_t)TP * 3 * sizeof(float));
  L.rz = o;      o = align128(o + (size_t)TP * sizeof(float));
  L.ray = o;     o = align128(o + (size_t)TP * sizeof(int));
  L.scratch = o; o = align128(o + (size_t)NWARPS * 256 * sizeof(float));
  L.total = o;
  return L;
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

// dW (Nout, K) += g^T . a over the TP rows of the tile.
// g: shared bf16 (TP, ldg) over the Nout outputs; a: shared bf16 (TP, lda)
// over the K inputs; dW: this block's float32 slab, row-major.
__device__ inline void wgrad(const bf16* g, int ldg, const bf16* a, int lda, int TP,
                             int Nout, int K, float* dW) {
  const int warp = threadIdx.x / 32;
  const int nt = K / 16;
  for (int tile = warp; tile < (Nout / 16) * nt; tile += NWARPS) {
    const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, dW + (size_t)m0 * K + n0, K, wmma::mem_row_major);
    for (int k = 0; k < TP; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, g + (size_t)k * ldg + m0, ldg);
      wmma::load_matrix_sync(fb, a + (size_t)k * lda + n0, lda);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dW + (size_t)m0 * K + n0, acc, K, wmma::mem_row_major);
  }
}

// gout[:, :K] = bf16((act > 0) * (g . W + ex_g[row] * ex_w[col])): the
// cotangent of a layer's input, masked by that input's stashed activation.
// g: shared bf16 (TP, ldg) over Nout outputs; W: global bf16 (Nout, K)
// row-major; act: shared bf16 (TP, lda); ex_g / ex_w: an optional rank-1
// term (the sigma head's share of the trunk's last cotangent).
// Ends with __syncthreads().
__device__ inline void dgrad(const bf16* g, int ldg, int Nout, const bf16* W, int K,
                             const bf16* act, int lda, int TP, bf16* gout, int ldo,
                             float* scratch, const float* ex_g, int ex_ld,
                             const bf16* ex_w) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = scratch + warp * 256;
  const int nt = K / 16;
  for (int tile = warp; tile < (TP / 16) * nt; tile += NWARPS) {
    const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < Nout; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, g + (size_t)m0 * ldg + k, ldg);
      wmma::load_matrix_sync(fb, W + (size_t)k * K + n0, K);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = m0 + e / 16, col = n0 + e % 16;
      float v = scr[e];
      if (ex_g != nullptr) v += ex_g[row * ex_ld] * bf(ex_w[col]);
      gout[row * ldo + col] = __float2bfloat16(bf(act[row * lda + col]) > 0.f ? v : 0.f);
    }
    __syncwarp();
  }
  __syncthreads();
}

// db[:n] += column sums of g (TP, ldg) over the tile's rows.
__device__ inline void colsum(const bf16* g, int ldg, int TP, int n, float* db) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < TP; ++r) s += bf(g[r * ldg + j]);
    db[j] += s;
  }
}

__global__ void __launch_bounds__(NTHREADS)
raw_bwd_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ z, const float* __restrict__ dpt,
               const float* __restrict__ g, int N, int S,
               const bf16* __restrict__ wts, const float* __restrict__ bias,
               const float* __restrict__ freqs, Dims dm, int stat,
               float* __restrict__ slabs, int slab_stride,
               float* __restrict__ dpt_part, int kmax) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(dm.TP, dm.K0, dm.W, dm.D);
  const int TP = dm.TP, W = dm.W, half = W / 2, K0 = dm.K0;
  const int Wd = stat ? half : W, NR = stat ? N_STATIC : N_RAW;
  const int ldx = K0 + PAD, ldh = W + PAD, ldt = half + PAD;
  bf16* x0 = reinterpret_cast<bf16*>(smem + L.x0);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* dt0 = reinterpret_cast<bf16*>(smem + L.dt0);
  bf16* ts = reinterpret_cast<bf16*>(smem + L.ts);
  bf16* G0 = reinterpret_cast<bf16*>(smem + L.g0);
  bf16* G1 = reinterpret_cast<bf16*>(smem + L.g1);
  float* g16 = reinterpret_cast<float*>(smem + L.g16);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  Tile tl{};
  tl.x0 = x0;
  tl.pts = reinterpret_cast<float*>(smem + L.pts);
  tl.rz = reinterpret_cast<float*>(smem + L.rz);
  tl.ray = reinterpret_cast<int*>(smem + L.ray);
  tl.scratch = scratch;
  auto H = [&](int i) { return hs + (size_t)i * TP * ldh; };
  // transient activations: T(0) is the t half of dt0, T(1..3) the chain
  auto T = [&](int i) { return i == 0 ? dt0 + half : ts + (size_t)(i - 1) * TP * ldt; };
  auto Tld = [&](int i) { return i == 0 ? ldh : ldt; };

  const Offsets of = offsets(dm, stat);
  const bf16* w_dt = wts + of.w_dt;
  const bf16* w_heads = wts + of.w_heads;
  float* slab = slabs + (size_t)blockIdx.x * slab_stride;
  float* dW = slab;                 // weight grads, the packed order
  float* dB = slab + of.nw;         // bias grads, the packed order
  for (int i = threadIdx.x; i < slab_stride; i += blockDim.x) slab[i] = 0.f;
  __syncthreads();

  const long long P = (long long)N * S;
  const long long n_tiles = (P + TP - 1) / TP;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * TP;
    for (int r = threadIdx.x; r < TP; r += blockDim.x) {
      const long long p = p0 + r;
      tl.ray[r] = p < P ? (int)(p / S) : -1;
      tl.rz[r] = p < P ? z[p] : 0.f;
    }
    for (int idx = threadIdx.x; idx < TP * NR; idx += blockDim.x) {
      const int r = idx / NR, c = idx % NR;
      const long long p = p0 + r;
      g16[idx] = p < P ? bf(__float2bfloat16(g[(size_t)c * P + p])) : 0.f;
    }
    __syncthreads();

    // ---- 1. forward recompute (fine_raw_t's arithmetic), stashing
    build_pe(dm, tl, ro, rd, freqs);
    layer(x0, ldx, K0, wts, nullptr, 0, 0, nullptr, TP, W, bias, nullptr, 0,
          nullptr, H(0), ldh, scratch);
    for (int i = 1; i < dm.D; ++i) {
      const bf16* wi = wts + trunk_off(dm, i);
      if (i == dm.skip)
        layer(x0, ldx, K0, wi, H(i - 1), ldh, W, wi + (size_t)W * K0, TP, W,
              bias + i * W, nullptr, 0, nullptr, H(i), ldh, scratch);
      else
        layer(H(i - 1), ldh, W, wi, nullptr, 0, 0, nullptr, TP, W, bias + i * W,
              nullptr, 0, nullptr, H(i), ldh, scratch);
    }
    bf16* h = H(dm.D - 1);
    layer(h, ldh, W, w_dt, nullptr, 0, 0, nullptr, TP, Wd, bias + of.b_dt, dpt, Wd,
          tl.ray, dt0, ldh, scratch);
    if (!stat)
      for (int i = 0; i < 3; ++i)
        layer(T(i), Tld(i), half, wts + of.w_tr + (size_t)i * half * half, nullptr, 0,
              0, nullptr, TP, half, bias + of.b_tr + i * half, nullptr, 0, nullptr,
              T(i + 1), ldt, scratch);

    // ---- 2./3. heads (CUDA cores): weight and bias grads, and the
    // masked bf16 cotangents of d (G0[:, :half]) and of t3 (G1[:, :half])
    for (int idx = threadIdx.x; idx < NR * W; idx += blockDim.x) {
      const int c = idx / W, j = idx % W;
      const bf16* x;
      int ld;
      if (c == 3) {
        x = h + j;
        ld = ldh;
      } else if (c < 3) {
        if (j >= half) continue;
        x = dt0 + j;
        ld = ldh;
      } else {
        if (j < half) continue;
        x = T(3) + (j - half);
        ld = ldt;
      }
      float s = 0.f;
      for (int r = 0; r < TP; ++r) s += g16[r * NR + c] * bf(x[r * ld]);
      dW[of.w_heads + idx] += s;
    }
    for (int c = threadIdx.x; c < NR; c += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < TP; ++r) s += g16[r * NR + c];
      dB[of.b_heads + c] += s;
    }
    for (int idx = threadIdx.x; idx < TP * half; idx += blockDim.x) {
      const int r = idx / half, j = idx % half;
      float v = 0.f;
      for (int c = 0; c < 3; ++c) v += g16[r * NR + c] * bf(w_heads[(size_t)c * W + j]);
      G0[r * ldh + j] = __float2bfloat16(bf(dt0[r * ldh + j]) > 0.f ? v : 0.f);
      if (!stat) {
        float u = 0.f;
        for (int c = 4; c < N_RAW; ++c)
          u += g16[r * NR + c] * bf(w_heads[(size_t)c * W + half + j]);
        G1[r * ldh + j] = __float2bfloat16(bf(T(3)[r * ldt + j]) > 0.f ? u : 0.f);
      }
    }
    __syncthreads();

    // transient chain, from t3 down to t0 (the t half of G0)
    if (!stat) {
      bf16* gc = G1;
      for (int i = 2; i >= 0; --i) {
        const bf16* wi = wts + of.w_tr + (size_t)i * half * half;
        wgrad(gc, ldh, T(i), Tld(i), TP, half, half, dW + of.w_tr + (size_t)i * half * half);
        colsum(gc, ldh, TP, half, dB + of.b_tr + i * half);
        bf16* gn = i == 0 ? G0 + half : (gc == G1 ? G1 + half : G1);
        dgrad(gc, ldh, half, wi, half, T(i), Tld(i), TP, gn, ldh, scratch, nullptr, 0,
              nullptr);
        gc = gn;
      }
    }

    // the dt layer: weight and bias grads, per-ray d_dpt partials, and the
    // trunk's last cotangent (plus the sigma head's share) into G1
    wgrad(G0, ldh, h, ldh, TP, Wd, W, dW + of.w_dt);
    colsum(G0, ldh, TP, Wd, dB + of.b_dt);
    const long long r0 = p0 / S;
    for (int idx = threadIdx.x; idx < kmax * Wd; idx += blockDim.x) {
      const int k = idx / Wd, j = idx % Wd;
      float s = 0.f;
      for (int r = 0; r < TP; ++r)
        if (tl.ray[r] == r0 + k) s += bf(G0[r * ldh + j]);
      dpt_part[((size_t)tile * kmax + k) * Wd + j] = s;
    }
    dgrad(G0, ldh, Wd, w_dt, W, h, ldh, TP, G1, ldh, scratch, g16 + 3, NR,
          w_heads + (size_t)3 * W);

    // trunk, from layer D-1 down to layer 0
    bf16* gc = G1;
    bf16* ga = G0;
    for (int i = dm.D - 1; i >= 0; --i) {
      colsum(gc, ldh, TP, W, dB + i * W);
      if (i == 0) {
        wgrad(gc, ldh, x0, ldx, TP, W, K0, dW);
        break;
      }
      const size_t off = trunk_off(dm, i);
      const bf16* wh = wts + off;
      if (i == dm.skip) {
        wgrad(gc, ldh, x0, ldx, TP, W, K0, dW + off);
        wh += (size_t)W * K0;
        wgrad(gc, ldh, H(i - 1), ldh, TP, W, W, dW + off + (size_t)W * K0);
      } else {
        wgrad(gc, ldh, H(i - 1), ldh, TP, W, W, dW + off);
      }
      dgrad(gc, ldh, W, wh, W, H(i - 1), ldh, TP, ga, ldh, scratch, nullptr, 0, nullptr);
      bf16* tmp = gc;
      gc = ga;
      ga = tmp;
    }
    __syncthreads();
  }
}

// Sums the blocks' slabs in block order: weight grads -> bf16, bias grads
// -> float32.
__global__ void slab_reduce(const float* __restrict__ slabs, int n_blocks,
                            int slab_stride, int nw, int nb, bf16* __restrict__ dw,
                            float* __restrict__ db) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nw + nb;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += slabs[(size_t)b * slab_stride + e];
    if (e < nw)
      dw[e] = __float2bfloat16(s);
    else
      db[e - nw] = s;
  }
}

// d_dpt[ray] = sum of the partials of the tiles the ray spans, in tile order.
__global__ void dpt_reduce(const float* __restrict__ part, int N, int S, int TP,
                           int kmax, int Wd, float* __restrict__ d_dpt) {
  const long long n = (long long)N * Wd;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long ray = idx / Wd;
    const int j = (int)(idx % Wd);
    const long long t0 = ray * S / TP, t1 = (ray * S + S - 1) / TP;
    float s = 0.f;
    for (long long t = t0; t <= t1; ++t) {
      const long long k = ray - t * TP / S;
      s += part[((size_t)t * kmax + k) * Wd + j];
    }
    d_dpt[idx] = s;
  }
}

}  // namespace

extern "C" int dfn_raw_bwd(const float* ro, const float* rd, const float* z,
                           const float* dpt, int N, int S, const void* wts,
                           const float* bias, const float* freqs, int D, int W,
                           int skip, int F, int stat, const float* g, int TP,
                           float* slabs, int n_blocks, int slab_stride,
                           float* dpt_part, int kmax, void* dw, float* db,
                           float* d_dpt, void* stream) {
  if (TP % 16 != 0 || W % 32 != 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  Dims dm{D, W, skip, F, pe_cols(F), TP};
  const Offsets of = offsets(dm, stat);
  if ((long long)of.nw + of.nb > slab_stride) return (int)cudaErrorInvalidValue;
  const BwdLayout L = bwd_layout(TP, dm.K0, W, D);
  cudaError_t e = cudaFuncSetAttribute(raw_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  raw_bwd_kernel<<<n_blocks, NTHREADS, L.total, st>>>(
      ro, rd, z, dpt, g, N, S, (const bf16*)wts, bias, freqs, dm, stat, slabs,
      slab_stride, dpt_part, kmax);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = (int)of.nw + of.nb;
  slab_reduce<<<(n + 255) / 256, 256, 0, st>>>(slabs, n_blocks, slab_stride,
                                                (int)of.nw, of.nb, (bf16*)dw, db);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nd = (long long)N * (stat ? W / 2 : W);
  const int grid = (int)((nd + 255) / 256 < 65535 ? (nd + 255) / 256 : 65535);
  dpt_reduce<<<grid, 256, 0, st>>>(dpt_part, N, S, TP, kmax, stat ? W / 2 : W, d_dpt);
  return (int)cudaGetLastError();
}
