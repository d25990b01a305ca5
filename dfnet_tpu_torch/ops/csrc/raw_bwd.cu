// raw_bwd_t: backward of fine_raw_t (fine or static pack), in three launches.
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::raw_bwd_t (Pallas kernel
// _bwd_kernel_t). Given the float32 cotangent g (rows, N, S) of
// fine_raw_t's pre-activation output, it returns the gradients of every
// packed weight (bf16, the flat layout of nerf_mlp.cuh), every packed bias
// (float32) and the per-ray rows dpt (N, Wd) (float32); none for rays, z
// or the PE frequencies (the stage-1 contract of the JAX package).
//
// Precision contract (the JAX kernel's): g is rounded to bf16; each later
// cotangent is masked by its stashed activation > 0 and rounded to bf16
// before it becomes a matmul operand; every product sums in float32;
// weight grads leave as bf16. No atomics: two calls give the same bits.
//
// What bounds it on the H100: operations (~3 forward passes of bf16 flop
// a point), but only if the weight-grad sums stay in registers over many
// points and the weights reach the tensor cores from shared memory. The
// TPU kernel kept a 1024-point tile's activations in VMEM and summed weight
// grads across its sequential grid; a block here has 227 KB and runs in
// parallel with the others. So the work is split:
//
//   1. bwd_stash (per 64-point tile, one tile a block): recomputes the
//      forward exactly as fine_raw_t does (the same panel.cuh PE and layer
//      code, so the same ReLU masks), runs the cotangent chain (heads,
//      transient chain, dt layer plus the sigma head's rank-1 share, trunk)
//      and writes each weight matrix's bf16 input activation A_l and masked
//      bf16 output cotangent G_l, and the bf16 g, to a point-major stash in
//      device memory (16-byte stores). A block holds only x0, two activation
//      tiles and two weight panels: each layer's weights stream through the
//      panels in 64-wide slices (panel.cuh::panel_layer, which fine_raw.cu
//      shares: cp.async, double-buffered, padded rows, so a WMMA fragment
//      read is conflict-free), ~94 KB at W=128 (two blocks,
//      16 warps an SM) and ~164 KB at W=256 (one block). Masks for the input
//      grads read A_{l-1} back from the stash, L2-hot.
//   2. bwd_wgrad: a grouped split-K GEMM, dW_l = G_l^T A_l and db_l = sum G_l,
//      over a table of problems built by ops/nerf_kernels.py::bwd_problems.
//      One block per (chunk of points, problem, 128x128 output tile, so a
//      W=128 layer reads its G and A once), chunks slowest so the blocks of
//      one chunk share its stash rows in L2. The float32 sums stay in
//      registers over the whole chunk (thousands of points); operand tiles
//      stream through a 3-stage cp.async ring; the bias sums are an extra
//      WMMA against a ones fragment. One float32 partial per chunk, in the
//      packed layout. The stash is read about once: ~0.33 ms of HBM time
//      at the shipped fine shape, the floor of this launch.
//   3. bwd_reduce: sums the chunk partials in chunk order (bf16 d_w, float32
//      d_b) and d_dpt[ray] = sum over the ray's samples of G_dt, in order.
//
// Stash: one bf16 [Pp, width] region per activation and cotangent (Pp = P
// rounded up to 64; a dead row's G is zero), in the order of
// ops/nerf_kernels.py::bwd_regions; the wrapper passes the region offsets.

#include "panel.cuh"

using namespace dfn;

namespace {

constexpr int BTP = 64;      // points per stash tile
constexpr int G_RAW = 16;    // columns of the bf16 g region
constexpr int MAX_REGIONS = 2 * 16 + 10;

struct Regions {
  long long off[MAX_REGIONS];
  int width[MAX_REGIONS];
};

// region indices (ops/nerf_kernels.py::bwd_regions)
__host__ __device__ inline int R_X0() { return 0; }
__host__ __device__ inline int R_H(int i) { return 1 + i; }
__host__ __device__ inline int R_DT0(int D) { return 1 + D; }
__host__ __device__ inline int R_T(int D, int i) { return 1 + D + i; }        // i = 1..3
__host__ __device__ inline int R_GH(int D, int i) { return 5 + D + i; }
__host__ __device__ inline int R_GDT(int D) { return 5 + 2 * D; }
__host__ __device__ inline int R_GT(int D, int i) { return 5 + 2 * D + i; }   // i = 1..3
__host__ __device__ inline int R_GRAW(int D) { return 9 + 2 * D; }

// ---------------------------------------------------------------------------
// 1. bwd_stash
// ---------------------------------------------------------------------------

struct StashLayout {
  size_t x0, hA, hB, pan0, pan1, scratch, g16, pts, rz, ray, total;
};

__host__ __device__ inline StashLayout stash_layout(int K0, int W) {
  StashLayout L;
  const size_t b = sizeof(bf16);
  size_t o = 0;
  L.x0 = o;      o = align128(o + (size_t)BTP * (K0 + PAD) * b);
  L.hA = o;      o = align128(o + (size_t)BTP * (W + PAD) * b);
  L.hB = o;      o = align128(o + (size_t)BTP * (W + PAD) * b);
  L.pan0 = o;    o = align128(o + panel_elems(W) * b);
  L.pan1 = o;    o = align128(o + panel_elems(W) * b);
  L.scratch = o; o = align128(o + (size_t)NWARPS * 256 * sizeof(float));
  L.g16 = o;     o = align128(o + (size_t)BTP * G_RAW * sizeof(float));
  L.pts = o;     o = align128(o + (size_t)BTP * 3 * sizeof(float));
  L.rz = o;      o = align128(o + (size_t)BTP * sizeof(float));
  L.ray = o;     o = align128(o + (size_t)BTP * sizeof(int));
  L.total = o;
  return L;
}

// NJ: n-fragments a warp holds, 2 for W <= 128 (two blocks an SM), 4 for
// W <= 256 (one block).
template <int NJ>
__global__ void __launch_bounds__(NTHREADS, NJ <= 2 ? 2 : 1)
bwd_stash_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ z, const float* __restrict__ dpt,
                 const float* __restrict__ g, int N, int S,
                 const bf16* __restrict__ wts, const float* __restrict__ bias,
                 const float* __restrict__ freqs, Dims dm, int stat,
                 bf16* __restrict__ stash, Regions rg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StashLayout L = stash_layout(dm.K0, dm.W);
  const int W = dm.W, half = W / 2, K0 = dm.K0, D = dm.D;
  const int Wd = stat ? half : W, NR = stat ? N_STATIC : N_RAW;
  const int ldx = K0 + PAD, ldh = W + PAD;
  bf16* x0 = reinterpret_cast<bf16*>(smem + L.x0);
  bf16* hA = reinterpret_cast<bf16*>(smem + L.hA);
  bf16* hB = reinterpret_cast<bf16*>(smem + L.hB);
  bf16* pan0 = reinterpret_cast<bf16*>(smem + L.pan0);
  bf16* pan1 = reinterpret_cast<bf16*>(smem + L.pan1);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* g16 = reinterpret_cast<float*>(smem + L.g16);
  Tile tl{};
  tl.x0 = x0;
  tl.pts = reinterpret_cast<float*>(smem + L.pts);
  tl.rz = reinterpret_cast<float*>(smem + L.rz);
  tl.ray = reinterpret_cast<int*>(smem + L.ray);
  tl.scratch = scratch;

  const long long P = (long long)N * S;
  const long long p0 = (long long)blockIdx.x * BTP;
  // region r's rows of this tile
  auto at = [&](int r) { return StashOut{stash + rg.off[r] + p0 * rg.width[r], rg.width[r]}; };
  auto col = [](StashOut s, int c) { return StashOut{s.base + c, s.ld}; };

  for (int r = threadIdx.x; r < BTP; r += blockDim.x) {
    const long long p = p0 + r;
    tl.ray[r] = p < P ? (int)(p / S) : -1;
    tl.rz[r] = p < P ? z[p] : 0.f;
  }
  // g rounded to bf16: shared float copy and the stash's g region
  const StashOut sg = at(R_GRAW(D));
  for (int idx = threadIdx.x; idx < BTP * G_RAW; idx += blockDim.x) {
    const int r = idx / G_RAW, c = idx % G_RAW;
    const long long p = p0 + r;
    const bf16 v = __float2bfloat16(p < P && c < NR ? g[(size_t)c * P + p] : 0.f);
    g16[idx] = bf(v);
    sg.base[(size_t)r * G_RAW + c] = v;
  }
  __syncthreads();

  // ---- forward recompute (fine_raw_t's arithmetic), writing A_l
  build_pe_sincos(dm, tl, ro, rd, freqs);
  {
    const StashOut sx = at(R_X0());
    const int cpr = K0 / 8;
    for (int i = threadIdx.x; i < BTP * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i % cpr) * 8;
      *reinterpret_cast<uint4*>(sx.base + (size_t)r * K0 + c) =
          *reinterpret_cast<const uint4*>(x0 + (size_t)r * ldx + c);
    }
  }
  panel_layer<false, NJ>(x0, ldx, K0, wts, nullptr, 0, 0, nullptr, W, pan0, pan1, bias,
                     nullptr, 0, nullptr, nullptr, 0, nullptr, 0, nullptr, hA, ldh,
                     at(R_H(0)), scratch);
  bf16* cur = hA;
  bf16* nxt = hB;
  for (int i = 1; i < D; ++i) {
    const bf16* wi = wts + trunk_off(dm, i);
    if (i == dm.skip)
      panel_layer<false, NJ>(x0, ldx, K0, wi, cur, ldh, W, wi + (size_t)W * K0, W, pan0,
                         pan1, bias + i * W, nullptr, 0, nullptr, nullptr, 0, nullptr, 0,
                         nullptr, nxt, ldh, at(R_H(i)), scratch);
    else
      panel_layer<false, NJ>(cur, ldh, W, wi, nullptr, 0, 0, nullptr, W, pan0, pan1,
                         bias + i * W, nullptr, 0, nullptr, nullptr, 0, nullptr, 0,
                         nullptr, nxt, ldh, at(R_H(i)), scratch);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  const Offsets of = offsets(dm, stat);
  const bf16* w_heads = wts + of.w_heads;
  bf16* X = cur;   // h_{D-1}; then t1 | t2, t3 over t1; then cotangents
  bf16* Y = nxt;   // dt0 = [d | t0]; then G_dt in place
  panel_layer<false, NJ>(X, ldh, W, wts + of.w_dt, nullptr, 0, 0, nullptr, Wd, pan0, pan1,
                     bias + of.b_dt, dpt, Wd, tl.ray, nullptr, 0, nullptr, 0, nullptr, Y,
                     ldh, at(R_DT0(D)), scratch);
  if (!stat) {
    const bf16* w_tr = wts + of.w_tr;
    const size_t hh = (size_t)half * half;
    panel_layer<false, NJ>(Y + half, ldh, half, w_tr, nullptr, 0, 0, nullptr, half, pan0,
                       pan1, bias + of.b_tr, nullptr, 0, nullptr, nullptr, 0, nullptr, 0,
                       nullptr, X, ldh, at(R_T(D, 1)), scratch);
    panel_layer<false, NJ>(X, ldh, half, w_tr + hh, nullptr, 0, 0, nullptr, half, pan0, pan1,
                       bias + of.b_tr + half, nullptr, 0, nullptr, nullptr, 0, nullptr,
                       0, nullptr, X + half, ldh, at(R_T(D, 2)), scratch);
    panel_layer<false, NJ>(X + half, ldh, half, w_tr + 2 * hh, nullptr, 0, 0, nullptr, half,
                       pan0, pan1, bias + of.b_tr + 2 * half, nullptr, 0, nullptr,
                       nullptr, 0, nullptr, 0, nullptr, X, ldh, at(R_T(D, 3)), scratch);
  }

  // ---- heads (CUDA cores: at most 9 rows): the masked bf16 cotangents of
  // d (in place over d in Y) and of t3 (in place over t3 in X)
  const StashOut sdt = at(R_GDT(D));
  const StashOut st3 = stat ? StashOut{nullptr, 0} : at(R_GT(D, 3));
  for (int idx = threadIdx.x; idx < BTP * half; idx += blockDim.x) {
    const int r = idx / half, j = idx % half;
    float v = 0.f;
    for (int c = 0; c < 3; ++c) v += g16[r * G_RAW + c] * bf(w_heads[(size_t)c * W + j]);
    const bf16 gd = __float2bfloat16(bf(Y[r * ldh + j]) > 0.f ? v : 0.f);
    Y[r * ldh + j] = gd;
    sdt.base[(size_t)r * sdt.ld + j] = gd;
    if (!stat) {
      float u = 0.f;
      for (int c = 4; c < N_RAW; ++c)
        u += g16[r * G_RAW + c] * bf(w_heads[(size_t)c * W + half + j]);
      const bf16 gt = __float2bfloat16(bf(X[r * ldh + j]) > 0.f ? u : 0.f);
      X[r * ldh + j] = gt;
      st3.base[(size_t)r * st3.ld + j] = gt;
    }
  }
  __syncthreads();

  // ---- transient chain, t3 down to t0 (the t half of G_dt)
  if (!stat) {
    const bf16* w_tr = wts + of.w_tr;
    const size_t hh = (size_t)half * half;
    const StashOut t1 = at(R_T(D, 1));
    panel_layer<true, NJ>(X, ldh, half, w_tr + 2 * hh, nullptr, 0, 0, nullptr, half, pan0,
                      pan1, nullptr, nullptr, 0, nullptr, X + half, ldh, nullptr, 0,
                      nullptr, X + half, ldh, at(R_GT(D, 2)), scratch);
    panel_layer<true, NJ>(X + half, ldh, half, w_tr + hh, nullptr, 0, 0, nullptr, half, pan0,
                      pan1, nullptr, nullptr, 0, nullptr, t1.base, t1.ld, nullptr, 0,
                      nullptr, X, ldh, at(R_GT(D, 1)), scratch);
    panel_layer<true, NJ>(X, ldh, half, w_tr, nullptr, 0, 0, nullptr, half, pan0, pan1,
                      nullptr, nullptr, 0, nullptr, Y + half, ldh, nullptr, 0, nullptr,
                      Y + half, ldh, col(sdt, half), scratch);
  }

  // ---- the dt layer's input grad plus the sigma head's share, masked by
  // h_{D-1}; then the trunk, layer D-1 down to 1 (the skip layer's h half)
  {
    const StashOut h = at(R_H(D - 1));
    panel_layer<true, NJ>(Y, ldh, Wd, wts + of.w_dt, nullptr, 0, 0, nullptr, W, pan0, pan1,
                      nullptr, nullptr, 0, nullptr, h.base, h.ld, g16 + 3, G_RAW,
                      w_heads + (size_t)3 * W, X, ldh, at(R_GH(D, D - 1)), scratch);
  }
  bf16* gc = X;
  bf16* ga = Y;
  for (int i = D - 1; i >= 1; --i) {
    const bf16* wh = wts + trunk_off(dm, i) + (i == dm.skip ? (size_t)W * K0 : 0);
    const StashOut h = at(R_H(i - 1));
    panel_layer<true, NJ>(gc, ldh, W, wh, nullptr, 0, 0, nullptr, W, pan0, pan1, nullptr,
                      nullptr, 0, nullptr, h.base, h.ld, nullptr, 0, nullptr, ga, ldh,
                      at(R_GH(D, i - 1)), scratch);
    bf16* t = gc;
    gc = ga;
    ga = t;
  }
}

// ---------------------------------------------------------------------------
// 2. bwd_wgrad
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 3;
constexpr int WG_NF = 4;                        // n-fragments a warp holds
constexpr int WG_THREADS = 32 * 4 * (WG_BN / (16 * WG_NF));   // 4 warps along M
constexpr int WG_LD = WG_BM + PAD;   // == WG_BN + PAD
constexpr size_t WG_SMEM = (size_t)WG_STAGES * 2 * WG_BK * WG_LD * sizeof(bf16);
// problem table columns (ops/nerf_kernels.py::BWD_PROBLEM_COLS)
enum { P_GOFF, P_GLD, P_GCOL, P_AOFF, P_ALD, P_ACOL, P_M, P_K, P_R0, P_R1, P_WOFF, P_WLD,
       P_BOFF, P_NCOLS };

// One (chunk, problem, 128x128 output tile) a block: 4 x (128 / 16 WG_NF)
// warps, each 32 rows x 16 WG_NF columns of the tile, float32 sums in registers
// over the chunk's points; G^T is a col-major A operand of the point-major
// G tile. Fragments outside the problem's M x K are skipped, warp-uniformly.
__global__ void __launch_bounds__(WG_THREADS, 512 / WG_THREADS)
bwd_wgrad_kernel(const bf16* __restrict__ stash, const long long* __restrict__ problems,
                 const int* __restrict__ jobs, int n_jobs, long long Pp, long long chunk,
                 int nw, float* __restrict__ partials, long long part_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int job = blockIdx.x % n_jobs;
  const long long ck = blockIdx.x / n_jobs;
  const long long* pr = problems + (size_t)jobs[job * 3] * P_NCOLS;
  const int m0 = jobs[job * 3 + 1], n0 = jobs[job * 3 + 2];
  const int Mt = min(WG_BM, (int)pr[P_M] - m0), Kt = min(WG_BN, (int)pr[P_K] - n0);
  const int gld = (int)pr[P_GLD], ald = (int)pr[P_ALD];
  const bf16* Gp = stash + pr[P_GOFF] + pr[P_GCOL] + m0;
  const bf16* Ap = stash + pr[P_AOFF] + pr[P_ACOL] + n0;
  const bool with_bias = pr[P_BOFF] >= 0 && n0 == 0;
  const long long pb = ck * chunk;
  const long long pe = min(Pp, pb + chunk);
  const int nk = (int)((pe - pb) / WG_BK);

  bf16* ring = reinterpret_cast<bf16*>(smem);
  auto Gs = [&](int s) { return ring + (size_t)s * 2 * WG_BK * WG_LD; };
  auto As = [&](int s) { return Gs(s) + (size_t)WG_BK * WG_LD; };
  const int gc = Mt / 8, ac = Kt / 8;
  auto issue = [&](int kt) {
    if (kt < nk) {
      const int s = kt % WG_STAGES;
      const long long p = pb + (long long)kt * WG_BK;
      for (int i = threadIdx.x; i < WG_BK * (gc + ac); i += WG_THREADS) {
        const int r = i / (gc + ac), c = i % (gc + ac);
        if (c < gc)
          cp_async16(Gs(s) + r * WG_LD + c * 8, Gp + (p + r) * gld + c * 8);
        else
          cp_async16(As(s) + r * WG_LD + (c - gc) * 8, Ap + (p + r) * ald + (c - gc) * 8);
      }
    }
    cp_commit();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2;
  const bool live_m[2] = {wm * 32 < Mt, wm * 32 + 16 < Mt};
  bool live_n[WG_NF];
#pragma unroll
  for (int ni = 0; ni < WG_NF; ++ni) live_n[ni] = (wn * WG_NF + ni) * 16 < Kt;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][WG_NF], accb[2];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ones;
  wmma::fill_fragment(ones, __float2bfloat16(1.f));
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    wmma::fill_fragment(accb[mi], 0.f);
#pragma unroll
    for (int ni = 0; ni < WG_NF; ++ni) wmma::fill_fragment(acc[mi][ni], 0.f);
  }
  const bool bias_warp = with_bias && wn == 0;

  for (int s = 0; s < WG_STAGES - 1; ++s) issue(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<WG_STAGES - 2>();
    __syncthreads();
    issue(kt + WG_STAGES - 1);
    const bf16* g = Gs(kt % WG_STAGES);
    const bf16* a = As(kt % WG_STAGES);
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[WG_NF];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (live_m[mi])
          wmma::load_matrix_sync(fa[mi], g + kk * WG_LD + wm * 32 + mi * 16, WG_LD);
#pragma unroll
      for (int ni = 0; ni < WG_NF; ++ni)
        if (live_n[ni])
          wmma::load_matrix_sync(fb[ni], a + kk * WG_LD + (wn * WG_NF + ni) * 16, WG_LD);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!live_m[mi]) continue;
#pragma unroll
        for (int ni = 0; ni < WG_NF; ++ni)
          if (live_n[ni]) wmma::mma_sync(acc[mi][ni], fa[mi], fb[ni], acc[mi][ni]);
        if (bias_warp) wmma::mma_sync(accb[mi], fa[mi], ones, accb[mi]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // epilogue through a per-warp 16x16 scratch: rows [r0, r1) of the
  // problem, 8 columns a lane
  float* scr = reinterpret_cast<float*>(smem) + warp * 256;
  float* part = partials + ck * part_stride;
  const int r0 = (int)pr[P_R0], r1 = (int)pr[P_R1];
  const long long woff = pr[P_WOFF], wld = pr[P_WLD];
  const int lr = lane >> 1, lc = (lane & 1) * 8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (!live_m[mi]) continue;
    const int row = m0 + wm * 32 + mi * 16 + lr;
    const bool keep = row >= r0 && row < r1;
#pragma unroll
    for (int ni = 0; ni < WG_NF; ++ni) {
      if (!live_n[ni]) continue;
      wmma::store_matrix_sync(scr, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      if (keep) {
        float* dst = part + woff + row * wld + n0 + (wn * WG_NF + ni) * 16 + lc;
        reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(scr + lr * 16 + lc)[0];
        reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(scr + lr * 16 + lc)[1];
      }
      __syncwarp();
    }
    if (bias_warp) {
      wmma::store_matrix_sync(scr, accb[mi], 16, wmma::mem_row_major);
      __syncwarp();
      const int brow = m0 + wm * 32 + mi * 16 + lane;
      if (lane < 16 && brow >= r0 && brow < r1) part[nw + pr[P_BOFF] + brow] = scr[lane * 16];
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// 3. bwd_reduce
// ---------------------------------------------------------------------------

// The d_w entries no problem writes, so no partial holds: the heads' zero
// blocks, rgb rows 0:3 over the t half and transient rows 4:9 over the d
// half of w_heads (W columns, from heads).
__device__ inline bool head_gap(long long e, long long heads, int W) {
  if (e < heads) return false;
  const int r = (int)((e - heads) / W), c = (int)((e - heads) % W);
  return r < 3 ? c >= W / 2 : (r > 3 && c < W / 2);
}

__global__ void bwd_reduce_kernel(const float* __restrict__ partials, int n_chunks,
                                  long long part_stride, int nw, int nb, long long heads,
                                  int W, bf16* __restrict__ dw, float* __restrict__ db,
                                  const bf16* __restrict__ g_dt, int N, int S, int Wd,
                                  float* __restrict__ d_dpt) {
  const long long n = (long long)nw + nb + (long long)N * Wd;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < nw && head_gap(e, heads, W)) {
      dw[e] = __float2bfloat16(0.f);
    } else if (e < nw + nb) {
      float s = 0.f;
      for (int c = 0; c < n_chunks; ++c) s += partials[c * part_stride + e];
      if (e < nw)
        dw[e] = __float2bfloat16(s);
      else
        db[e - nw] = s;
    } else {
      const long long q = e - nw - nb;
      const long long ray = q / Wd;
      const int j = (int)(q % Wd);
      const bf16* src = g_dt + ray * S * Wd + j;
      float s = 0.f;
      for (int t = 0; t < S; ++t) s += bf(src[(size_t)t * Wd]);
      d_dpt[q] = s;
    }
  }
}

}  // namespace

// Launch 1. regions: host arrays of the stash regions' offsets (elements)
// and widths, n_regions == 2 D + 10. The wrapper checks W (a multiple of 32,
// at most 256) and the skip.
extern "C" int dfn_raw_bwd_stash(const float* ro, const float* rd, const float* z,
                                 const float* dpt, int N, int S, const void* wts,
                                 const float* bias, const float* freqs, int D, int W,
                                 int skip, int F, int stat, const float* g, void* stash,
                                 const long long* reg_off, const int* reg_width,
                                 int n_regions, void* stream) {
  if (n_regions != 2 * D + 10 || n_regions > MAX_REGIONS) return (int)cudaErrorInvalidValue;
  Dims dm{D, W, skip, F, pe_cols(F), BTP};
  Regions rg{};
  for (int i = 0; i < n_regions; ++i) {
    rg.off[i] = reg_off[i];
    rg.width[i] = reg_width[i];
  }
  const StashLayout L = stash_layout(dm.K0, W);
  auto kernel = W <= 128 ? bwd_stash_kernel<2> : bwd_stash_kernel<4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = ((long long)N * S + BTP - 1) / BTP;
  kernel<<<(unsigned)tiles, NTHREADS, L.total, (cudaStream_t)stream>>>(
      ro, rd, z, dpt, g, N, S, (const bf16*)wts, bias, freqs, dm, stat, (bf16*)stash, rg);
  return (int)cudaGetLastError();
}

// Launch 2. problems: device int64 (n_problems, 13); jobs: device int32
// (n_jobs, 3) of (problem, m0, n0); Pp and chunk are multiples of 64.
extern "C" int dfn_raw_bwd_wgrad(const void* stash, const long long* problems,
                                 const int* jobs, int n_jobs, long long Pp,
                                 long long chunk, int n_chunks, int nw, float* partials,
                                 long long part_stride, void* stream) {
  if (Pp % WG_BK != 0 || chunk % WG_BK != 0 || n_jobs < 1 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bwd_wgrad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  bwd_wgrad_kernel<<<(unsigned)((long long)n_jobs * n_chunks), WG_THREADS, WG_SMEM,
                     (cudaStream_t)stream>>>((const bf16*)stash, problems, jobs, n_jobs,
                                             Pp, chunk, nw, partials, part_stride);
  return (int)cudaGetLastError();
}

// Launch 3. heads: offset of w_heads in the packed weights; g_dt: the
// stash's G_dt region.
extern "C" int dfn_raw_bwd_reduce(const float* partials, int n_chunks, long long part_stride,
                                  int nw, int nb, long long heads, int W, void* dw, float* db,
                                  const void* g_dt, int N, int S, int Wd, float* d_dpt,
                                  void* stream) {
  const long long n = (long long)nw + nb + (long long)N * Wd;
  const int grid = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  bwd_reduce_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      partials, n_chunks, part_stride, nw, nb, heads, W, (bf16*)dw, db, (const bf16*)g_dt,
      N, S, Wd, d_dpt);
  return (int)cudaGetLastError();
}
