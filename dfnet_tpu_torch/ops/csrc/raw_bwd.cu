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
// The TPU kernel kept a 1024-point tile's activations in VMEM and summed
// weight grads across its sequential grid; a block here has 227 KB and runs
// in parallel with the others. So the work is split:
//
//   1. bwd_stash: recomputes the forward (fine_raw_t's arithmetic: the same
//      PE, k order, bias, dpt and ReLU), runs the cotangent chain (heads,
//      transient chain, dt layer plus the sigma head's rank-1 share, trunk)
//      and writes each weight matrix's bf16 input activation A_l and masked
//      bf16 output cotangent G_l, and the bf16 g, to a point-major stash in
//      device memory (16-byte stores).
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
//
// What bounds bwd_stash on the H100: a point costs ~2 forward passes of bf16
// products (the recompute and the cotangent chain: ~2.0e6 flop at the
// original NeRF's W=256, D=8 static pack, ~2.1 ns at 989 TFLOP/s) and writes
// its stash row (~8.9 KB of bf16 there, ~2.7 ns at 3.35 TB/s): the bytes
// bound it, just, with the operations close behind. So the products have to
// run near the tensor cores' rate while the stores stream out beside them.
//
// Design (mlp_stack.cu's warpgroup scheme; the first version ran each layer
// as WMMA 16x16x16 on fragments read from shared memory, its weights
// streamed through two cp.async panels with two __syncthreads() a panel,
// one 64-point tile a block, at ~7% of the bound):
//   - persistent blocks, at most one an SM: a producer warpgroup and ncw
//     consumer warpgroups, each consumer owning 64 points (a stash tile) of
//     the block's 64 ncw. ncw is at most 4 at W <= 128, 2 above (the 64 x W
//     sums take W/2 registers a thread); the launch takes fewer where the
//     points would leave SMs idle (launch_stash: the fewest rounds of blocks,
//     a block costing its consumers plus one);
//   - the weights arrive by TMA in panels 64 deep (one 64 x 64 box per 64
//     outputs under the 128-byte swizzle) into a ring of mbarrier-guarded
//     stages, which one producer thread keeps full across layers and tiles,
//     walking the same table of products (build_ops) as the consumers.
//     Every consumer of the block reads each panel. A forward panel is
//     K-major (an (out, in) matrix's rows are its outputs); a backward
//     panel, 64 rows of the same row-major matrix read as G . W, is MN-major
//     and enters wgmma with imm-trans-b = 1, so no transposed copy is made;
//   - a consumer's activations stay in shared memory as wgmma's A operand
//     (K-major, 128-byte swizzle): x0 (K0 columns), X (W) and, for the fine
//     pack, Y (W/2, the transient chain). Every product is wgmma m64nNk16 at
//     N = the kernel's padded width (one accumulator shape a kernel: with
//     several, ptxas serialised every product and spilled the sums), the
//     sums in registers, then an in-place epilogue: forward bias, the
//     per-ray dpt row (dt layer) and max.NaN ReLU; backward the mask of the
//     stashed activation > 0 (read back from the stash, L2-hot) and the sigma
//     head's rank-1 term (dt layer); then fence.proxy.async and a named
//     barrier of the consumer's 128 threads. X holds h_i in place through
//     the trunk, then [d | t0]; t1..t3 run in Y; the cotangents follow the
//     same tiles backwards (g_t3..g_t1 in Y, G_dt = [g_d | g_t0] in X, then
//     g_h in place in X);
//   - the epilogue's global reads go out together before its stores, the
//     first chunk beside the last group of products, and whatever it reads
//     of shared memory it reads once: every shared-memory asm is a compiler
//     barrier to memory, behind which each read and load would otherwise
//     wait in turn;
//   - a tile's bf16 rows leave for the stash as 16-byte stores read back
//     from the swizzled tile, deferred into the next product until its first
//     group of products is in flight, so the stores overlap the tensor
//     cores;
//   - the heads (at most 9 rows) stay on the CUDA cores, 8 columns a thread;
//   - setmaxnreg gives the producer 40 registers and the consumers the rest.
// The same k order, bias, dpt and ReLU as fine_raw_t's kernel (fine_raw.cu,
// the forward half of this design) and the WMMA sweep (panel.cuh), so the
// trunk activations, and the whole stash, are fine_raw_t's and the first
// version's bit for bit (tests/test_torch_port_gpu.py).
// Measured and not kept (PERF.md, Findings): the stash written by TMA
// stores from the tiles (5% faster at W = 128, 13-16% slower at W = 256,
// where those stores share the SM's TMA unit with the weight loads and the
// kernel spilled); every epilogue read issued before the products (spills
// at W = 256); three consumers at W <= 128 (7% faster at 18,432 points, 6%
// slower at 196,608).
// Shared memory a block (stash_layout): ncw x (x0 + X + Y tiles, 8 KB per
// 64 columns) + stages x W x 128 B + ncw x 5.25 KB (g, points, z, rays), and
// the product table (static). W=256: fine 2 x 56 KB + 3 stages of 32 KB;
// static 2 x 40 KB + 4 stages; W=128 fine: 4 x 32 KB + 4 stages of 16 KB.

#include "hopper.cuh"
#include "panel.cuh"

using namespace dfn;

namespace {

constexpr int BTP = 64;      // points per stash tile (a consumer's rows, wgmma's M)
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

constexpr int SMEM_LIMIT = 232448;       // shared bytes a block may have, static and dynamic
constexpr int ALIGN = 1024;              // the 128-byte swizzle repeats every 8 rows
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int MAX_MATS = 16 + 5;         // w0, D - 1 trunk layers (one of them wx, wh), dt, 3 tr
constexpr int MAX_OPS = 2 * 16 + 7;
// a consumer's g (float, G_RAW a row), points, z and rays
constexpr int MISC_BYTES = BTP * (G_RAW + 3 + 1 + 1) * 4;
enum { T_X0, T_X, T_Y };                 // a consumer's activation tiles

struct Maps {
  CUtensorMap m[MAX_MATS];               // the weight matrices, in packed order
};

// One product of the walk (build_ops): out = epilogue(sum over the input
// segments of A_s . B_s), A_s columns [a_col, a_col + k) of a tile, B_s the
// matrix `map` (forward: (out, in) read K-major; bwd: (out, in) read as
// G . W, MN-major). n outputs land in columns [out_col, out_col + n) of
// out_tile and in the stash region st_reg from column st_col.
struct Op {
  int nseg, map[2], a_tile[2], a_col[2], k[2];
  int n, bwd, out_tile, out_col;
  int bias, dpt;                         // forward: bias offset (floats); add dpt[ray]
  int mask_reg, mask_col, rank1;         // backward: the mask's region; the sigma head's term
  int st_reg, st_col;
};

__host__ __device__ inline int mat_of(const Dims& dm, int i) {   // trunk layer i >= 1
  return i + (dm.skip >= 1 && i > dm.skip ? 1 : 0);
}

// The products of a tile in order: the forward recompute (*nfwd of them),
// then, after the heads, the cotangent chain. Returns their count.
__device__ inline int build_ops(const Dims& dm, int stat, Op* ops, int* nfwd) {
  const int W = dm.W, half = W / 2, D = dm.D, Wd = stat ? half : W;
  const Offsets of = offsets(dm, stat);
  const int m_dt = D + (dm.skip >= 1 ? 1 : 0), m_tr = m_dt + 1;
  int n = 0;
  auto add = [&](int map, int tile, int col, int k, int N, int bwd, int out_tile, int out_col,
                 int st_reg, int st_col) -> Op& {
    Op& o = ops[n++];
    o = Op{};
    o.nseg = 1;
    o.map[0] = map;
    o.a_tile[0] = tile;
    o.a_col[0] = col;
    o.k[0] = k;
    o.n = N;
    o.bwd = bwd;
    o.out_tile = out_tile;
    o.out_col = out_col;
    o.bias = -1;
    o.mask_reg = -1;
    o.st_reg = st_reg;
    o.st_col = st_col;
    return o;
  };
  add(0, T_X0, 0, dm.K0, W, 0, T_X, 0, R_H(0), 0).bias = 0;
  for (int i = 1; i < D; ++i) {
    const int m = mat_of(dm, i);
    Op& o = i == dm.skip ? add(m, T_X0, 0, dm.K0, W, 0, T_X, 0, R_H(i), 0)
                         : add(m, T_X, 0, W, W, 0, T_X, 0, R_H(i), 0);
    if (i == dm.skip) {    // [x0 | h]: x0's products first, as panel_layer
      o.nseg = 2;
      o.map[1] = m + 1;
      o.a_tile[1] = T_X;
      o.a_col[1] = 0;
      o.k[1] = W;
    }
    o.bias = i * W;
  }
  Op& dt = add(m_dt, T_X, 0, W, Wd, 0, T_X, 0, R_DT0(D), 0);
  dt.bias = of.b_dt;
  dt.dpt = 1;
  if (!stat)
    for (int q = 0; q < 3; ++q)   // t1 over t0 (X's second half), t2, t3 in Y
      add(m_tr + q, q == 0 ? T_X : T_Y, q == 0 ? half : 0, half, half, 0, T_Y, 0, R_T(D, q + 1),
          0).bias = of.b_tr + q * half;
  *nfwd = n;
  if (!stat)
    for (int q = 2; q >= 0; --q) {   // g_t2, g_t1 in Y; g_t0 into X's second half
      Op& o = add(m_tr + q, T_Y, 0, half, half, 1, q == 0 ? T_X : T_Y, q == 0 ? half : 0,
                  q == 0 ? R_GDT(D) : R_GT(D, q), q == 0 ? half : 0);
      o.mask_reg = q == 0 ? R_DT0(D) : R_T(D, q);
      o.mask_col = q == 0 ? half : 0;
    }
  Op& gdt = add(m_dt, T_X, 0, Wd, W, 1, T_X, 0, R_GH(D, D - 1), 0);
  gdt.mask_reg = R_H(D - 1);
  gdt.rank1 = 1;
  for (int i = D - 1; i >= 1; --i)
    add(mat_of(dm, i) + (i == dm.skip ? 1 : 0), T_X, 0, W, W, 1, T_X, 0, R_GH(D, i - 1), 0)
        .mask_reg = R_H(i - 1);
  return n;
}

// Byte offsets of the dynamic shared memory from its 1024-aligned base.
struct StashLayout {
  int kx, kw, ky;              // 64-column blocks of a consumer's x0, X and Y tiles
  int tile_bytes, stage_bytes, ring, misc, bars, total;
};

__host__ __device__ inline StashLayout stash_layout(int K0, int W, int stat, int ncw,
                                                    int stages, int WP) {
  StashLayout L;
  L.kx = (K0 + 63) / 64;
  L.kw = (W + 63) / 64;
  L.ky = stat ? 0 : (W / 2 + 63) / 64;
  L.tile_bytes = (L.kx + L.kw + L.ky) * PBYTES;
  L.stage_bytes = WP / 64 * PBYTES;              // a panel for WP outputs
  L.ring = ncw * L.tile_bytes;
  L.misc = L.ring + stages * L.stage_bytes;
  L.bars = L.misc + ncw * MISC_BYTES;
  L.total = L.bars + 2 * stages * 8 + ALIGN;     // + ALIGN: the base is rounded up
  return L;
}

// The launch's arguments. The kernel reads them where it uses them (the
// constant bank): the consumers' registers go to the 64 x N sums.
struct StashArgs {
  Maps maps;                   // the weight matrices, in packed order
  Regions rg;
  const float *ro, *rd, *z, *dpt, *g, *bias, *freqs;
  const bf16* wts;
  bf16* stash;
  Dims dm;
  int N, S, stat, ncw, stages;
};

// What the block's threads share, written once by thread 0: the walk's
// products and the geometry, read where used.
struct Block {
  Op ops[MAX_OPS];
  int nfwd, nops, w_heads;     // w_heads: offset of the head matrix in the packed weights
  uint32_t base;               // shared address of the 1024-aligned dynamic base
  StashLayout L;
};
__shared__ Block blk;
// dynamic shared bytes a block may ask for beside blk
constexpr int DYN_LIMIT = SMEM_LIMIT - (int)((sizeof(Block) + 127) / 128 * 128);

// The kernel of a padded width WP (128: W <= 128, 256: W <= 256).
template <int WP>
struct StashGeo {
  static constexpr int NCW = WP <= 128 ? 4 : 2;   // consumer warpgroups at most
  static constexpr int THREADS = (NCW + 1) * WGT;
  // registers a consumer thread gets: the block's share (the launch bound,
  // in steps of 8) less the producer's 40, over the consumers
  static constexpr int SHARE =
      ((65536 / THREADS / 8 * 8) * THREADS - PRODUCER_REGS * WGT) / (NCW * WGT) / 8 * 8;
  static constexpr int CONSUMER_REGS = SHARE > 232 ? 232 : SHARE;
};

// Consumer c's tiles, its g (float, G_RAW a row), points, z and rays.
__device__ __forceinline__ uint32_t tile_of(int c, int id) {
  return blk.base + c * blk.L.tile_bytes +
         (id == T_X0 ? 0 : id == T_X ? blk.L.kx : blk.L.kx + blk.L.kw) * PBYTES;
}
__device__ __forceinline__ float* g16_of(int c) {
  return sptr<float>(blk.base + blk.L.misc + c * MISC_BYTES);
}
__device__ __forceinline__ float* pts_of(int c) { return g16_of(c) + BTP * G_RAW; }
__device__ __forceinline__ float* rz_of(int c) { return pts_of(c) + BTP * 3; }
__device__ __forceinline__ int* ray_of(int c) { return reinterpret_cast<int*>(rz_of(c) + BTP); }
__device__ __forceinline__ bf16* region(const StashArgs& a, int reg, long long row) {
  return a.stash + a.rg.off[reg] + row * a.rg.width[reg];
}

// A consumer's place in the weight ring, and the tile columns it still owes
// the stash: `pend` is a product's index (its output), PEND_X0 (the x0
// tile) or -1 (none).
constexpr int PEND_X0 = MAX_OPS;
struct Walk {
  int stage;
  uint32_t phase;
  int pend;
};

// The pending tile columns to the stash: 16-byte reads of the swizzled tile,
// 16-byte stores, consecutive threads on consecutive chunks of a row. A
// consumer whose 64 points start past the sweep's (a last block's spare)
// keeps nothing.
__device__ __forceinline__ void flush(const StashArgs& a, int c, int p0, Walk& wk) {
  if (wk.pend < 0) return;
  uint32_t tile;
  int col, n, reg, scol;
  if (wk.pend == PEND_X0) {
    tile = tile_of(c, T_X0);
    col = 0;
    n = a.dm.K0;
    reg = R_X0();
    scol = 0;
  } else {
    const Op& op = blk.ops[wk.pend];
    tile = tile_of(c, op.out_tile);
    col = op.out_col;
    n = op.n;
    reg = op.st_reg;
    scol = op.st_col;
  }
  wk.pend = -1;
  if (p0 >= a.N * a.S) return;
  const int cpr = n / 8, w = a.rg.width[reg], t = threadIdx.x % WGT;
  const int dr = WGT / cpr, dk = WGT % cpr;
  bf16* dst = region(a, reg, p0) + scol;
  int r = t / cpr, k = t % cpr;
  for (int i = t; i < BTP * cpr; i += WGT) {
    *reinterpret_cast<uint4*>(dst + (size_t)r * w + 8 * k) = lds16(tile_at(tile, r, col + 8 * k));
    r += dr;
    k += dk;
    if (k >= cpr) {
      k -= cpr;
      ++r;
    }
  }
}

// One 16-deep k-step: A columns [col, col + 16) of the tile at `at`, the
// k-step kk of the ring stage at pb.
template <int NP, int BWD, int M>
__device__ __forceinline__ void mma_step(float (&d)[M], uint32_t at, int col, uint32_t pb, int kk,
                                         int scale) {
  const uint64_t a = desc_sw128(at + (col >> 6) * PBYTES + (col & 63) * 2);
  const uint64_t b = BWD ? desc_sw128_mn(pb + kk * 16 * SWZ) : desc_sw128(pb + kk * 32);
  wgmma_bf16<NP, BWD>(d, a, b, scale);
}

// Product o of the walk for consumer c's 64 points from p0. Every product
// runs at N = NP, the kernel's padded width: one accumulator shape a kernel,
// as ptxas serialises the products of a kernel that holds several. The sums
// of outputs past the product's n (whatever the ring stage holds there) are
// never read.
template <int NP, int BWD>
__device__ __forceinline__ void layer(const StashArgs& a, int c, int p0, int o, Walk& wk) {
  float d[NP / 2];
  const int t = threadIdx.x % WGT;
  // (locals: each shared-memory asm below is a compiler barrier to memory)
  const uint32_t bars = blk.base + blk.L.bars, ring = blk.base + blk.L.ring;
  const int stage_bytes = blk.L.stage_bytes, nseg = blk.ops[o].nseg;
  int first = 1, prev = 0;
  for (int sg = 0; sg < nseg; ++sg) {
    const uint32_t at = tile_of(c, blk.ops[o].a_tile[sg]);
    const int K = blk.ops[o].k[sg], c0 = blk.ops[o].a_col[sg];
    for (int k0 = 0; k0 < K; k0 += 64) {
      mbar_wait(bars + 8 * wk.stage, wk.phase);
      const uint32_t pb = ring + wk.stage * stage_bytes;
      // a fence before every panel's group, as the barrier wait and the
      // release are divergent code between groups
      fence_acc(d);
      wgmma_fence();
      if (K - k0 >= 64) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_step<NP, BWD>(d, at, c0 + k0 + 16 * kk, pb, kk, !first || kk > 0);
      } else {
        for (int kk = 0; kk < (K - k0) / 16; ++kk)
          mma_step<NP, BWD>(d, at, c0 + k0 + 16 * kk, pb, kk, !first || kk > 0);
      }
      wgmma_commit();
      if (!first) {
        wgmma_wait<1>();                 // the previous panel's group is done
        fence_acc(d);
        if (t == 0) mbar_arrive(bars + 8 * (a.stages + prev));
      } else {
        flush(a, c, p0, wk);             // the last product's stash rows, beside these
      }
      first = 0;
      prev = wk.stage;
      if (++wk.stage == a.stages) {
        wk.stage = 0;
        wk.phase ^= 1;
      }
    }
  }
  // The epilogue's global reads go out before its stores (each store would
  // otherwise wait on its own loads), most of them beside the last group of
  // products: the bias (forward) or the masks, the stashed activations > 0
  // as bf16 pairs (backward), of JC 8-column groups at a time, all of them
  // at NP = 256; the dt layer's per-ray dpt and the sigma head's weights
  // (one product each) SUB groups at a time.
  constexpr int JC = NP <= 128 ? 4 : NP / 8, SUB = 4;
  const Op& op = blk.ops[o];
  const int row0 = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4), n = op.n;
  const int out_col = op.out_col, rank1 = op.rank1;
  const int Wd = a.stat ? a.dm.W / 2 : a.dm.W;
  const bool live = p0 < a.N * a.S;   // else the masks read as zero
  int ray[2];
  float gs[2];
  const float2* drow[2];              // the rows' dpt, this thread's columns
  const uint32_t* mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ray[h] = !BWD && op.dpt ? ray_of(c)[row0 + 8 * h] : -1;
    drow[h] = reinterpret_cast<const float2*>(a.dpt + (size_t)(ray[h] > 0 ? ray[h] : 0) * Wd + cq);
    mrow[h] = reinterpret_cast<const uint32_t*>(
        region(a, BWD ? op.mask_reg : 0, (long long)p0 + row0 + 8 * h) + op.mask_col + cq);
    gs[h] = BWD && rank1 ? g16_of(c)[(row0 + 8 * h) * G_RAW + 3] : 0.f;
  }
  const float2* bp = reinterpret_cast<const float2*>(a.bias + op.bias + cq);
  const __nv_bfloat162* wsp =
      reinterpret_cast<const __nv_bfloat162*>(a.wts + blk.w_heads + 3 * a.dm.W + cq);
  float2 u[JC];        // forward: the bias
  uint32_t m[2][JC];   // backward: the masks
  auto fetch = [&](int q) {
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const bool on = 8 * (q + jj) < n;
      if (!BWD) {
        u[jj] = on ? __ldg(bp + 4 * (q + jj)) : make_float2(0.f, 0.f);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) m[h][jj] = on && live ? mrow[h][4 * (q + jj)] : 0u;
      }
    }
  };
  fetch(0);
  wgmma_wait<0>();
  fence_acc(d);
  if (t == 0) mbar_arrive(bars + 8 * (a.stages + prev));
  csync(c);   // every warp's products have read the A tiles: the epilogue works in place

  // registers (4j + 2h, 4j + 2h + 1): row 16 warp + lane / 4 + 8 h,
  // columns 8 j + 2 (lane % 4) + {0, 1}
  // the swizzled byte offset of column out_col + 8 j + cq: xo[j % 8] plus
  // 8 KB a block of 64 columns, j / 8 of them (row r's 128-byte line at
  // 128 r; chunk k of it at k ^ (r % 8), and r % 8 is row0 % 8 for both h)
  uint32_t xo[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c8 = (out_col >> 3) + k;
    xo[k] = (c8 >> 3) * PBYTES + (((c8 & 7) ^ (row0 & 7)) << 4);
  }
  const uint32_t ob = tile_of(c, op.out_tile) + row0 * SWZ + cq * 2;
  float2 e[2][SUB];    // forward: dpt (dt layer); backward: w_sigma (e[0]; dt layer)
#pragma unroll
  for (int q = 0; q < NP / 8; q += JC) {
    if (8 * q >= n) break;
    if (q > 0) fetch(q);
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const int j = q + jj;
      if (8 * j >= n) break;
      if (j % SUB == 0) {
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const bool on = 8 * (j + s) < n;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            e[h][s] = !BWD && on && ray[h] >= 0 ? __ldg(drow[h] + 4 * (j + s))
                                                : make_float2(0.f, 0.f);
          if (BWD && on && rank1) e[0][s] = __bfloat1622float2(__ldg(wsp + 4 * (j + s)));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0 = d[4 * j + 2 * h], x1 = d[4 * j + 2 * h + 1];
        const uint32_t at = ob + 8 * h * SWZ + xo[j % 8] + (j / 8) * PBYTES;
        if (!BWD) {
          // panel_layer's order: the bias, then the per-ray row
          x0 += u[jj].x;
          x1 += u[jj].y;
          if (ray[h] >= 0) {
            x0 += e[h][j % SUB].x;
            x1 += e[h][j % SUB].y;
          }
          sts_pair(at, relu_nan(x0), relu_nan(x1));
        } else {
          if (rank1) {
            x0 += gs[h] * e[0][j % SUB].x;
            x1 += gs[h] * e[0][j % SUB].y;
          }
          const uint32_t mk = m[h][jj];
          sts_pair(at, bf_lo(mk) > 0.f ? x0 : 0.f, bf_hi(mk) > 0.f ? x1 : 0.f);
        }
      }
    }
  }
  // the generic stores, visible to the next product's asynchronous reads
  fence_async();
  csync(c);
  wk.pend = o;
}

// The tile's rows, g rounded to bf16 (shared float copy and the stash's g
// region), the points and x0 (panel.cuh::build_pe_sincos' arithmetic) in
// the x0 tile, bound for the stash.
__device__ __forceinline__ void tile_inputs(const StashArgs& a, int c, int p0, Walk& wk) {
  const int t = threadIdx.x % WGT, P = a.N * a.S, S = a.S;
  const int NR = a.stat ? N_STATIC : N_RAW;
  float* g16 = g16_of(c);
  float* pts = pts_of(c);
  float* rz = rz_of(c);
  int* ray = ray_of(c);
  if (t < BTP) {
    const int p = p0 + t;
    ray[t] = p < P ? p / S : -1;
    rz[t] = p < P ? a.z[p] : 0.f;
  }
  float gv[BTP * G_RAW / WGT];   // the loads together, then the shared stores
#pragma unroll
  for (int k = 0; k < BTP * G_RAW / WGT; ++k) {
    const int i = t + k * WGT, col = i / BTP, p = p0 + i % BTP;
    gv[k] = p < P && col < NR ? __ldg(a.g + (size_t)col * P + p) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < BTP * G_RAW / WGT; ++k) {
    const int i = t + k * WGT;
    g16[(i % BTP) * G_RAW + i / BTP] = bf(__float2bfloat16(gv[k]));
  }
  csync(c);
  if (p0 < P) {   // 2 x 8 columns a row
    const int r = t / 2, h = t % 2;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(g16[r * G_RAW + 8 * h + e]);
    *reinterpret_cast<uint4*>(region(a, R_GRAW(a.dm.D), p0 + r) + 8 * h) =
        *reinterpret_cast<const uint4*>(v);
  }
  for (int i = t; i < BTP * 3; i += WGT) {
    const int r = i / 3, k = i % 3;
    const int ry = ray[r];
    const float zr = rz[r];
    pts[i] = ry >= 0 ? a.ro[(size_t)ry * 3 + k] + a.rd[(size_t)ry * 3 + k] * zr : 0.f;
  }
  csync(c);
  const uint32_t x0 = tile_of(c, T_X0);
  const int F = a.dm.F, live = 6 * F + 3, extra = 3 + a.dm.K0 - live;
  for (int i = t; i < BTP * F * 3; i += WGT) {
    const int r = i / (F * 3), k = (i / 3) % F, j = i % 3;
    float sn, cs;
    sincosf(a.freqs[k] * pts[r * 3 + j], &sn, &cs);
    sts_bf16(tile_at(x0, r, 3 + 6 * k + j), __float2bfloat16(sn));
    sts_bf16(tile_at(x0, r, 6 + 6 * k + j), __float2bfloat16(cs));
  }
  for (int i = t; i < BTP * extra; i += WGT) {
    const int r = i / extra, f = i % extra;
    sts_bf16(tile_at(x0, r, f < 3 ? f : live + f - 3),
             __float2bfloat16(f < 3 ? pts[r * 3 + f] : 0.f));
  }
  fence_async();
  csync(c);
  wk.pend = PEND_X0;
}

// The heads on the CUDA cores, 8 columns a thread: the masked bf16
// cotangents of d (over d in X) and, fine pack, of t3 (over t3 in Y), to
// the tiles and the stash. A part's weights are loaded together, before its
// shared reads and stores. Head rows [row0, row0 + ROWS) over the packed
// head matrix's columns [col0, col0 + 8), masked by the activations at `at`,
// which the cotangents replace; returns them.
template <int ROWS>
__device__ __forceinline__ uint4 head_part(const bf16* wh, int W, const float* gr, int row0,
                                           int col0, uint32_t at) {
  uint4 w[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    w[k] = __ldg(reinterpret_cast<const uint4*>(wh + (size_t)(row0 + k) * W + col0));
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const float gk = gr[row0 + k];
    const uint32_t wp[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] += gk * bf_lo(wp[e]);
      v[2 * e + 1] += gk * bf_hi(wp[e]);
    }
  }
  const uint4 av = lds16(at);
  const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
  uint32_t op[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    op[e] = bf_pack(bf_lo(ap[e]) > 0.f ? v[2 * e] : 0.f, bf_hi(ap[e]) > 0.f ? v[2 * e + 1] : 0.f);
  const uint4 ov = make_uint4(op[0], op[1], op[2], op[3]);
  sts16(at, ov);
  return ov;
}

__device__ __forceinline__ void heads(const StashArgs& a, int c, int p0) {
  // (locals: each shared-memory asm below is a compiler barrier to memory)
  const int W = a.dm.W, half = W / 2, nch = half / 8, D = a.dm.D;
  const bool live = p0 < a.N * a.S;
  const float* g16 = g16_of(c);
  const uint32_t X = tile_of(c, T_X), Y = tile_of(c, T_Y);
  const bf16* wh = a.wts + blk.w_heads;
  bf16* sd = region(a, R_GDT(D), p0);
  bf16* st = region(a, R_GT(D, 3), p0);
  for (int i = threadIdx.x % WGT; i < BTP * nch; i += WGT) {
    const int r = i / nch, j0 = 8 * (i % nch);
    const float* gr = g16 + r * G_RAW;
    // rgb over d, then the transient rows over t3
    const uint4 gd = head_part<3>(wh, W, gr, 0, j0, tile_at(X, r, j0));
    if (live) *reinterpret_cast<uint4*>(sd + (size_t)r * (a.stat ? half : W) + j0) = gd;
    if (!a.stat) {
      const uint4 gt = head_part<N_RAW - 4>(wh, W, gr, 4, half + j0, tile_at(Y, r, j0));
      if (live) *reinterpret_cast<uint4*>(st + (size_t)r * half + j0) = gt;
    }
  }
}

template <int WP>
__global__ void __launch_bounds__(StashGeo<WP>::THREADS, 1)
bwd_stash_kernel(const __grid_constant__ StashArgs a) {
  typedef StashGeo<WP> G;
  extern __shared__ unsigned char smem_raw[];
  const int tiles = (a.N * a.S + BTP * a.ncw - 1) / (BTP * a.ncw);
  if (threadIdx.x == 0) {
    blk.base = (smem_u32(smem_raw) + ALIGN - 1) / ALIGN * ALIGN;
    blk.L = stash_layout(a.dm.K0, a.dm.W, a.stat, a.ncw, a.stages, WP);
    blk.nops = build_ops(a.dm, a.stat, blk.ops, &blk.nfwd);
    blk.w_heads = (int)offsets(a.dm, a.stat).w_heads;
    const uint32_t bars = blk.base + blk.L.bars;
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (a.stages + s), a.ncw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WGT) {
    // the producer warpgroup: thread 0 streams the weight panels, in the
    // order of the consumers' walk, one 64 x 64 box per 64 outputs
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const uint32_t bars = blk.base + blk.L.bars, ring = blk.base + blk.L.ring;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int o = 0; o < blk.nops; ++o) {
          const Op& op = blk.ops[o];
          const int nb = (op.n + 63) / 64;
          for (int sg = 0; sg < op.nseg; ++sg)
            for (int k0 = 0; k0 < op.k[sg]; k0 += 64) {
              mbar_wait(bars + 8 * (a.stages + stage), phase ^ 1);
              mbar_expect_tx(bars + 8 * stage, nb * PBYTES);
              const uint32_t dst = ring + stage * blk.L.stage_bytes;
              for (int b = 0; b < nb; ++b)
                tma_load(dst + b * PBYTES, &a.maps.m[op.map[sg]], op.bwd ? 64 * b : k0,
                         op.bwd ? k0 : 64 * b, bars + 8 * stage);
              if (++stage == a.stages) {
                stage = 0;
                phase ^= 1;
              }
            }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS));
  const int c = threadIdx.x / WGT - 1;
  Walk wk{0, 0u, -1};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = (tile * a.ncw + c) * BTP;
    tile_inputs(a, c, p0, wk);
    for (int o = 0; o < blk.nfwd; ++o) layer<WP, 0>(a, c, p0, o, wk);
    flush(a, c, p0, wk);
    csync(c);
    heads(a, c, p0);
    fence_async();
    csync(c);
    for (int o = blk.nfwd; o < blk.nops; ++o) layer<WP, 1>(a, c, p0, o, wk);
    flush(a, c, p0, wk);
  }
}

// Consumers a block and ring stages for a sweep, then the launch.
template <int WP>
int launch_stash(StashArgs& a, cudaStream_t stream) {
  typedef StashGeo<WP> G;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles64 = (a.N * a.S + BTP - 1) / BTP;
  const int ncw = consumers_for(tiles64, sms, G::NCW);
  int stages = 0;
  for (int st = MAX_STAGES; st >= 2 && !stages; --st)
    if (stash_layout(a.dm.K0, a.dm.W, a.stat, ncw, st, WP).total <= DYN_LIMIT) stages = st;
  if (!stages) return (int)cudaErrorInvalidValue;
  a.ncw = ncw;
  a.stages = stages;
  const int smem = stash_layout(a.dm.K0, a.dm.W, a.stat, ncw, stages, WP).total;
  e = cudaFuncSetAttribute(bwd_stash_kernel<WP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (tiles64 + ncw - 1) / ncw;
  bwd_stash_kernel<WP><<<blocks < sms ? blocks : sms, (ncw + 1) * WGT, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
// at most 256), the skip and the 16-byte alignment of the packed weights
// (the tensor maps' base addresses).
extern "C" int dfn_raw_bwd_stash(const float* ro, const float* rd, const float* z,
                                 const float* dpt, int N, int S, const void* wts,
                                 const float* bias, const float* freqs, int D, int W,
                                 int skip, int F, int stat, const float* g, void* stash,
                                 const long long* reg_off, const int* reg_width,
                                 int n_regions, void* stream) {
  // the kernel counts points in int, up to a spare block's past the sweep
  if (n_regions != 2 * D + 10 || n_regions > MAX_REGIONS || W < 32 || W > 256 || W % 32 ||
      reinterpret_cast<uintptr_t>(wts) % 16 || (long long)N * S > (1LL << 31) - 1024)
    return (int)cudaErrorInvalidValue;
  StashArgs a;
  a.dm = Dims{D, W, skip, F, pe_cols(F), BTP};
  for (int i = 0; i < n_regions; ++i) {
    a.rg.off[i] = reg_off[i];
    a.rg.width[i] = reg_width[i];
  }
  a.ro = ro;
  a.rd = rd;
  a.z = z;
  a.dpt = dpt;
  a.g = g;
  a.bias = bias;
  a.freqs = freqs;
  a.wts = (const bf16*)wts;
  a.stash = (bf16*)stash;
  a.N = N;
  a.S = S;
  a.stat = stat;
  // one tensor map per weight matrix, in packed order (build_ops' map indices)
  const int half = W / 2, Wd = stat ? half : W;
  int m = 0;
  bool ok = true;
  auto add = [&](size_t off, int rows, int cols) {
    ok = ok && tensor_map<bf16>(&a.maps.m[m++], a.wts + off, rows, cols, 64);
  };
  add(0, W, a.dm.K0);
  for (int i = 1; i < D; ++i) {
    const size_t off = trunk_off(a.dm, i);
    if (i == skip) {
      add(off, W, a.dm.K0);
      add(off + (size_t)W * a.dm.K0, W, W);
    } else {
      add(off, W, W);
    }
  }
  const Offsets of = offsets(a.dm, stat);
  add(of.w_dt, Wd, W);
  if (!stat)
    for (int q = 0; q < 3; ++q) add(of.w_tr + (size_t)q * half * half, half, half);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return W <= 128 ? launch_stash<128>(a, st) : launch_stash<256>(a, st);
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
