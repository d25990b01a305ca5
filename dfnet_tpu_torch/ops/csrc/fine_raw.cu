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
// 989 TFLOP/s bf16 peak, ~0.09 ms of memory traffic. The whole net (~0.32
// MB bf16 there, ~1 MB at W=256) does not fit in a block's shared memory,
// so every tile of points reads it from L2 again: a tile's operations per
// L2 byte are its points, and what binds a design short of the bound is
// how many points share each weight panel and how well the products hide
// the epilogues and the weight loads.
//
// Design (raw_bwd.cu's bwd_stash, the forward half of it; the version
// before ran each layer as WMMA 16x16x16 on fragments read from shared
// memory, its weights streamed through two cp.async panels with two
// __syncthreads() a panel, one 64-point tile a block, at ~8% of the bound):
//   - persistent blocks, at most one an SM: a producer warpgroup and ncw
//     consumer warpgroups, each consumer owning 64 points of the block's
//     64 ncw. ncw is at most 4 at W <= 128, 2 above (the 64 x W sums take
//     W/2 registers a thread); the launch takes fewer where the points
//     would leave SMs idle (launch: the fewest rounds of blocks, a block
//     costing its consumers plus one);
//   - the weights arrive by TMA in panels 64 deep and K-major (one 64 x 64
//     box per 64 outputs of an (out, in) matrix under the 128-byte
//     swizzle) into a ring of mbarrier-guarded stages, which one producer
//     thread keeps full across layers and tiles, walking the same table of
//     products (build_ops) as the consumers. Every consumer of the block
//     reads each panel;
//   - a consumer's activations stay in shared memory as wgmma's A operand
//     (K-major, 128-byte swizzle): x0 (K0 columns), X (W) and, fine pack,
//     Y (W/2, the transient chain). Every product is wgmma m64nNk16 at N =
//     the kernel's padded width (one accumulator shape a kernel), the sums
//     in registers, then an in-place epilogue: the bias, the per-ray dpt
//     row (dt layer) and max.NaN ReLU, rounded to bf16; then
//     fence.proxy.async and a named barrier of the consumer's 128 threads.
//     X holds h_i in place through the trunk, then [d | t0]; t1..t3 run in
//     Y. Nothing reaches global memory but the head outputs;
//   - the heads run on the CUDA cores, each as a pass over the tile the
//     product before it left (two threads a point, 16-byte reads of the
//     swizzled tile and of the weights, one shuffle): sigma after the last
//     trunk layer (over h, before the dt layer overwrites it), rgb after
//     the dt layer (over d), the transient rows after t3. At most 5 W
//     multiply-adds a point against ~8 W^2 on the tensor cores, and no
//     second accumulator shape; measured, they take 6-17% of the kernel's
//     time (most at W=128, against a variant without them); the head outputs park in a shared float
//     tile a consumer and leave, bias added, as each output row's run of
//     the tile's 64 consecutive points;
//   - setmaxnreg gives the producer 40 registers and the consumers the rest.
// The same PE (panel.cuh::build_pe_sincos' arithmetic), k order (skip
// layer: x0's products first), bias, dpt and ReLU as the WMMA sweep
// (sweep.cuh::fine_sweep, which fine_composite_t still runs) and bwd_stash,
// so the trunk, dt and transient activations are theirs bit for bit; only
// the heads' float32 sums run in another order. tests/test_torch_port_gpu.py
// holds bwd_stash's trunk activations to this kernel's and this kernel's
// rows to fine_composite_t's.
// Shared memory a block (raw_layout): ncw x (x0 + X + Y tiles, 8 KB per 64
// columns) + stages x (W padded to 128 or 256) x 128 B + ncw x 3.5 KB
// (head outputs, points, z, rays), and the product table (static). W=128
// fine: 4 x 32 KB + 5 stages of 16 KB; W=256 static: 2 x 40 KB + 4 stages
// of 32 KB; W=256 fine: 2 x 56 KB + 3 stages.
// The heads on the tensor cores, as the WMMA sweep ran them against a
// 16-row head matrix, would need a second accumulator shape or a product
// at the padded width for 9 outputs; not built. Measured and not kept
// (PERF.md, Findings): the heads summed inside the epilogues from the
// registers (the 64 x N sums stayed live through every epilogue: 1.1-1.3
// KB of spills, slower than the WMMA sweep at W=128); each head pass
// deferred into the next product, beside its first group of products
// (2-5% faster at most shapes in one call, slower at most in another, and
// spills at W <= 128); the pass's tile read by plain loads the compiler
// may batch (-2% to +5% by shape, spills at W <= 128).

#include "hopper.cuh"
#include "panel.cuh"

using namespace dfn;

namespace {

constexpr int RTP = 64;                  // points a consumer tile (wgmma's M)
constexpr int SMEM_LIMIT = 232448;       // shared bytes a block may have, static and dynamic
constexpr int ALIGN = 1024;              // the 128-byte swizzle repeats every 8 rows
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int MAX_MATS = 16 + 5;         // w0, D - 1 trunk layers (one of them wx, wh), dt, 3 tr
constexpr int MAX_OPS = 16 + 4;          // D trunk layers, dt, 3 tr
// a consumer's head outputs (float, N_RAW rows of 64 points), points, z, rays
constexpr int MISC_BYTES = RTP * (N_RAW + 3 + 1 + 1) * 4;
enum { T_X0, T_X, T_Y };                 // a consumer's activation tiles
enum { H_NONE, H_SIGMA, H_RGB, H_TRANS };   // the heads a product's outputs feed

struct Maps {
  CUtensorMap m[MAX_MATS];               // the weight matrices, in packed order
};

// One product of the walk (build_ops): out = epilogue(sum over the input
// segments of A_s . B_s), A_s columns [a_col, a_col + k) of a tile, B_s the
// (out, in) matrix `map` read K-major. n outputs land in columns [0, n) of
// out_tile; `head` names the heads that read them.
struct Op {
  int nseg, map[2], a_tile[2], a_col[2], k[2];
  int n, out_tile, bias, dpt, head;      // bias: offset (floats); dpt: add dpt[ray]
};

// The products of a tile in order; returns their count.
__device__ inline int build_ops(const Dims& dm, int stat, Op* ops) {
  const int W = dm.W, half = W / 2, D = dm.D, Wd = stat ? half : W;
  const Offsets of = offsets(dm, stat);
  const int m_dt = D + (dm.skip >= 1 ? 1 : 0), m_tr = m_dt + 1;
  int n = 0;
  auto add = [&](int map, int tile, int col, int k, int N, int out_tile, int bias) -> Op& {
    Op& o = ops[n++];
    o = Op{};
    o.nseg = 1;
    o.map[0] = map;
    o.a_tile[0] = tile;
    o.a_col[0] = col;
    o.k[0] = k;
    o.n = N;
    o.out_tile = out_tile;
    o.bias = bias;
    return o;
  };
  add(0, T_X0, 0, dm.K0, W, T_X, 0);
  for (int i = 1; i < D; ++i) {
    const int m = i + (dm.skip >= 1 && i > dm.skip ? 1 : 0);
    Op& o = i == dm.skip ? add(m, T_X0, 0, dm.K0, W, T_X, i * W)
                         : add(m, T_X, 0, W, W, T_X, i * W);
    if (i == dm.skip) {    // [x0 | h]: x0's products first, as panel_layer
      o.nseg = 2;
      o.map[1] = m + 1;
      o.a_tile[1] = T_X;
      o.a_col[1] = 0;
      o.k[1] = W;
    }
  }
  ops[n - 1].head = H_SIGMA;
  Op& dt = add(m_dt, T_X, 0, W, Wd, T_X, of.b_dt);
  dt.dpt = 1;
  dt.head = H_RGB;
  if (!stat) {
    for (int q = 0; q < 3; ++q)   // t1 over t0 (X's second half), t2, t3 in Y
      add(m_tr + q, q == 0 ? T_X : T_Y, q == 0 ? half : 0, half, half, T_Y, of.b_tr + q * half);
    ops[n - 1].head = H_TRANS;
  }
  return n;
}

// Byte offsets of the dynamic shared memory from its 1024-aligned base.
struct RawLayout {
  int kx, kw, ky;              // 64-column blocks of a consumer's x0, X and Y tiles
  int tile_bytes, stage_bytes, ring, misc, bars, total;
};

__host__ __device__ inline RawLayout raw_layout(int K0, int W, int stat, int ncw, int stages,
                                                int WP) {
  RawLayout L;
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
struct RawArgs {
  Maps maps;                   // the weight matrices, in packed order
  const float *ro, *rd, *z, *dpt, *bias, *freqs;
  const bf16* wts;
  float* out;
  Dims dm;
  int N, S, stat, ncw, stages;
};

// What the block's threads share, written once by thread 0: the walk's
// products and the geometry, read where used.
struct Block {
  Op ops[MAX_OPS];
  int nops, w_heads, b_heads;  // offsets of the head matrix and its bias
  uint32_t base;               // shared address of the 1024-aligned dynamic base
  RawLayout L;
};
__shared__ Block blk;
// dynamic shared bytes a block may ask for beside blk
constexpr int DYN_LIMIT = SMEM_LIMIT - (int)((sizeof(Block) + 127) / 128 * 128);

// The kernel of a padded width WP (128: W <= 128, 256: W <= 256).
template <int WP>
struct RawGeo {
  static constexpr int NCW = WP <= 128 ? 4 : 2;   // consumer warpgroups at most
  static constexpr int THREADS = (NCW + 1) * WGT;
  // registers a consumer thread gets: the block's share (the launch bound,
  // in steps of 8) less the producer's 40, over the consumers
  static constexpr int SHARE =
      ((65536 / THREADS / 8 * 8) * THREADS - PRODUCER_REGS * WGT) / (NCW * WGT) / 8 * 8;
  static constexpr int CONSUMER_REGS = SHARE > 232 ? 232 : SHARE;
};

// Consumer c's tiles, its head outputs (float, row k's 64 points at
// k * RTP), points, z and rays.
__device__ __forceinline__ uint32_t tile_of(int c, int id) {
  return blk.base + c * blk.L.tile_bytes +
         (id == T_X0 ? 0 : id == T_X ? blk.L.kx : blk.L.kx + blk.L.kw) * PBYTES;
}
__device__ __forceinline__ float* hout_of(int c) {
  return sptr<float>(blk.base + blk.L.misc + c * MISC_BYTES);
}
__device__ __forceinline__ float* pts_of(int c) { return hout_of(c) + RTP * N_RAW; }
__device__ __forceinline__ float* rz_of(int c) { return pts_of(c) + RTP * 3; }
__device__ __forceinline__ int* ray_of(int c) { return reinterpret_cast<int*>(rz_of(c) + RTP); }

// A consumer's place in the weight ring.
struct Walk {
  int stage;
  uint32_t phase;
};

// One 16-deep k-step: A columns [col, col + 16) of the tile at `at`, the
// k-step kk of the ring stage at pb.
template <int NP, int M>
__device__ __forceinline__ void mma_step(float (&d)[M], uint32_t at, int col, uint32_t pb, int kk,
                                         int scale) {
  const uint64_t a = desc_sw128(at + (col >> 6) * PBYTES + (col & 63) * 2);
  wgmma_bf16<NP, 0>(d, a, desc_sw128(pb + kk * 32), scale);
}

// Product o of the walk for consumer c. Every product runs at N = NP, the
// kernel's padded width: one accumulator shape a kernel, as ptxas
// serialises the products of a kernel that holds several. The sums of
// outputs past the product's n (whatever the ring stage holds there) are
// never read.
template <int NP>
__device__ __forceinline__ void layer(const RawArgs& a, int c, int o, Walk& wk) {
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
          mma_step<NP>(d, at, c0 + k0 + 16 * kk, pb, kk, !first || kk > 0);
      } else {
        for (int kk = 0; kk < (K - k0) / 16; ++kk)
          mma_step<NP>(d, at, c0 + k0 + 16 * kk, pb, kk, !first || kk > 0);
      }
      wgmma_commit();
      if (!first) {
        wgmma_wait<1>();                 // the previous panel's group is done
        fence_acc(d);
        if (t == 0) mbar_arrive(bars + 8 * (a.stages + prev));
      }
      first = 0;
      prev = wk.stage;
      if (++wk.stage == a.stages) {
        wk.stage = 0;
        wk.phase ^= 1;
      }
    }
  }
  // The epilogue's global reads go out before its stores: the bias of JC
  // 8-column groups at a time (all of them at NP = 256), the first beside
  // the last group of products; the dt layer's per-ray dpt SUB groups at a
  // time.
  constexpr int JC = NP <= 128 ? 4 : NP / 8, SUB = 4;
  const Op& op = blk.ops[o];
  const int row0 = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4), n = op.n;
  const int Wd = a.stat ? a.dm.W / 2 : a.dm.W;
  int ray[2];
  const float2* drow[2];              // the rows' dpt, this thread's columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ray[h] = op.dpt ? ray_of(c)[row0 + 8 * h] : -1;
    drow[h] = reinterpret_cast<const float2*>(a.dpt + (size_t)(ray[h] > 0 ? ray[h] : 0) * Wd + cq);
  }
  const float2* bp = reinterpret_cast<const float2*>(a.bias + op.bias + cq);
  float2 u[JC];
  auto fetch = [&](int q) {
#pragma unroll
    for (int jj = 0; jj < JC; ++jj)
      u[jj] = 8 * (q + jj) < n ? __ldg(bp + 4 * (q + jj)) : make_float2(0.f, 0.f);
  };
  fetch(0);
  wgmma_wait<0>();
  fence_acc(d);
  if (t == 0) mbar_arrive(bars + 8 * (a.stages + prev));
  csync(c);   // every warp's products have read the A tiles: the epilogue works in place

  // registers (4j + 2h, 4j + 2h + 1): row 16 warp + lane / 4 + 8 h,
  // columns 8 j + 2 (lane % 4) + {0, 1}
  // the swizzled byte offset of column 8 j + cq: xo[j % 8] plus 8 KB a
  // block of 64 columns, j / 8 of them (row r's 128-byte line at 128 r;
  // chunk k of it at k ^ (r % 8), and r % 8 is row0 % 8 for both h)
  uint32_t xo[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) xo[k] = ((k ^ (row0 & 7)) << 4);
  const uint32_t ob = tile_of(c, op.out_tile) + row0 * SWZ + cq * 2;
  float2 e[2][SUB];    // the dt layer's dpt
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
        for (int s = 0; s < SUB; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            e[h][s] = 8 * (j + s) < n && ray[h] >= 0 ? __ldg(drow[h] + 4 * (j + s))
                                                     : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // panel_layer's order: the bias, then the per-ray row
        float x0 = d[4 * j + 2 * h] + u[jj].x, x1 = d[4 * j + 2 * h + 1] + u[jj].y;
        if (ray[h] >= 0) {
          x0 += e[h][j % SUB].x;
          x1 += e[h][j % SUB].y;
        }
        sts_pair(ob + 8 * h * SWZ + xo[j % 8] + (j / 8) * PBYTES, relu_nan(x0), relu_nan(x1));
      }
    }
  }
  // the generic stores, visible to the next product's asynchronous reads
  // and to the heads
  fence_async();
  csync(c);
}

// Head rows [k0, k0 + ROWS) of consumer c's 64 points over columns [0, n)
// of the tile at `tile`, weights w (row k's at w + (k - k0) W): two threads
// a row, each over every other 8-column chunk (16-byte reads of the
// swizzled tile and of the weights), then one shuffle; row r's sum parks
// at hout[k * RTP + r].
template <int ROWS>
__device__ __forceinline__ void head_pass(int c, uint32_t tile, const bf16* w, int W, int n,
                                          int k0) {
  const int t = threadIdx.x % WGT, r = t / 2, part = t % 2;
  float s[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) s[k] = 0.f;
  for (int c8 = part; c8 < n / 8; c8 += 2) {
    uint4 wv[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      wv[k] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * W + 8 * c8));
    const uint4 av = lds16(tile_at(tile, r, 8 * c8));
    const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const uint32_t wp[4] = {wv[k].x, wv[k].y, wv[k].z, wv[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[k] = fmaf(bf_hi(ap[e]), bf_hi(wp[e]), fmaf(bf_lo(ap[e]), bf_lo(wp[e]), s[k]));
    }
  }
  float* ho = hout_of(c);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
    if (part == 0) ho[(k0 + k) * RTP + r] = s[k];
  }
}

// The heads product o's outputs feed (Op::head), on the CUDA cores: sigma
// over h (the last trunk layer, before the dt layer overwrites it), rgb
// over d (the dt layer), the transient rows over t3. The next product's
// epilogue, which may overwrite the tile, waits on a barrier these threads
// reach after.
__device__ __forceinline__ void heads(const RawArgs& a, int c, int head) {
  const int W = a.dm.W, half = W / 2;
  const bf16* wh = a.wts + blk.w_heads;
  if (head == H_SIGMA)
    head_pass<1>(c, tile_of(c, T_X), wh + 3 * W, W, W, 3);
  else if (head == H_RGB)
    head_pass<3>(c, tile_of(c, T_X), wh, W, half, 0);
  else if (head == H_TRANS)
    head_pass<N_RAW - 4>(c, tile_of(c, T_Y), wh + 4 * W + half, W, half, 4);
}

// The tile's rows, its points and x0 (panel.cuh::build_pe_sincos'
// arithmetic) in the x0 tile.
__device__ __forceinline__ void tile_inputs(const RawArgs& a, int c, long long p0) {
  const int t = threadIdx.x % WGT;
  const long long P = (long long)a.N * a.S;
  float* pts = pts_of(c);
  float* rz = rz_of(c);
  int* ray = ray_of(c);
  if (t < RTP) {
    const long long p = p0 + t;
    ray[t] = p < P ? (int)(p / a.S) : -1;
    rz[t] = p < P ? a.z[p] : 0.f;
  }
  csync(c);
  for (int i = t; i < RTP * 3; i += WGT) {
    const int r = i / 3, k = i % 3;
    const int ry = ray[r];
    const float zr = rz[r];
    pts[i] = ry >= 0 ? a.ro[(size_t)ry * 3 + k] + a.rd[(size_t)ry * 3 + k] * zr : 0.f;
  }
  csync(c);
  const uint32_t x0 = tile_of(c, T_X0);
  const int F = a.dm.F, live = 6 * F + 3, extra = 3 + a.dm.K0 - live;
  for (int i = t; i < RTP * F * 3; i += WGT) {
    const int r = i / (F * 3), k = (i / 3) % F, j = i % 3;
    float sn, cs;
    sincosf(a.freqs[k] * pts[r * 3 + j], &sn, &cs);
    sts_bf16(tile_at(x0, r, 3 + 6 * k + j), __float2bfloat16(sn));
    sts_bf16(tile_at(x0, r, 6 + 6 * k + j), __float2bfloat16(cs));
  }
  for (int i = t; i < RTP * extra; i += WGT) {
    const int r = i / extra, f = i % extra;
    sts_bf16(tile_at(x0, r, f < 3 ? f : live + f - 3),
             __float2bfloat16(f < 3 ? pts[r * 3 + f] : 0.f));
  }
  fence_async();
  csync(c);
}

// The tile's head outputs plus their bias, each output row as a run of the
// tile's consecutive points. A consumer whose 64 points start past the
// sweep's (a last block's spare) writes nothing.
__device__ __forceinline__ void write_out(const RawArgs& a, int c, long long p0) {
  const long long P = (long long)a.N * a.S;
  const int NR = a.stat ? N_STATIC : N_RAW;
  const float* ho = hout_of(c);
  const float* bh = a.bias + blk.b_heads;
  for (int i = threadIdx.x % WGT; i < NR * RTP; i += WGT) {
    const int k = i / RTP, r = i % RTP;
    if (p0 + r < P) a.out[(size_t)k * P + p0 + r] = ho[k * RTP + r] + __ldg(bh + k);
  }
}

template <int WP>
__global__ void __launch_bounds__(RawGeo<WP>::THREADS, 1)
fine_raw_kernel(const __grid_constant__ RawArgs a) {
  typedef RawGeo<WP> G;
  extern __shared__ unsigned char smem_raw[];
  const int tiles = (int)(((long long)a.N * a.S + RTP * a.ncw - 1) / (RTP * a.ncw));
  if (threadIdx.x == 0) {
    blk.base = (smem_u32(smem_raw) + ALIGN - 1) / ALIGN * ALIGN;
    blk.L = raw_layout(a.dm.K0, a.dm.W, a.stat, a.ncw, a.stages, WP);
    blk.nops = build_ops(a.dm, a.stat, blk.ops);
    const Offsets of = offsets(a.dm, a.stat);
    blk.w_heads = (int)of.w_heads;
    blk.b_heads = of.b_heads;
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
                tma_load(dst + b * PBYTES, &a.maps.m[op.map[sg]], k0, 64 * b, bars + 8 * stage);
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
  Walk wk{0, 0u};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = ((long long)tile * a.ncw + c) * RTP;
    tile_inputs(a, c, p0);
    for (int o = 0; o < blk.nops; ++o) {
      layer<WP>(a, c, o, wk);
      heads(a, c, blk.ops[o].head);
    }
    csync(c);   // the head outputs are complete
    write_out(a, c, p0);
  }
}

// The most ring stages that fit beside ncw consumers (0: none do).
int ring_stages(int K0, int W, int stat, int ncw, int WP) {
  for (int st = MAX_STAGES; st >= 2; --st)
    if (raw_layout(K0, W, stat, ncw, st, WP).total <= DYN_LIMIT) return st;
  return 0;
}

// Consumers a block and ring stages for a sweep, then the launch.
template <int WP>
int launch(RawArgs& a, cudaStream_t stream) {
  typedef RawGeo<WP> G;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles64 = ((long long)a.N * a.S + RTP - 1) / RTP;
  const int ncw = consumers_for(tiles64, sms, G::NCW);
  const int stages = ring_stages(a.dm.K0, a.dm.W, a.stat, ncw, WP);
  if (!stages) return (int)cudaErrorInvalidValue;
  a.ncw = ncw;
  a.stages = stages;
  const int smem = raw_layout(a.dm.K0, a.dm.W, a.stat, ncw, stages, WP).total;
  e = cudaFuncSetAttribute(fine_raw_kernel<WP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (tiles64 + ncw - 1) / ncw;
  fine_raw_kernel<WP><<<(unsigned)(blocks < sms ? blocks : sms), (ncw + 1) * WGT, smem,
                        stream>>>(a);
  return (int)cudaGetLastError();
}

// The fine pack's block at the most consumers: blocks an SM, shared bytes.
template <int WP>
int occupancy(int W, int K0, int* blocks_per_sm, int* smem_bytes) {
  typedef RawGeo<WP> G;
  const int stages = ring_stages(K0, W, 0, G::NCW, WP);
  if (!stages) return (int)cudaErrorInvalidValue;
  *smem_bytes = raw_layout(K0, W, 0, G::NCW, stages, WP).total;
  cudaError_t e = cudaFuncSetAttribute(fine_raw_kernel<WP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fine_raw_kernel<WP>,
                                                      G::THREADS, *smem_bytes);
  return (int)e;
}

}  // namespace

// W: a multiple of 32, at most 256; the packed weights 16-byte aligned (the
// tensor maps' base addresses). The wrapper checks both too.
extern "C" int dfn_fine_raw(const float* ro, const float* rd, const float* z,
                            const float* dpt, int N, int S, const void* wts,
                            const float* bias, const float* freqs, int D, int W,
                            int skip, int F, int stat, float* out, void* stream) {
  if (W < 32 || W > 256 || W % 32 || D < 1 || D > 16 ||
      reinterpret_cast<uintptr_t>(wts) % 16 || (long long)N * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  RawArgs a;
  a.dm = Dims{D, W, skip, F, pe_cols(F), RTP};
  a.ro = ro;
  a.rd = rd;
  a.z = z;
  a.dpt = dpt;
  a.bias = bias;
  a.freqs = freqs;
  a.wts = (const bf16*)wts;
  a.out = out;
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
  return W <= 128 ? launch<128>(a, st) : launch<256>(a, st);
}

// Blocks of the kernel a width runs that an SM holds, and its shared
// memory a block (bytes): the fine pack at the most consumer warpgroups,
// the block a large sweep takes.
extern "C" int dfn_fine_raw_occupancy(int W, int F, int* blocks_per_sm, int* smem_bytes) {
  if (W < 32 || W > 256 || W % 32) return (int)cudaErrorInvalidValue;
  return W <= 128 ? occupancy<128>(W, pe_cols(F), blocks_per_sm, smem_bytes)
                  : occupancy<256>(W, pe_cols(F), blocks_per_sm, smem_bytes);
}
