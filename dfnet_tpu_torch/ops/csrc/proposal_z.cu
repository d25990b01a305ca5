// proposal_z_rows: the mono path's sampler. Proposal sigma sweep over a
// uniform z grid -> softplus -> composite weights -> blended-CDF inverse
// -> SORTED fine z samples.
//
// Replaces dfnet_tpu/ops/nerf_kernels.py::proposal_z_rows (Pallas kernel
// _sample_kernel_t). Per ray, with S uniform samples z_s = near (1 - t) +
// far t, t = s / (S - 1), and step = (far - near) / (S - 1):
//   sigma_s = softplus(proposal MLP at o + d z_s)
//   w_s     = alpha_s T_s, alpha_s = 1 - exp(-step sigma_s) (1e2 on the
//             last sample, which the CDF never reads), T_s = prod_{k<s}
//             (1 - alpha_k)
//   mass_j  = w_j + 1e-5 (1 <= j <= S-2); cdf_w[j] = sum_{k<=j} mass_k /
//             sum_k mass_k
//   c_j     = (1 - lam) cdf_w[j] + lam j / (S-2) on the S-1 bin edges
//             zmid_j = near + (j + 1/2) step (cdf_w[0] = 0)
//   z_i     = piecewise-linear inverse of c at u_i = i / (S_f - 1): below
//             = the last c_j <= u, above = the first c_j > u (c_{S-2} at
//             zmid_{S-2} when there is none), a gap under 1e-5 counts as 1.
// Output: (N, S_f) float32, ray-major, sorted by construction (c is
// strictly increasing). render/fast.py::sample_pdf_blend over the same
// weights is the reference (nerf_kernels.py::proposal_z_plain).
//
// Bound on the card: operations. The proposal MLP (D=2, W=64, F=4) is
// ~1.2e4 bf16 flop a point against 24 B of rays a ray in and 4 S_f B a
// ray out; the inverse is S_f x (S-1) compares a ray in the reference's
// linear form. At the mono shape (N=16384, S=64, S_f=128) that bound is
// 0.0125 ms, and like coarse_sigma_t on the same net the kernel is bound
// by latency: two short layers a tile are a chain of panel copies and
// barriers, not tensor-core work.
//
// Design. The first version ran nerf_mlp.cuh's generic layer code (every
// WMMA B fragment read from L2 once a 16-row m-tile) with a CUDA-core
// sigma head, one ray a 64-point block, and one thread a ray for the
// serial transmittance and CDF while 255 waited (0.762 ms). Here:
//   - the sweep is coarse_sigma_t's (sweep.cuh::sigma_sweep: panel layers,
//     one sincosf a frequency and axis, the sigma head as one WMMA
//     fragment a 16-point m-tile), NJ = 1 at W <= 64 with three blocks an
//     SM, as coarse_sigma_t runs the proposal net (measured: two blocks
//     an SM without ptxas' 32 bytes of spills are 20% slower);
//   - a block owns R whole rays (the wrapper's proposal_z_geometry: R S <=
//     256, the fewest tile rows a ray, then the most rays, so R = 4 at
//     S = 64, measured 13-15% faster than R = 1; the entry point checks
//     it) and runs their R S points through ceil(R S / 64) sub-tiles of 64
//     rows in turn, the dead rows of the last masked. Each sub-tile leaves
//     its points' softplus(sigma) in a per-block buffer of R S floats;
//   - the weights and the CDF are parallel: one warp a ray (the warps loop
//     over the block's rays), each lane over a contiguous run of
//     ceil(S / 32) samples. An exclusive multiplicative warp scan
//     (__shfl_up_sync) of the runs' (1 - alpha) products gives each lane
//     its entering transmittance; the lane writes its masses over its own
//     sigma slots; an inclusive additive warp scan of the runs' mass sums
//     gives the total and each run's offset; the lane writes its edges
//     c_j over its mass slots (edge j in slot j);
//   - the inverse: the block's threads take its R S_f outputs (writes
//     coalesced along a ray) and binary-search their ray's edges.

#include "sweep.cuh"

using namespace dfn;

namespace {

constexpr int MAX_BLOCK_POINTS = 256;   // R S when a block holds more than one ray
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float softplusf_(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

// Shared bytes a block: the sweep's, then one float a point of its R S.
__host__ __device__ inline size_t sampler_smem(int K0, int W, int RS) {
  return fwd_layout(K0, W).total + align128((size_t)RS * sizeof(float));
}

// One warp's ray: c holds the ray's S softplus(sigma) on entry and its
// S - 1 edges c_0 .. c_{S-2} on return (slot S-1 unused).
__device__ inline void ray_edges(float* c, int S, float step, float lam, float inv_span) {
  const int lane = threadIdx.x % 32;
  const int run = (S + 31) / 32;
  const int s0 = min(S, lane * run), s1 = min(S, s0 + run);
  // the run's product of (1 - alpha) over samples 0 .. S-2, then its
  // exclusive scan over the lanes: the run's entering transmittance
  float T = 1.f;
  for (int s = s0; s < min(s1, S - 1); ++s) T *= expf(-step * c[s]);
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, T, o);
    if (lane >= o) T *= u;
  }
  T = __shfl_up_sync(FULL, T, 1);
  if (lane == 0) T = 1.f;
  // masses w_s + 1e-5 over s in [1, S-2], each over its own sigma slot
  float m_run = 0.f;
  for (int s = s0; s < min(s1, S - 1); ++s) {
    const float keep = expf(-step * c[s]);
    if (s >= 1) {
      const float m = (1.f - keep) * T + 1e-5f;
      c[s] = m;
      m_run += m;
    }
    T *= keep;
  }
  // inclusive scan of the runs' sums: lane 31 holds the total
  float acc = m_run;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, acc, o);
    if (lane >= o) acc += u;
  }
  const float tot = __shfl_sync(FULL, acc, 31);
  acc -= m_run;
  for (int s = s0; s < min(s1, S - 1); ++s) {
    if (s >= 1) acc += c[s];
    c[s] = s == 0 ? 0.f : (1.f - lam) * (acc / tot) + lam * ((float)s * inv_span);
  }
}

// NJ: output fragments a warp holds in the sweep (1 at W <= 64, 2 at
// W <= 128, 4 at W <= 256); blocks an SM as coarse_sigma_t's.
template <int NJ>
__global__ void __launch_bounds__(NTHREADS, NJ == 1 ? 3 : (NJ <= 2 ? 2 : 1))
proposal_z_kernel(const float* __restrict__ ro, const float* __restrict__ rd, int N,
                  int S, int S_f, int R, float near, float far, float inv_s1,
                  float inv_sf1, float step, float lam, const bf16* __restrict__ wts,
                  const float* __restrict__ bias, const float* __restrict__ freqs,
                  Dims dm, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(dm.K0, dm.W);
  const SweepTile t = carve_sweep(smem, L);
  float* c = reinterpret_cast<float*>(smem + L.total);     // (R S) sigma, then edges
  const int ray0 = blockIdx.x * R;
  const int rays = min(R, N - ray0);                        // live rays of the block
  const int live = rays * S;                                // their points
  // after the trunk: w_sigma (W), b_sigma (1)
  stage_sigma_head(t.heads, wts + trunk_off(dm, dm.D), dm.W);
  const float b_sigma = bias[dm.D * dm.W];
  // the sub-tiles: block point i is row i % 64 of sub-tile i / 64
  for (int i0 = 0; i0 < live; i0 += TP) {
    for (int r = threadIdx.x; r < TP; r += blockDim.x) {
      const int i = i0 + r;
      const float tt = (float)(i % S) * inv_s1;
      t.tl.ray[r] = i < live ? ray0 + i / S : -1;
      t.tl.rz[r] = i < live ? near * (1.f - tt) + far * tt : 0.f;
    }
    __syncthreads();
    sigma_sweep<NJ>(t, dm, ro, rd, wts, bias, freqs);
    for (int r = threadIdx.x; r < TP; r += blockDim.x)
      if (i0 + r < live) c[i0 + r] = softplusf_(t.hout[r * HEAD_LD] + b_sigma);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const float inv_span = 1.f / (float)(S - 2);
  for (int lr = warp; lr < rays; lr += NWARPS) ray_edges(c + lr * S, S, step, lam, inv_span);
  __syncthreads();

  for (int idx = threadIdx.x; idx < rays * S_f; idx += blockDim.x) {
    const int lr = idx / S_f, i = idx % S_f;
    const float* e = c + lr * S;
    const float u = (float)i * inv_sf1;
    // a = number of edges with c_j <= u (c_0 = 0 <= u, so a >= 1)
    int a = 0, hi = S - 1;
    while (a < hi) {
      const int m = (a + hi) >> 1;
      if (e[m] <= u) a = m + 1; else hi = m;
    }
    const int jb = a - 1, ja = a < S - 1 ? a : S - 2;
    const float below = e[jb], above = e[ja];
    const float zb = near + ((float)jb + 0.5f) * step;
    const float za = near + ((float)ja + 0.5f) * step;
    float denom = above - below;
    if (denom < 1e-5f) denom = 1.f;
    out[(size_t)(ray0 + lr) * S_f + i] = zb + (u - below) / denom * (za - zb);
  }
}

template <int NJ>
int launch(const float* ro, const float* rd, int N, int S, int S_f, int R, float near,
           float far, float inv_s1, float inv_sf1, float step, float lam, const bf16* wts,
           const float* bias, const float* freqs, Dims dm, float* out, cudaStream_t stream) {
  dm.TP = TP;
  const size_t smem = sampler_smem(dm.K0, dm.W, R * S);
  cudaError_t e = cudaFuncSetAttribute(proposal_z_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((N + R - 1) / R);
  proposal_z_kernel<NJ><<<grid, NTHREADS, smem, stream>>>(
      ro, rd, N, S, S_f, R, near, far, inv_s1, inv_sf1, step, lam, wts, bias, freqs, dm, out);
  return (int)cudaGetLastError();
}

template <int NJ>
int occupancy(int W, int K0, int RS, int* blocks_per_sm, int* smem_bytes) {
  const size_t smem = sampler_smem(K0, W, RS);
  *smem_bytes = (int)smem;
  cudaError_t e = cudaFuncSetAttribute(proposal_z_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, proposal_z_kernel<NJ>,
                                                      NTHREADS, smem);
  return (int)e;
}

// The wrapper's geometry: W a multiple of 32, at most 256; S >= 3; R >= 1
// rays a block, R S <= MAX_BLOCK_POINTS unless R = 1.
bool valid(int W, int S, int R) {
  return W <= 256 && W % 32 == 0 && S >= 3 && R >= 1 && (R == 1 || R * S <= MAX_BLOCK_POINTS);
}

}  // namespace

// R: rays a block (ops/nerf_kernels.py::proposal_z_geometry).
extern "C" int dfn_proposal_z(const float* ro, const float* rd, int N, int S, int S_f,
                              float near, float far, float inv_s1, float inv_sf1,
                              float step, float lam, const void* wts, const float* bias,
                              const float* freqs, int D, int W, int skip, int F, int R,
                              float* out, void* stream) {
  if (!valid(W, S, R)) return (int)cudaErrorInvalidValue;
  const Dims dm{D, W, skip, F, pe_cols(F), 0};
  const bf16* w = (const bf16*)wts;
  cudaStream_t st = (cudaStream_t)stream;
  if (W > 128)
    return launch<4>(ro, rd, N, S, S_f, R, near, far, inv_s1, inv_sf1, step, lam, w, bias,
                     freqs, dm, out, st);
  if (W > 64)
    return launch<2>(ro, rd, N, S, S_f, R, near, far, inv_s1, inv_sf1, step, lam, w, bias,
                     freqs, dm, out, st);
  return launch<1>(ro, rd, N, S, S_f, R, near, far, inv_s1, inv_sf1, step, lam, w, bias,
                   freqs, dm, out, st);
}

// Blocks of the kernel a width runs that an SM holds, and its shared
// memory a block (bytes), at S samples a ray and R rays a block.
extern "C" int dfn_proposal_z_occupancy(int W, int F, int S, int R, int* blocks_per_sm,
                                        int* smem_bytes) {
  if (!valid(W, S, R)) return (int)cudaErrorInvalidValue;
  if (W > 128) return occupancy<4>(W, pe_cols(F), R * S, blocks_per_sm, smem_bytes);
  if (W > 64) return occupancy<2>(W, pe_cols(F), R * S, blocks_per_sm, smem_bytes);
  return occupancy<1>(W, pe_cols(F), R * S, blocks_per_sm, smem_bytes);
}
