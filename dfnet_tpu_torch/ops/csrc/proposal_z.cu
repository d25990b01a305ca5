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
//   mass_j  = w_{j+1} + 1e-5 (j < S-2), normalised; cdf_w its inclusive
//             prefix sum
//   c_j     = (1 - lam) cdf_w[j-1] + lam j / (S-2) on the S-1 bin edges
//             zmid_j = near + (j + 1/2) step (cdf_w[-1] = 0)
//   z_i     = piecewise-linear inverse of c at u_i = i / (S_f - 1): below
//             = the last c_j <= u, above = the first c_j > u (c_{S-2} at
//             zmid_{S-2} when there is none), a gap under 1e-5 counts as 1.
// Output: (N, S_f) float32, ray-major, sorted by construction (c is
// strictly increasing). render/fast.py::sample_pdf_blend over the same
// weights is the reference (nerf_kernels.py::proposal_z_plain).
//
// Layout: a block owns R = max(1, 64 / S) whole rays (TP = R S points,
// rounded up to 16), so the transmittance scan and the CDF inverse never
// cross blocks. The sweep is coarse_sigma's (nerf_mlp.cuh: PE, trunk,
// sigma head); then one thread per ray scans the weights and writes the
// S-1 edges to shared memory, and one thread per (ray, output sample)
// binary-searches them. Ragged N is masked in-kernel.
//
// Bound on the card: operations. The proposal MLP (D=2, W=64, F=4) is
// ~1.2e4 bf16 flop per point; the inverse is S_f x (S-1) compares a ray
// on CUDA cores in the reference's linear form; it writes 4 S_f B a ray.

#include "nerf_mlp.cuh"

using namespace dfn;

__device__ inline float softplusf_(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

__global__ void __launch_bounds__(NTHREADS)
proposal_z_kernel(const float* __restrict__ ro, const float* __restrict__ rd, int N,
                  int S, int S_f, int R, float near, float far, float inv_s1,
                  float inv_sf1, float step, float lam, const bf16* __restrict__ wts,
                  const float* __restrict__ bias, const float* __restrict__ freqs,
                  Dims dm, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout L = smem_layout(dm.TP, dm.K0, dm.W);
  const Tile t = carve(smem, L);
  const int ray0 = blockIdx.x * R;
  for (int r = threadIdx.x; r < dm.TP; r += blockDim.x) {
    const int lr = r / S, ray = ray0 + lr;
    const bool live = lr < R && ray < N;
    const float tt = (float)(r % S) * inv_s1;
    t.ray[r] = live ? ray : -1;
    t.rz[r] = live ? near * (1.f - tt) + far * tt : 0.f;
  }
  __syncthreads();
  build_pe(dm, t, ro, rd, freqs);
  const bf16* w = wts;
  const float* b = bias;
  const bf16* h = run_trunk(dm, t, w, b);
  // after the trunk: w -> w_sigma (W), b -> b_sigma (1)
  const int ldh = dm.W + PAD;
  float* sig = t.raw;                 // (TP) sigma after softplus
  float* cdf = t.raw + dm.TP;         // (R, S-1) blended CDF on the bin edges
  for (int r = threadIdx.x; r < dm.TP; r += blockDim.x)
    sig[r] = softplusf_(dot_bf16(h + r * ldh, w, dm.W) + b[0]);
  __syncthreads();

  const float inv_span = 1.f / (float)(S - 2);
  for (int lr = threadIdx.x; lr < R; lr += blockDim.x) {
    if (ray0 + lr >= N) continue;
    const float* sg = sig + lr * S;
    float* c = cdf + lr * (S - 1);
    // masses w_1 .. w_{S-2} (+1e-5) into c[1..S-2], and their total
    float T = 1.f, tot = 0.f;
    for (int s = 0; s < S - 1; ++s) {
      const float alpha = 1.f - expf(-step * sg[s]);
      if (s >= 1) {
        const float m = alpha * T + 1e-5f;
        c[s] = m;
        tot += m;
      }
      T *= 1.f - alpha;
    }
    float acc = 0.f;
    c[0] = 0.f;
    for (int j = 1; j < S - 1; ++j) {
      acc += c[j] / tot;
      c[j] = (1.f - lam) * acc + lam * ((float)j * inv_span);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * S_f; idx += blockDim.x) {
    const int lr = idx / S_f, i = idx % S_f, ray = ray0 + lr;
    if (ray >= N) continue;
    const float* c = cdf + lr * (S - 1);
    const float u = (float)i * inv_sf1;
    // a = number of edges with c_j <= u (c_0 = 0 <= u, so a >= 1)
    int a = 0, hi = S - 1;
    while (a < hi) {
      const int m = (a + hi) >> 1;
      if (c[m] <= u) a = m + 1; else hi = m;
    }
    const int jb = a - 1, ja = a < S - 1 ? a : S - 2;
    const float below = c[jb], above = c[ja];
    const float zb = near + ((float)jb + 0.5f) * step;
    const float za = near + ((float)ja + 0.5f) * step;
    float denom = above - below;
    if (denom < 1e-5f) denom = 1.f;
    out[(size_t)ray * S_f + i] = zb + (u - below) / denom * (za - zb);
  }
}

extern "C" int dfn_proposal_z(const float* ro, const float* rd, int N, int S, int S_f,
                              float near, float far, float inv_s1, float inv_sf1,
                              float step, float lam, const void* wts, const float* bias,
                              const float* freqs, int D, int W, int skip, int F,
                              float* out, void* stream) {
  const int R = S >= 64 ? 1 : 64 / S;
  Dims dm{D, W, skip, F, pe_cols(F), round16(R * S)};
  const SmemLayout L = smem_layout(dm.TP, dm.K0, dm.W);
  cudaError_t e = cudaFuncSetAttribute(proposal_z_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int grid = (N + R - 1) / R;
  proposal_z_kernel<<<grid, NTHREADS, L.total, (cudaStream_t)stream>>>(
      ro, rd, N, S, S_f, R, near, far, inv_s1, inv_sf1, step, lam, (const bf16*)wts,
      bias, freqs, dm, out);
  return (int)cudaGetLastError();
}
