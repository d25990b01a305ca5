"""proposal_z_rows' ray blocks and warp scans, and mlp_stack's warpgroup
index maps, on the CPU.

The kernels (dfnet_tpu_torch/ops/csrc/proposal_z.cu and mlp_stack.cu)
cannot run here, so what surrounds their arithmetic is checked in Python:

- proposal_z_rows' ray blocks: the wrapper's proposal_z_geometry gives R
  rays a block (the fewest tile rows a ray, then the most rays); the kernel runs block b's points i = 0 .. R*S-1 (its live
  rays only) as row i % 64 of sub-tile i // 64, point i being sample i % S
  of ray b*R + i // S. Every point of every ray must fall in exactly one
  block and sub-tile, no ray may cross a block, and the shared bytes the
  geometry implies must leave three blocks an SM at W <= 64 (two at
  W <= 128, one at W = 256), as coarse_sigma_t on the same net;
- proposal_z_rows' scans: one warp a ray, each lane over a contiguous run
  of ceil(S/32) samples; the runs' products of (1 - alpha) scanned across
  the 32 lanes (an exclusive Hillis-Steele scan), then the masses, the
  runs' sums scanned (inclusive), the edges and their binary-searched
  inverse. The same order, written here in float32 torch, must keep
  proposal_z_plain's z within TOL_Z, also where the transmittance
  underflows to zero within a ray;
- mlp_stack's maps: the wgmma accumulator's (thread, register) -> (row,
  column) of a 64-row tile, and (row, column) -> byte of the K-major tile
  under the 128-byte swizzle that TMA writes and the matrix descriptor
  reads. Both must be bijections onto the tile, and the kernel's in-place
  epilogue store (its own formula, mirrored) must put element (r, c) where
  the swizzle rule puts it.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.nerfw import NeRFWConfig, init_sigma_mlp
from dfnet_tpu_torch.ops import mlp_stack as ms
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.ops.tolerances import TOL_Z

LANES = 32
SM_SHARED_BYTES = 233472     # shared memory an H100 SM holds (228 KB)
BLOCK_RESERVED_BYTES = 1024  # shared memory the runtime keeps a block
NEAR, FAR = 0.5, 3.5


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("S", [16, 24, 32, 48, 64, 96, 128])
def test_proposal_z_ray_blocks(S, W):
    R, n_sub = nk.proposal_z_geometry(S)
    assert R >= 1 and (R == 1 or R * S <= nk.COMP_MAX_POINTS)
    assert n_sub == -(-R * S // nk.SWEEP_TILE)
    # the fewest tile rows a ray, then the most rays a block
    for r in range(1, max(1, nk.COMP_MAX_POINTS // S) + 1):
        rows = -(-r * S // nk.SWEEP_TILE) * nk.SWEEP_TILE
        assert rows * R > n_sub * nk.SWEEP_TILE * r or (
            rows * R == n_sub * nk.SWEEP_TILE * r and r <= R), (r, R)
    N = 3 * R + 1 if R > 1 else 5          # a last block with one ray
    seen = np.zeros((N, S), dtype=int)
    owner = np.full(N, -1)
    for block in range(-(-N // R)):
        live = min(R, N - block * R) * S
        i = np.arange(live)
        sub, ray, s = i // nk.SWEEP_TILE, block * R + i // S, i % S
        assert sub.max() < n_sub
        for r, k in zip(ray, s):
            seen[r, k] += 1
            assert owner[r] in (-1, block), f"ray {r} crosses blocks"
            owner[r] = block
    assert (seen == 1).all()
    smem = nk.proposal_z_smem_bytes(W, 4, S)
    assert smem - nk.sweep_smem_bytes(W, 4) >= R * S * 4
    blocks = 3 if W <= 64 else (2 if W <= 128 else 1)
    assert blocks * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES


def _scan(x, op):
    """Inclusive Hillis-Steele scan over the last (lane) axis, as the
    kernel's __shfl_up_sync loop: at offset o, lane l >= o takes op(x[l],
    x[l - o])."""
    o = 1
    while o < x.shape[-1]:
        x = torch.cat([x[..., :o], op(x[..., o:], x[..., :-o])], -1)
        o *= 2
    return x


def _proposal_z_lanes(sig, S_f, near, far, lam):
    """proposal_z_kernel's ray_edges and inverse over (N, S) softplus
    sigma, in float32 and in the kernel's order -> (N, S_f) z."""
    N, S = sig.shape
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    step, inv_sf1, inv_span = f32((far - near) / (S - 1)), f32(1.0 / (S_f - 1)), f32(1.0 / (S - 2))
    run = -(-S // LANES)
    keep = torch.exp(-step * sig)
    s_idx = torch.arange(LANES * run).reshape(LANES, run)
    inside = s_idx < S - 1                          # samples 0 .. S-2
    keep = Fn.pad(keep, (0, LANES * run - S), value=1.0).reshape(N, LANES, run)
    T = torch.ones(N, LANES)
    for k in range(run):
        T = torch.where(inside[:, k], T * keep[..., k], T)
    T = _scan(T, torch.mul)
    T = torch.cat([torch.ones(N, 1), T[:, :-1]], 1)
    m = torch.zeros(N, LANES, run)
    m_run = torch.zeros(N, LANES)
    for k in range(run):
        mass = (s_idx[:, k] >= 1) & inside[:, k]
        mk = (1.0 - keep[..., k]) * T + 1e-5
        m[..., k] = torch.where(mass, mk, torch.zeros_like(mk))
        m_run = torch.where(mass, m_run + mk, m_run)
        T = torch.where(inside[:, k], T * keep[..., k], T)
    acc = _scan(m_run, torch.add)
    tot = acc[:, -1:]
    acc = acc - m_run
    c = torch.zeros(N, LANES, run)
    for k in range(run):
        s = s_idx[:, k]
        acc = torch.where(s >= 1, acc + m[..., k], acc)
        ck = (1.0 - lam) * (acc / tot) + lam * (s.float() * inv_span)
        c[..., k] = torch.where(s == 0, torch.zeros_like(ck), ck)
    c = c.reshape(N, LANES * run)[:, :S - 1].contiguous()   # the S-1 edges
    u = torch.arange(S_f, dtype=torch.float32) * inv_sf1
    a = torch.searchsorted(c, u.expand(N, S_f).contiguous(), right=True)  # edges <= u
    jb, ja = a - 1, torch.clamp(a, max=S - 2)
    below, above = c.gather(1, jb), c.gather(1, ja)
    zb = near + (jb.float() + 0.5) * step
    za = near + (ja.float() + 0.5) * step
    denom = above - below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return zb + (u - below) / denom * (za - zb)


@pytest.mark.parametrize("S,S_f", [(64, 128), (32, 96), (48, 128), (96, 160), (24, 40)])
def test_proposal_z_lane_order_keeps_plain_values(S, S_f):
    rng = np.random.default_rng(S + S_f)
    N = 48
    # a third of the rays thin, a third dense enough that the
    # transmittance underflows float32 within the ray, a third mixed
    sig = rng.exponential(1.0, (N, S)).astype(np.float32)
    sig[:N // 3] *= 0.05
    sig[N // 3:2 * N // 3] = rng.uniform(200.0, 2000.0, (N // 3, S))
    sig[2 * N // 3:, S // 2:] *= 50.0
    sig = torch.tensor(sig)
    lam = S / S_f
    want = nk.proposal_z_from_sigma(sig, S_f, NEAR, FAR, lam)
    got = _proposal_z_lanes(sig, S_f, NEAR, FAR, lam)
    # the dense rays' transmittance does underflow
    step = (FAR - NEAR) / (S - 1)
    assert (torch.exp(-step * sig[N // 3:2 * N // 3, :-1]).prod(-1) == 0).all()
    assert got.shape == want.shape == (N, S_f)
    torch.testing.assert_close(got, want, atol=TOL_Z, rtol=0)
    assert (got[:, 1:] >= got[:, :-1]).all()


def test_proposal_z_lane_order_on_the_proposal_net():
    """The same order after the plain sweep of a seeded proposal net (D=2,
    W=64, F=4) at the mono path's S=64, S_f=128: within TOL_Z of
    proposal_z_plain."""
    cfg = NeRFWConfig(D=2, W=64, skips=(), in_xyz=27)
    params = init_sigma_mlp(torch.Generator().manual_seed(3), cfg, "cpu")
    emb = get_embedder(4)
    packed = nk.pack_coarse_t(params, cfg, emb)
    spec = nk.spec_of(cfg, emb, fine=False)
    rng = np.random.default_rng(4)
    ro = torch.tensor((rng.normal(size=(40, 3)) * 0.3).astype(np.float32))
    rd = rng.normal(size=(40, 3)).astype(np.float32)
    rd = torch.tensor(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    S, S_f, lam = 64, 128, 0.5
    want = nk.proposal_z_plain(packed, ro, rd, spec, S, S_f, NEAR, FAR, lam)
    sig = Fn.softplus(nk.coarse_sigma_plain(packed, ro, rd, spec, S, NEAR, FAR))
    torch.testing.assert_close(_proposal_z_lanes(sig, S_f, NEAR, FAR, lam), want,
                               atol=TOL_Z, rtol=0)


# ---------------------------------------------------------------------------
# mlp_stack: the warpgroup maps
# ---------------------------------------------------------------------------

def _acc_map(W):
    """(128 threads, W/2 registers, 2) -> (row, column) of the wgmma
    accumulator of an m64nW tile: thread t = 32 warp + lane, register i
    holds row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
    2 (lane % 4) + i % 2 (the same for f32 and s32 sums)."""
    t = np.arange(128)[:, None]
    i = np.arange(W // 2)[None, :]
    warp, lane = t // 32, t % 32
    row = 16 * warp + lane // 4 + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return np.stack(np.broadcast_arrays(row, col), -1)


def _swizzle_byte(r, c, esize):
    """Byte of element (r, c) in a 64-row K-major tile under the 128-byte
    swizzle: 128-byte column panels of 64 rows (8 KB each), row r at 128 r,
    its 16-byte chunk k at chunk k ^ (r % 8) (what TMA's
    CU_TENSOR_MAP_SWIZZLE_128B writes and a layout-1 matrix descriptor
    with 1024-byte 8-row strides reads)."""
    b = c * esize
    return (b // 128) * 64 * 128 + r * 128 + (((b % 128) // 16) ^ (r % 8)) * 16 + b % 16


def _epilogue_byte(t, i, esize):
    """The kernel's in-place epilogue store: the byte it writes register i
    of thread t to (mlp_stack.cu, store_pair's address, mirrored)."""
    warp, lane = t // 32, t % 32
    j, half, k = i // 4, (i // 2) % 2, i % 2
    r = 16 * warp + lane // 4 + 8 * half
    if esize == 2:
        panel, chunk, within = j // 8, j % 8, (lane % 4) * 4 + 2 * k
    else:
        panel, chunk, within = j // 16, (j // 2) % 8, (j % 2) * 8 + (lane % 4) * 2 + k
    return panel * 8192 + r * 128 + (chunk ^ (r % 8)) * 16 + within


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("W", [128, 256])
def test_mlp_stack_maps_are_bijections(dtype, W):
    esize = 2 if dtype == "bf16" else 1
    rc = _acc_map(W).reshape(-1, 2)
    flat = rc[:, 0] * W + rc[:, 1]
    assert rc[:, 0].min() == 0 and rc[:, 0].max() == 63 and rc[:, 1].max() == W - 1
    assert np.array_equal(np.sort(flat), np.arange(64 * W))
    r, c = np.meshgrid(np.arange(64), np.arange(W), indexing="ij")
    byte = _swizzle_byte(r, c, esize)
    # each element's bytes: esize consecutive bytes from its first
    bytes_all = (byte[..., None] + np.arange(esize)).ravel()
    assert np.array_equal(np.sort(bytes_all), np.arange(64 * W * esize))
    assert byte.max() < ms.a_tile_bytes(dtype, W)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("W", [128, 256])
def test_mlp_stack_epilogue_store_follows_the_swizzle(dtype, W):
    esize = 2 if dtype == "bf16" else 1
    rc = _acc_map(W)
    t, i = np.meshgrid(np.arange(128), np.arange(W // 2), indexing="ij")
    got = _epilogue_byte(t, i, esize)
    want = _swizzle_byte(rc[..., 0], rc[..., 1], esize)
    assert np.array_equal(got, want)
    # a warp's store of one register pair touches 32 distinct banks (bf16)
    # or 16 distinct 4-byte words in 16 banks (int8): no bank conflict
    for j in range(W // 8):
        words = got[:32, 4 * j] // 4
        assert len(np.unique(words % 32)) == len(np.unique(words))


def test_mlp_stack_output_columns_are_the_first_registers():
    """The kernel writes the last layer's first 8 columns straight from
    registers 0..3 of each thread: they hold rows 0..63 x columns 0..7,
    each once."""
    rc = _acc_map(128)[:, :4].reshape(-1, 2)
    assert rc[:, 1].max() == ms.N_OUT - 1
    assert np.array_equal(np.sort(rc[:, 0] * ms.N_OUT + rc[:, 1]), np.arange(64 * ms.N_OUT))
