"""fine_composite_t's geometry and composite order, on the CPU.

The kernel (dfnet_tpu_torch/ops/csrc/fine_composite.cu) cannot run here,
so what surrounds its arithmetic is checked in Python:

- the ray blocks: the wrapper's fine_composite_geometry gives R rays a
  block; the kernel runs block b's points i = 0 .. R*S-1 (its live rays
  only) as row i % 64 of sub-tile i // 64, point i being sample i % S of
  ray b*R + i // S. Every point of every ray must fall in exactly one
  block and sub-tile, no ray may cross a block, dead rows may lie only in
  a block's last sub-tile, and the shared bytes the geometry implies must
  leave two blocks an SM at W <= 128 (one at W = 256);
- the composite order: the kernel takes each lane's run of samples,
  multiplies its (1 - alpha) terms, scans those products across the 32
  lanes (an exclusive Hillis-Steele scan), accumulates each run from its
  entering transmittance and sums the lanes by a butterfly. The same
  order, written here in torch, must keep _composite_plain's values within
  atol 1e-6 and rtol 1e-5 (float32 products and sums taken in another
  order), also where the transmittance underflows to zero.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.ops import nerf_kernels as nk

LANES = 32
SM_SHARED_BYTES = 233472     # shared memory an H100 SM holds (228 KB)
BLOCK_RESERVED_BYTES = 1024  # shared memory the runtime keeps a block


def _block_rows(N, S, R, block):
    """(sub-tiles, 64, 2): the (ray, sample) of each row of each sub-tile of
    a block, (-1, -1) for a dead row, as fine_composite_kernel maps them."""
    live = min(R, N - block * R) * S
    i = np.arange(-(-live // nk.SWEEP_TILE) * nk.SWEEP_TILE)
    rows = np.where((i < live)[:, None], np.stack([block * R + i // S, i % S], -1), -1)
    return rows.reshape(-1, nk.SWEEP_TILE, 2)


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("S", [24, 32, 40, 64, 100, 128, 192, 256])
def test_fine_composite_ray_blocks(S, W):
    R, n_sub = nk.fine_composite_geometry(S)
    assert R >= 1 and (R == 1 or R * S <= nk.COMP_MAX_POINTS)
    assert n_sub == -(-R * S // nk.SWEEP_TILE)
    N = 3 * R + 1 if R > 1 else 5          # a last block with one ray
    seen = np.zeros((N, S), dtype=int)
    owner = np.full(N, -1)
    for block in range(-(-N // R)):
        subs = _block_rows(N, S, R, block)
        assert len(subs) <= n_sub
        for j, sub in enumerate(subs):
            dead = sub[:, 0] < 0
            assert not dead.any() or j == len(subs) - 1, (block, j)
            assert (np.diff(dead.astype(int)) >= 0).all()   # the dead rows trail
            for ray, s in sub[~dead]:
                seen[ray, s] += 1
                assert owner[ray] in (-1, block), f"ray {ray} crosses blocks"
                owner[ray] = block
    assert (seen == 1).all()
    smem = nk.fine_composite_smem_bytes(W, 10, S)
    assert smem - nk.sweep_smem_bytes(W, 10) >= (1 + nk.N_COMP) * R * S * 4
    blocks = 2 if W <= 128 else 1
    assert blocks * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _composite_lanes(raw, z):
    """_composite_plain's (8, N) rows in fine_composite_kernel's order: per
    lane a contiguous run of ceil(S/32) samples; the run's products of
    (1 - alpha) and (1 - alpha_static); their exclusive scan over the
    lanes; each run's sums from its entering transmittances; a butterfly
    sum over the lanes (lane 0's value)."""
    N, S = z.shape
    run = -(-S // LANES)
    dz = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e2)], -1)
    ssig, tsig = _softplus(raw[3]), _softplus(raw[7])
    sa = 1.0 - torch.exp(-dz * ssig)
    ta = 1.0 - torch.exp(-dz * tsig)
    al = 1.0 - torch.exp(-dz * (ssig + tsig))
    srgb, trgb = _sigmoid(raw[0:3]), _sigmoid(raw[4:7])

    def lanes(x, fill):
        """(..., N, S) -> (..., N, 32, run), samples past S set to fill."""
        x = torch.nn.functional.pad(x, (0, LANES * run - S), value=fill)
        return x.reshape(*x.shape[:-1], LANES, run)

    sa, ta, al, zl = lanes(sa, 0.0), lanes(ta, 0.0), lanes(al, 0.0), lanes(z, 0.0)
    srgb, trgb = lanes(srgb, 0.0), lanes(trgb, 0.0)
    T, Ts = torch.ones(N, LANES), torch.ones(N, LANES)
    for k in range(run):
        T, Ts = T * (1.0 - al[..., k]), Ts * (1.0 - sa[..., k])
    o = 1
    while o < LANES:
        T = torch.cat([T[:, :o], T[:, o:] * T[:, :-o]], 1)
        Ts = torch.cat([Ts[:, :o], Ts[:, o:] * Ts[:, :-o]], 1)
        o *= 2
    T = torch.cat([torch.ones(N, 1), T[:, :-1]], 1)
    Ts = torch.cat([torch.ones(N, 1), Ts[:, :-1]], 1)
    v = torch.zeros(nk.N_COMP, N, LANES)
    for k in range(run):
        a_s, a_t, a = sa[..., k], ta[..., k], al[..., k]
        sw, tw, swo = a_s * T, a_t * T, a_s * Ts
        for c in range(3):
            sc = srgb[c, ..., k]
            v[c] = v[c] + (sw * sc + tw * trgb[c, ..., k])
            v[5 + c] = v[5 + c] + swo * sc
        v[3] = v[3] + a * T
        v[4] = v[4] + swo * zl[..., k]
        T, Ts = T * (1.0 - a), Ts * (1.0 - a_s)
    lane = torch.arange(LANES)
    o = LANES // 2
    while o:
        v = v + v[..., lane ^ o]
        o //= 2
    return v[..., 0]


@pytest.mark.parametrize("S", [24, 40, 128, 192])
def test_fine_composite_lane_order_keeps_plain_values(S):
    rng = np.random.default_rng(S)
    N = 48
    raw = rng.normal(size=(nk.N_RAW, N, S)).astype(np.float32) * 2.0
    # sigma pre-activations: a third of the rays thin, a third dense enough
    # that the transmittance underflows float32 within the ray, a third mixed
    raw[3, :N // 3] -= 3.0
    raw[3, N // 3:2 * N // 3] = rng.uniform(20.0, 60.0, (N // 3, S))
    raw[7, N // 3:2 * N // 3] = rng.uniform(10.0, 30.0, (N // 3, S))
    z = np.sort(rng.uniform(2.0, 6.0, (N, S)), -1).astype(np.float32)
    raw, z = torch.tensor(raw), torch.tensor(z)
    want = nk._composite_plain(raw, z)
    got = _composite_lanes(raw, z)
    assert got.shape == want.shape == (nk.N_COMP, N)
    # the dense rays' transmittance does underflow
    T = torch.cumprod(torch.exp(-(z[:, 1:] - z[:, :-1]) * (
        _softplus(raw[3, :, :-1]) + _softplus(raw[7, :, :-1]))), -1)
    assert (T[N // 3:2 * N // 3, -1] == 0).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
