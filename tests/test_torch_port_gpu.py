"""The port's CUDA kernels against their plain PyTorch versions on a card:
coarse_sigma_t, fine_raw_t (fine and static packs), fine_composite_t,
raw_bwd_t, proposal_z_rows (the mono path's sampler) and the layer-stack
probe's mlp_stack_bf16 / mlp_stack_int8.

Imports neither JAX nor dfnet_tpu, so it also runs on a machine that has
only PyTorch for CUDA:

    python -m pytest --noconftest tests/test_torch_port_gpu.py

Skips where there is no CUDA device. Small random nets, ragged ray counts
(the kernels mask the last tile's edge themselves). Tolerances: raw
pre-activation outputs 2e-2 (at the shipped depth, D=8, under the
FLIP_SHARE rule of ops/tolerances.py), composited outputs 3e-2 (the kernel and the
plain version sum their float32 products in different orders, so a bf16
activation can round the other way); gradients 3e-2 times each packed
entry's largest magnitude (bf16 cotangents, and the kernel sums over its
tiles and blocks in another order); fine z samples 2e-3, every row sorted;
the int8 layer stack exactly (its plain version sums integers in float32,
exact below 2^24), the bf16 one under ops/mlp_stack.py's
bf16_stack_agreement (at most 1% of outputs differ at all, each within two
bf16 steps plus 1/8 of the output's RMS)."""

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.nerfw import NeRFWConfig, init_nerfw_params, init_sigma_mlp
from dfnet_tpu_torch.ops import mlp_stack as ms
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.ops.tolerances import FLIP_CAP, FLIP_SHARE, TOL_COMP, TOL_RAW, TOL_Z
from dfnet_tpu_torch.scripts import bench_int8_wide as probe

NEAR, FAR = 0.5, 3.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _rays(N, seed, device):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return torch.tensor(ro, device=device), torch.tensor(rd, device=device)


def _close(kern, plain, args, tol):
    got = kern(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("D,W,skip,F,S,lindisp", [
    (2, 64, -1, 4, 64, False),       # the proposal net's shape
    (4, 64, 2, 10, 32, True),
    (2, 256, 1, 10, 24, False),      # wide branch
])
def test_coarse_sigma_kernel_matches_plain(cuda, D, W, skip, F, S, lindisp):
    cfg = NeRFWConfig(D=D, W=W, skips=(skip,) if skip > 0 else (), in_xyz=6 * F + 3)
    params = init_sigma_mlp(torch.Generator().manual_seed(D + W), cfg, cuda)
    emb = get_embedder(F)
    packed = nk.pack_coarse_t(params, cfg, emb)
    spec = nk.spec_of(cfg, emb, fine=False)
    ro, rd = _rays(37, seed=W, device=cuda)
    nk.reset_launches()
    _close(nk.coarse_sigma_t, nk.coarse_sigma_plain,
           (packed, ro, rd, spec, S, NEAR, FAR, lindisp), 2e-2)
    assert nk.LAUNCHES["coarse_sigma_t"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("D,W,skip,S", [
    (4, 64, 2, 24),
    (2, 128, 1, 128),                # the mono path's fine_composite_t: one ray a block
    (2, 256, 1, 128),
])
def test_fine_kernels_match_plain(cuda, D, W, skip, S):
    cfg = NeRFWConfig(D=D, W=W, skips=(skip,), encode_appearance=True,
                      encode_transient=True)
    params = init_nerfw_params(torch.Generator().manual_seed(D + W), cfg, cuda)
    emb = get_embedder(10)
    packed = nk.pack_fine_t(params, cfg, emb)
    spec = nk.spec_of(cfg, emb, fine=True)
    N = 37
    ro, rd = _rays(N, seed=W + 1, device=cuda)
    rng = np.random.default_rng(W + 2)
    z = torch.tensor(np.sort(rng.uniform(NEAR, FAR, (N, S)), -1).astype(np.float32),
                     device=cuda)
    dpt = torch.tensor(rng.normal(size=(N, W)).astype(np.float32), device=cuda)
    args = (packed, ro, rd, z, dpt, spec)
    nk.reset_launches()
    _close(nk.fine_raw_t, nk.fine_raw_plain, args, 2e-2)
    _close(nk.fine_composite_t, nk.fine_composite_plain, args, 3e-2)
    assert nk.LAUNCHES == {**dict.fromkeys(nk.LAUNCHES, 0), "fine_raw_t": 1,
                           "fine_composite_t": 1}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cfg = NeRFWConfig(D=2, W=64, skips=(), in_xyz=27)
    emb = get_embedder(4)
    packed = nk.pack_coarse_t(init_sigma_mlp(torch.Generator().manual_seed(0),
                                             cfg, cuda), cfg, emb)
    spec = nk.spec_of(cfg, emb, fine=False)
    ro, rd = _rays(8, seed=0, device=cuda)
    with pytest.raises(ValueError, match="rays_d"):
        nk.coarse_sigma_t(packed, ro, rd.double(), spec, 16, NEAR, FAR)
    with pytest.raises(ValueError, match="rays_o"):
        nk.coarse_sigma_t(packed, ro.t().contiguous().t(), rd, spec, 16, NEAR, FAR)


def _sweep_inputs(D, W, skip, static, N, S, device, seed):
    cfg = NeRFWConfig(D=D, W=W, skips=(skip,), encode_appearance=True,
                      encode_transient=True)
    params = init_nerfw_params(torch.Generator().manual_seed(seed), cfg, device)
    emb = get_embedder(10)
    packed = (nk.pack_static_t if static else nk.pack_fine_t)(params, cfg, emb)
    packed = {k: v.detach() for k, v in packed.items()}
    spec = nk.spec_of(cfg, emb, fine=not static, static=static)
    ro, rd = _rays(N, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    z = torch.tensor(np.sort(rng.uniform(NEAR, FAR, (N, S)), -1).astype(np.float32),
                     device=device)
    dpt = torch.tensor(rng.normal(size=(N, spec.Wd)).astype(np.float32), device=device)
    g = torch.tensor(rng.uniform(size=(spec.n_raw, N, S)).astype(np.float32),
                     device=device)
    return packed, spec, ro, rd, z, dpt, g


@pytest.mark.gpu
@pytest.mark.parametrize("D,W,skip,S", [(4, 64, 2, 24), (2, 256, 1, 64)])
def test_static_fine_raw_kernel_matches_plain(cuda, D, W, skip, S):
    packed, spec, ro, rd, z, dpt, _ = _sweep_inputs(D, W, skip, True, 37, S, cuda, W)
    nk.reset_launches()
    _close(nk.fine_raw_t, nk.fine_raw_plain, (packed, ro, rd, z, dpt, spec), 2e-2)
    assert nk.LAUNCHES["fine_raw_t"] == 1


def _flip_close(got, want, tol):
    """got within atol/rtol tol of want, but for a FLIP_SHARE of the
    elements (bf16 rounding flips, ops/tolerances.py), none of them beyond
    FLIP_CAP times the tolerance."""
    assert torch.isfinite(got).all()
    ratio = (got - want).abs() / (tol + tol * want.abs())
    assert int((ratio > 1).sum()) <= FLIP_SHARE * got.numel(), float(ratio.max())
    assert float(ratio.max()) <= FLIP_CAP


@pytest.mark.gpu
@pytest.mark.parametrize("W,static,S", [
    (128, False, 128), (128, True, 64),    # the shipped trunk at its train S
    (128, False, 40), (128, True, 24),     # 37 rays: a ragged last tile
    (256, False, 128), (256, True, 40),
    (64, False, 40), (64, True, 64),
])
def test_fine_raw_kernel_matches_plain_shipped_depth(cuda, W, static, S):
    """fine_raw_t at D=8 skip 4 (the shipped trunk) against fine_raw_plain:
    one launch counted, the FLIP_SHARE rule at 2e-2, and a second call
    gives the same bits."""
    args = _sweep_inputs(8, W, 4, static, 37, S, cuda, W + S)[:-1]
    packed, spec, ro, rd, z, dpt = args
    args = (packed, ro, rd, z, dpt, spec)
    nk.reset_launches()
    got = nk.fine_raw_t(*args)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["fine_raw_t"] == 1
    assert got.shape == (spec.n_raw, 37, S)
    _flip_close(got, nk.fine_raw_plain(*args), TOL_RAW)
    assert torch.equal(got, nk.fine_raw_t(*args))


@pytest.mark.gpu
def test_fine_raw_kernel_occupancy_and_width_limit(cuda):
    """Two blocks an SM at W <= 128, one at W = 256; a wider net raises."""
    assert nk.fine_raw_occupancy(128, 10)[0] == 2
    assert nk.fine_raw_occupancy(256, 10)[0] == 1
    packed, spec, ro, rd, z, dpt, _ = _sweep_inputs(2, 64, 1, False, 4, 8, cuda, 0)
    wide = nk.KernelSpec(D=2, W=288, skip=1, F=10, fine=True)
    with pytest.raises(ValueError, match="W <= 256"):
        nk.fine_raw_t(packed, ro, rd, z, dpt, wide)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [24, 40, 128, 192])
@pytest.mark.parametrize("W", [64, 128, 256])
def test_fine_composite_kernel_matches_plain_shipped_depth(cuda, W, S):
    """fine_composite_t at D=8 skip 4, F=10 (the shipped fine net), 37 rays
    (a ragged last block at every R): against fine_composite_plain under
    the FLIP_SHARE rule at TOL_COMP; against _composite_plain of
    fine_raw_t's rows on the card at 1e-5 (the same sweep, bit for bit, so
    only the composite's order differs); one launch counted; a second call
    gives the same bits."""
    packed, spec, ro, rd, z, dpt, _ = _sweep_inputs(8, W, 4, False, 37, S, cuda, W + S + 1)
    args = (packed, ro, rd, z, dpt, spec)
    nk.reset_launches()
    got = nk.fine_composite_t(*args)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["fine_composite_t"] == 1
    assert got.shape == (nk.N_COMP, 37)
    _flip_close(got, nk.fine_composite_plain(*args), TOL_COMP)
    torch.testing.assert_close(got, nk._composite_plain(nk.fine_raw_t(*args), z),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(got, nk.fine_composite_t(*args))


@pytest.mark.gpu
def test_fine_composite_kernel_occupancy_and_width_limit(cuda):
    """Two blocks an SM at W <= 128, one at W = 256, at the culled and the
    mono S; the shared bytes are those the CPU-side geometry implies; a
    wider net raises."""
    for S in (24, 128):
        for W in (64, 128, 256):
            blocks, smem, R = nk.fine_composite_occupancy(W, 10, S)
            assert blocks == (2 if W <= 128 else 1), (W, S, blocks)
            assert smem == nk.fine_composite_smem_bytes(W, 10, S)
            assert R == nk.fine_composite_geometry(S)[0]
    packed, spec, ro, rd, z, dpt, _ = _sweep_inputs(2, 64, 1, False, 4, 8, cuda, 0)
    wide = nk.KernelSpec(D=2, W=288, skip=1, F=10, fine=True)
    with pytest.raises(ValueError, match="W <= 256"):
        nk.fine_composite_t(packed, ro, rd, z, dpt, wide)


def _sigma_inputs(D, W, skip, F, N, device, seed):
    cfg = NeRFWConfig(D=D, W=W, skips=(skip,) if skip > 0 else (), in_xyz=6 * F + 3)
    params = init_sigma_mlp(torch.Generator().manual_seed(seed), cfg, device)
    emb = get_embedder(F)
    packed = nk.pack_coarse_t(params, cfg, emb)
    ro, rd = _rays(N, seed=seed, device=device)
    return packed, nk.spec_of(cfg, emb, fine=False), ro, rd


@pytest.mark.gpu
@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("D,W,skip,F,S", [
    (2, 64, -1, 4, 64),              # the proposal net at the render's S
    (2, 64, -1, 4, 32),              # ... at the culled schedule's S
    (8, 128, 4, 10, 64),             # the shipped coarse net
])
def test_coarse_sigma_kernel_matches_plain_shipped_shapes(cuda, D, W, skip, F, S, lindisp):
    """coarse_sigma_t on the proposal and the shipped coarse trunks, 37 rays
    (a ragged last tile), linear and lindisp z: against coarse_sigma_plain
    under the FLIP_SHARE rule at TOL_RAW; one launch counted; a second call
    gives the same bits."""
    packed, spec, ro, rd = _sigma_inputs(D, W, skip, F, 37, cuda, W + S)
    args = (packed, ro, rd, spec, S, NEAR, FAR, lindisp)
    nk.reset_launches()
    got = nk.coarse_sigma_t(*args)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["coarse_sigma_t"] == 1
    assert got.shape == (37, S)
    _flip_close(got, nk.coarse_sigma_plain(*args), TOL_RAW)
    assert torch.equal(got, nk.coarse_sigma_t(*args))


@pytest.mark.gpu
def test_coarse_sigma_kernel_occupancy_and_width_limit(cuda):
    """Three blocks an SM at W <= 64 (the proposal net), two at W <= 128
    (the coarse net), one at W = 256; a wider net raises."""
    assert nk.coarse_sigma_occupancy(64, 4)[0] == 3
    assert nk.coarse_sigma_occupancy(128, 10)[0] == 2
    assert nk.coarse_sigma_occupancy(256, 10)[0] == 1
    packed, spec, ro, rd = _sigma_inputs(2, 64, -1, 4, 4, cuda, 0)
    wide = nk.KernelSpec(D=2, W=288, skip=-1, F=4, fine=False)
    with pytest.raises(ValueError, match="W <= 256"):
        nk.coarse_sigma_t(packed, ro, rd, wide, 16, NEAR, FAR)


def _bwd_close(N, packed, spec, ro, rd, z, dpt, g):
    """raw_bwd_t against raw_bwd_plain: each packed entry and d_dpt within
    3e-2 of its largest magnitude; one launch counted; a second call gives
    the same bits (no atomics)."""
    args = (packed, ro, rd, z, dpt, g, spec)
    nk.reset_launches()
    got = nk.raw_bwd_t(*args)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["raw_bwd_t"] == 1
    want = nk.raw_bwd_plain(*args)
    assert got[0].dtype == torch.bfloat16 and got[2].shape == (N, spec.Wd)
    named = lambda r: {**nk.unpack({"w": r[0], "b": r[1]}, spec), "dpt": r[2]}
    for name, w in named(want).items():
        k = named(got)[name].float()
        assert torch.isfinite(k).all(), name
        scale = max(k.abs().max().item(), w.float().abs().max().item(), 1e-6)
        err = (k - w.float()).abs().max().item()
        assert err < 3e-2 * scale, f"{name}: err {err:.3e} scale {scale:.3e}"
    # the sums are deterministic: a second launch gives the same bits
    again = nk.raw_bwd_t(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("D,W,skip,S", [(4, 64, 2, 24), (2, 256, 1, 64)])
def test_raw_bwd_kernel_matches_plain(cuda, D, W, skip, S, static):
    N = 37                                      # ragged against every tile
    packed, spec, ro, rd, z, dpt, g = _sweep_inputs(D, W, skip, static, N, S, cuda,
                                                    D + W)
    _bwd_close(N, packed, spec, ro, rd, z, dpt, g)


@pytest.mark.gpu
@pytest.mark.parametrize("static,S", [(False, 128), (True, 64)])
def test_raw_bwd_kernel_matches_plain_shipped_depth(cuda, static, S):
    # the shipped trunk (D=8, W=128, skip 4) at its train S: 600 / 300
    # stash tiles, several weight-grad chunks, a ragged last tile
    N = 300
    packed, spec, ro, rd, z, dpt, g = _sweep_inputs(8, 128, 4, static, N, S, cuda, 5)
    *_, chunk, n_chunks = nk._bwd_tables(spec, nk.bwd_points(N, S), cuda)
    assert n_chunks > 1 and chunk % nk.BWD_TILE == 0
    _bwd_close(N, packed, spec, ro, rd, z, dpt, g)


@pytest.mark.gpu
@pytest.mark.parametrize("D,W,skip,S,static", [(8, 128, 4, 128, False), (8, 128, 4, 64, True),
                                               (2, 256, 1, 64, False)])
def test_raw_bwd_wgrad_and_reduce_match_plain_on_the_kernel_stash(cuda, D, W, skip, S,
                                                                  static):
    """bwd_wgrad and bwd_reduce alone: d_w, d_b and d_dpt from the kernel's
    own stash against raw_bwd_from_stash_plain on that stash, so both sides
    have the same bf16 operands and differ only in the order of their
    float32 sums. Each entry within 1e-4 of its sum of |products| (the
    plain version run on |stash|); d_w also within one bf16 step (2^-7 of
    its magnitude), since both round a float32 sum to bf16. Control: the
    plain sums with the last, ragged chunk dropped (704 of 38,400 or 19,200
    points) must fail that bar in d_w and in d_b."""
    N = 300
    packed, spec, ro, rd, z, dpt, g = _sweep_inputs(D, W, skip, static, N, S, cuda, 7)
    Pp = nk.bwd_points(N, S)
    *_, chunk, n_chunks = nk._bwd_tables(spec, Pp, cuda)
    assert n_chunks > 1 and Pp - (n_chunks - 1) * chunk < chunk
    # the partials are torch.empty: let them reuse a NaN-filled block, so a
    # d_w or d_b entry that bwd_reduce reads but no bwd_wgrad block wrote shows
    poison = torch.full((n_chunks, packed["w"].numel() + packed["b"].numel() + 64),
                        float("nan"), device=cuda)
    del poison
    launches, got, stash = nk.raw_bwd_launches(packed, ro, rd, z, dpt, g, spec)
    for _, fn in launches:
        fn()
    torch.cuda.synchronize()
    want = nk.raw_bwd_from_stash_plain(stash, spec, N, S)
    mag = nk.raw_bwd_from_stash_plain(stash.abs(), spec, N, S)

    def excess(a, b):
        """Per output, the largest |a - b| over its bar (NaN if any is NaN)."""
        out = []
        for i, (x, y, m) in enumerate(zip(a, b, mag)):
            x, y, m = x.float(), y.float(), m.float()
            bar = 1e-4 * m + (2 ** -7 * torch.maximum(x.abs(), y.abs()) if i == 0 else 0)
            out.append(((x - y).abs() / bar.clamp_min(1e-30)).max().item())
        return out

    assert all(bool(torch.isfinite(t).all()) for t in got)
    err = excess(got, want)
    assert all(e <= 1 for e in err), dict(zip(("d_w", "d_b", "d_dpt"), err))
    dropped = stash.clone()
    R = nk.bwd_stash_offsets(spec, Pp)
    for name, width in nk.bwd_regions(spec):
        if width:
            dropped[R[name][0] + (n_chunks - 1) * chunk * width:R[name][0] + Pp * width] = 0
    ctrl = excess(got, nk.raw_bwd_from_stash_plain(dropped, spec, N, S))
    assert ctrl[0] > 1 and ctrl[1] > 1, ctrl


def _stash_steps(k, packed, spec, dpt, S):
    """Each stash region recomputed one layer at a time from the kernel's
    own stash (k: {region: float32 rows}): a layer's activation from its
    stashed input, a cotangent from the stashed cotangent above it and its
    stashed mask. No flip from a layer above reaches the comparison."""
    v = {n: t.float() for n, t in nk.unpack(packed, spec).items()}
    bfr = lambda x: x.bfloat16().float()
    fwd = lambda x, w, b: bfr(torch.relu(x @ w.t() + b))
    bwd = lambda gr, w, act: bfr(torch.where(act > 0, gr @ w, torch.zeros_like(act)))
    D, half, b = spec.D, spec.W // 2, v["b_trunk"]
    out = {"h0": fwd(k["x0"], v["w0"], b[0])}
    for i in range(1, D):
        if i == spec.skip:
            y = k["x0"] @ v[f"wx{i}"].t() + k[f"h{i - 1}"] @ v[f"wh{i}"].t()
            out[f"h{i}"] = bfr(torch.relu(y + b[i]))
        else:
            out[f"h{i}"] = fwd(k[f"h{i - 1}"], v[f"w{i}"], b[i])
    rows = torch.arange(k["x0"].shape[0], device=dpt.device) // S
    h = k[f"h{D - 1}"]
    out["dt0"] = bfr(torch.relu(h @ v["w_dt"].t() + v["b_dt"] + dpt[rows]))
    heads, gb = v["w_heads"], k["g_raw"][:, :spec.n_raw]
    g_dt = bwd(gb[:, 0:3], heads[0:3, :half], k["dt0"][:, :half])
    if spec.fine:
        t0 = k["dt0"][:, half:]
        out["t1"] = fwd(t0, v["w_tr0"], v["b_tr"][0])
        out["t2"] = fwd(k["t1"], v["w_tr1"], v["b_tr"][1])
        out["t3"] = fwd(k["t2"], v["w_tr2"], v["b_tr"][2])
        out["g_t3"] = bwd(gb[:, 4:9], heads[4:9, half:], k["t3"])
        out["g_t2"] = bwd(k["g_t3"], v["w_tr2"], k["t2"])
        out["g_t1"] = bwd(k["g_t2"], v["w_tr1"], k["t1"])
        g_dt = torch.cat([g_dt, bwd(k["g_t1"], v["w_tr0"], t0)], -1)
    out["g_dt"] = g_dt
    out[f"g_h{D - 1}"] = bfr(torch.where(h > 0, k["g_dt"] @ v["w_dt"] + gb[:, 3:4] * heads[3],
                                         torch.zeros_like(h)))
    for i in range(D - 1, 0, -1):
        w = v[f"wh{i}"] if i == spec.skip else v[f"w{i}"]
        out[f"g_h{i - 1}"] = bwd(k[f"g_h{i}"], w, k[f"h{i - 1}"])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("D,W,skip,S", [(8, 128, 4, 24), (2, 256, 1, 64)])
def test_raw_bwd_stash_matches_plain(cuda, D, W, skip, S, static):
    """bwd_stash alone, so that a fault shows in its phase and layer: x0 and
    g_raw against raw_bwd_stash_plain (2e-2, fine_raw_t's bar; g_raw
    exactly), every other region against its layer recomputed in plain
    torch from the kernel's own stashed inputs (_stash_steps): rtol 2e-2
    (one bf16 step is 2^-8) and atol 1e-3 of the region's largest
    magnitude (float32 sums in another order, under cancellation). Both
    sides use the same stashed masks, so ReLU flips cannot reach it."""
    N = 37
    packed, spec, ro, rd, z, dpt, g = _sweep_inputs(D, W, skip, static, N, S, cuda, 9)
    launches, _, stash = nk.raw_bwd_launches(packed, ro, rd, z, dpt, g, spec)
    dict(launches)["stash"]()
    torch.cuda.synchronize()
    k = {n: t.float() for n, t in nk.bwd_stash_views(stash, spec, N, S).items()}
    plain = nk.bwd_stash_views(nk.raw_bwd_stash_plain(packed, ro, rd, z, dpt, g, spec),
                               spec, N, S)
    assert torch.equal(k["g_raw"], plain["g_raw"].float())
    torch.testing.assert_close(k["x0"], plain["x0"].float(), atol=2e-2, rtol=2e-2)
    want = _stash_steps(k, packed, spec, dpt, S)
    assert sorted(want) == sorted(set(k) - {"x0", "g_raw"})
    for name, w in want.items():
        assert torch.isfinite(k[name]).all(), name
        scale = max(w.abs().max().item(), 1e-30)
        torch.testing.assert_close(k[name], w, rtol=2e-2, atol=1e-3 * scale, msg=name)


def _proposal_inputs(W, F, N, device, seed):
    cfg = NeRFWConfig(D=2, W=W, skips=(), in_xyz=6 * F + 3)
    params = init_sigma_mlp(torch.Generator().manual_seed(seed), cfg, device)
    emb = get_embedder(F)
    ro, rd = _rays(N, seed=seed + 3, device=device)
    return nk.pack_coarse_t(params, cfg, emb), nk.spec_of(cfg, emb, fine=False), ro, rd


@pytest.mark.gpu
@pytest.mark.parametrize("N", [37, 0])
@pytest.mark.parametrize("W,F,S,S_f", [
    (64, 4, 64, 128),                # the proposal net at the mono path's shape
    (128, 4, 32, 96),                # a wide proposal, several rays a block
    (64, 4, 48, 128),                # rays a block that cross sub-tiles
    (64, 4, 96, 160),                # two rays over three sub-tiles
])
def test_proposal_z_kernel_matches_plain(cuda, W, F, S, S_f, N):
    """proposal_z_rows at 37 rays (a ragged last block at every R) and at
    none: within TOL_Z of proposal_z_plain, every row sorted and inside
    [near, far]; one launch counted where there are rays; a second call
    gives the same bits."""
    packed, spec, ro, rd = _proposal_inputs(W, F, N, cuda, W + S)
    args = (packed, ro, rd, spec, S, S_f, NEAR, FAR, S / S_f)
    nk.reset_launches()
    got = nk.proposal_z_rows(*args)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["proposal_z_rows"] == (1 if N else 0)
    assert got.shape == (N, S_f) and torch.isfinite(got).all()
    if N == 0:
        return
    want = nk.proposal_z_plain(*args)
    torch.testing.assert_close(got, want, atol=TOL_Z, rtol=0)
    assert (got[:, 1:] >= got[:, :-1]).all()
    assert (got >= NEAR).all() and (got <= FAR).all()
    assert torch.equal(got, nk.proposal_z_rows(*args))


@pytest.mark.gpu
def test_proposal_z_kernel_occupancy_and_width_limit(cuda):
    """Three blocks an SM at W <= 64 (the proposal net), two at W <= 128,
    one at W = 256, as coarse_sigma_t; the shared bytes and the rays a
    block are those the CPU-side geometry implies; a wider net raises."""
    for S in (32, 48, 64, 96):
        for W, blocks in ((64, 3), (128, 2), (256, 1)):
            got, smem, R = nk.proposal_z_occupancy(W, 4, S)
            assert got == blocks, (W, S, got)
            assert smem == nk.proposal_z_smem_bytes(W, 4, S)
            assert R == nk.proposal_z_geometry(S)[0]
    packed, spec, ro, rd = _proposal_inputs(64, 4, 4, cuda, 0)
    wide = nk.KernelSpec(D=2, W=288, skip=-1, F=4, fine=False)
    with pytest.raises(ValueError, match="W <= 256"):
        nk.proposal_z_rows(packed, ro, rd, wide, 64, 128, NEAR, FAR, 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 2, 6])
@pytest.mark.parametrize("W", ms.WIDTHS)
def test_mlp_stack_kernels_match_plain(cuda, W, D):
    """Both stacks at every width the kernel is built for, at P = 1000 (a
    ragged last tile), one full tile of rows + 1 and 1. int8 equals its
    plain version on the probe's weights (every output zero past the first
    layers) and on weights that keep the stack alive. bf16 passes
    bf16_stack_agreement at P = 1000, and each smaller P gives the bits of
    the same rows of the P = 1000 call (a row's sums do not depend on the
    other rows). The agreement rule caps the share of outputs that differ
    at 1%, a share that only many rows make steady: a bf16 flip in an early
    layer moves several of a row's 8 outputs, so one or two such rows in
    129 (about 0.4% of outputs differ at D = 6 over 2^21 points) can pass
    1% by chance, and at P = 1 one flip is 12.5%. One launch counted a
    call."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rows = ms.mlp_stack_geometry("bf16", W)["rows"]
    sizes = (rows + 1, 1)
    nk.reset_launches()
    x, ws = ms.probe_inputs("bf16", W, 1000, D, cuda)
    full = ms.mlp_stack_bf16(x, ws)
    torch.cuda.synchronize()
    assert full.shape == (1000, ms.N_OUT)
    agree = ms.bf16_stack_agreement(full, ms.mlp_stack_bf16_plain(x, ws))
    assert agree["ok"], agree
    for P in sizes:
        got = ms.mlp_stack_bf16(x[:P], ws)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:P]), P
    x, ws = ms.probe_inputs("int8", W, 1000, D, cuda)
    alive = probe.alive_int8_weights(ws.shape, cuda)
    for w in (ws, alive):
        for P in (1000, *sizes):
            got = ms.mlp_stack_int8(x[:P], w)
            torch.cuda.synchronize()
            assert torch.equal(got, ms.mlp_stack_int8_plain(x[:P], w)), (P, w is alive)
            if P == 1000 and w is alive:
                assert (got > 0).any()
    assert nk.LAUNCHES["mlp_stack_bf16"] == 3 and nk.LAUNCHES["mlp_stack_int8"] == 6


@pytest.mark.gpu
def test_mlp_stack_kernel_occupancy_and_widths(cuda):
    """One block an SM at every width, with the shared bytes of the
    CPU-side geometry; no launch for P = 0; a width the kernel is not built
    for raises ValueError naming the widths."""
    for dtype in ("bf16", "int8"):
        for W in ms.WIDTHS:
            blocks, smem = ms.mlp_stack_occupancy(dtype, W)
            assert blocks == 1, (dtype, W, blocks)
            assert smem == ms.mlp_stack_geometry(dtype, W)["smem_bytes"]
    nk.reset_launches()
    x, ws = ms.probe_inputs("bf16", 128, 0, 2, cuda)
    assert ms.mlp_stack_bf16(x, ws).shape == (0, ms.N_OUT)
    assert nk.LAUNCHES["mlp_stack_bf16"] == 0
    for W in (96, 320):
        x, ws = ms.probe_inputs("int8", W, 8, 2, cuda)
        with pytest.raises(ValueError, match="W in"):
            ms.mlp_stack_int8(x, ws)


# ------------------------------------------------------------------ stage 2

def _feature_trainer(device, *flags, nerf=None, H=32, W=48):
    """A stage-2 trainer at the golden step's config from a seeded init,
    the same params on every device."""
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.training import parity
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer

    sc = make_synthetic_scene(n_train=4, n_val=2, H=H, W=W, focal=60.0 * W / 64)
    cfg = parse_args(parity.GOLDEN_FLAGS + ["--featurenet_batch_size", "4",
                                            "--device", str(device), *flags],
                     stage="feature")
    return FeatureTrainer(cfg, sc, nerf, gen=torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_dfnet_float32_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The golden step's loss and gradients, card against CPU, under the
    golden bars on the golden test's leaves (training/parity.py), with
    PyTorch's TF32 default left on: the port keeps its float32 convs IEEE
    itself, and restores the flags."""
    from dfnet_tpu_torch.training import parity

    batch = parity.golden_batch()
    want = parity.loss_and_grads(_feature_trainer("cpu", "--basedir", str(tmp_path)), batch)
    torch.backends.cudnn.allow_tf32 = True
    got = parity.loss_and_grads(_feature_trainer(cuda, "--basedir", str(tmp_path)), batch)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled
    ok, info = parity.golden_agreement(*got, *want, leaves=parity.GOLDEN_LEAVES)
    assert ok, info


@pytest.mark.gpu
def test_dfnet_float32_eval_forward_on_the_card_matches_the_cpu(cuda, tmp_path):
    """predict (the no-grad float32 eval forward) on the card against the
    CPU under parity.EVAL_POSE_TOL, with PyTorch's TF32 default left on: the
    port keeps its float32 convs IEEE itself, and restores the flags."""
    from dfnet_tpu_torch.training import parity

    x = torch.cat([parity.golden_batch()[i] for i in (0, 1, 3)])
    want = _feature_trainer("cpu", "--basedir", str(tmp_path)).predict(x)
    torch.backends.cudnn.allow_tf32 = True
    got = _feature_trainer(cuda, "--basedir", str(tmp_path)).predict(x.to(cuda))
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled
    ok, err = parity.eval_agreement(got, want)
    assert ok, err


@pytest.mark.gpu
def test_dfnet_bf16_tracks_float32_on_the_card(cuda, tmp_path):
    """bf16 against float32 on the card under the bf16 bars, and a bf16 train
    step: finite loss, float32 params and BN state."""
    from dfnet_tpu_torch.training import parity

    tr = _feature_trainer(cuda, "--basedir", str(tmp_path), "--feature_precision", "bf16")
    batch = [b.to(cuda) for b in parity.golden_batch()]
    ok, info = parity.bf16_agreement(tr.params, tr.state, torch.cat(batch[0:2]))
    assert ok, info
    loss = tr.train_step(*batch, 1e-4)
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert all(t.dtype == torch.float32 for _, t in tr._named)
    assert tr.state["adapt"]["0"]["var"].dtype == torch.float32


@pytest.mark.gpu
def test_feature_prerender_and_rvs_launch_the_sweeps(cuda, tmp_path):
    """Stage 2's pre-render and RVS refresh through FrozenNeRF on the trained
    asset (tinyimg): coarse_sigma_t and fine_raw_t launch in each."""
    import os

    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree, _ = load_pytree(os.path.join(root, "assets", "nerfh_synthetic_301.npz"))
    save_pytree(str(tmp_path / "nerfh" / "000301.npz"), {"params": tree})
    flags = ["--basedir", str(tmp_path), "--expname", "nerfh", "--tinyimg"]
    tr = _feature_trainer(cuda, *flags, H=48, W=64)
    sc = tr.scene
    tr.nerf = FrozenNeRF.from_experiment(parse_args(flags + ["--NeRFH", "--encode_hist",
                                                             "--device", "cuda"]),
                                         sc.hwf, sc.near, sc.far, sc.world_setup)
    assert tr.nerf.uses_fast_render
    for run in (tr.prerender_train_views,
                lambda: tr.rvs_refresh(np.random.default_rng(0))[1]):
        nk.reset_launches()
        views = run()
        assert views.shape == (4, 48, 64, 3) and np.isfinite(views).all()
        assert nk.LAUNCHES["coarse_sigma_t"] > 0 and nk.LAUNCHES["fine_raw_t"] > 0


@pytest.mark.gpu
def test_tar_loaded_frozen_nerf_renders_through_the_kernels(cuda, tmp_path):
    """The trained asset exported as a reference .tar (convert.py: no
    proposal net), loaded by FrozenNeRF.from_experiment: its no-grad
    renders place samples with the coarse D=8 W=128 net through
    coarse_sigma_t, run fine_raw_t, and agree with the plain render_fn
    within 3e-2 (the kernel path's bar)."""
    import os

    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.convert import export_nerf_checkpoint
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.training.checkpoints import load_pytree
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree, _ = load_pytree(os.path.join(root, "assets", "nerfh_synthetic_301.npz"))
    (tmp_path / "nerfh").mkdir()
    export_nerf_checkpoint(tree, str(tmp_path / "nerfh" / "000301.tar"), 301)
    sc = make_synthetic_scene()
    cfg = parse_args(["--basedir", str(tmp_path), "--expname", "nerfh", "--NeRFH",
                      "--encode_hist", "--device", "cuda"])
    nerf = FrozenNeRF.from_experiment(cfg, sc.hwf, sc.near, sc.far, sc.world_setup)
    assert "proposal" not in nerf.params and nerf.uses_fast_render
    for i in range(2):
        nk.reset_launches()
        got = nerf.render_at_pose(sc.val.poses[i], sc.val.hists[i])
        torch.cuda.synchronize()
        assert nk.LAUNCHES["coarse_sigma_t"] > 0 and nk.LAUNCHES["fine_raw_t"] > 0
        with torch.no_grad():
            want = nerf.render_fn(nerf.params, torch.tensor(sc.val.poses[i], device=cuda),
                                  torch.tensor(sc.val.hists[i], device=cuda))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=TOL_COMP, rtol=TOL_COMP)


# ------------------------------------------------------------------ stage 3

@pytest.mark.gpu
@pytest.mark.parametrize("w", ["0.2,0.3,0.5", "0,0,1"])
def test_dm_float32_on_the_card_matches_the_cpu(cuda, tmp_path, w):
    """The DM step, card against CPU at float32: F's predicted pose under
    parity.EVAL_POSE_TOL; then, rendering at the CPU's predicted pose
    (parity.dm_loss_and_grads' render_pose: the DM gradient is not smooth
    in the pose below float32's rounding of it), the loss, dL/dpose and F's
    gradients under parity's bars (DM_LEAVES; the adapt leaves get no
    gradient on either side), with PyTorch's TF32 default left on for
    cuDNN: the float32 step keeps its convs and matmuls IEEE itself. At
    the card's own predicted pose, dL/dpose within DM_DPOSE_OWN_POSE of its
    scale."""
    from dfnet_tpu_torch.training import parity

    cpu = parity.dm_trainer(str(tmp_path), "cpu", "--combine_loss_w", w)
    sc = cpu.scene
    view = (sc.train.images[1], sc.train.poses[1].reshape(1, 12), sc.train.hists[1])
    want = parity.dm_loss_and_grads(cpu, *view)
    torch.backends.cudnn.allow_tf32 = True
    card = parity.dm_trainer(str(tmp_path), cuda, "--combine_loss_w", w)
    got = parity.dm_loss_and_grads(card, *view, render_pose=want[3])
    own = parity.dm_loss_and_grads(card, *view)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled
    ok, err = parity.eval_agreement(torch.tensor(got[3]), torch.tensor(want[3]))
    assert ok, err
    ok, info = parity.dm_agreement(got[0], got[2], want[0], want[2], leaves=parity.DM_LEAVES)
    assert ok, info
    dp, ref = got[2]["fc_pose/b"], want[2]["fc_pose/b"]
    assert np.abs(ref).max() > 0
    assert np.abs(dp - ref).max() < parity.GRAD_TOL * np.abs(ref).max()
    dp_own = own[2]["fc_pose/b"]
    assert np.abs(dp_own - ref).max() < parity.DM_DPOSE_OWN_POSE * np.abs(ref).max()


@pytest.mark.gpu
def test_dm_bf16_tracks_float32_on_the_card(cuda, tmp_path):
    """The bf16 DM step against float32 on the card: the predicted pose
    under parity's bf16 pose bar, both losses and dL/dpose finite."""
    from dfnet_tpu_torch.training import parity

    f32 = parity.dm_trainer(str(tmp_path), cuda)
    bf = parity.dm_trainer(str(tmp_path), cuda, "--feature_precision", "bf16")
    sc = f32.scene
    view = (sc.train.images[1], sc.train.poses[1].reshape(1, 12), sc.train.hists[1])
    image = torch.tensor(view[0], device=cuda)[None]
    with torch.no_grad():
        p32 = f32.predict_poses(f32.params, image)
        pbf = bf.predict_poses(bf.params, image, torch.bfloat16)
    assert float((pbf - p32).abs().max()) < parity.BF16_POSE * max(float(p32.abs().max()), 1)
    for tr in (f32, bf):
        loss, _, grads, _ = parity.dm_loss_and_grads(tr, *view)
        assert np.isfinite(loss) and np.isfinite(grads["fc_pose/b"]).all()


@pytest.mark.gpu
def test_dm_batched_step_matches_per_image_step_on_the_card(cuda, tmp_path):
    """K=2 against the per-image loss at float32 on the card, each loss
    within 5e-5 (the bar of JAX's test_dm_batched_step_parity)."""
    from dfnet_tpu_torch.models.dfnet import conv_precision
    from dfnet_tpu_torch.training import parity

    tr = parity.dm_trainer(str(tmp_path), cuda, "--combine_loss_w", "0.2,0.3,0.5")
    images, poses12, hists = tr.train_data
    args = (tr.params, tr.nerf.params, tr.feat_params)
    with torch.no_grad(), conv_precision(torch.float32):
        _, (losses, _) = tr.batched_loss_fn(*args, images[:2], poses12[:2], hists[:2])
        for i in range(2):
            li, _ = tr.loss_fn(*args, images[i], poses12[i:i + 1], hists[i])
            assert abs(float(li) - float(losses[i])) < 5e-5


@pytest.mark.gpu
def test_dm_epoch_launches_no_kernel(cuda, tmp_path):
    """A DM train epoch and eval_epoch on the trained asset (whose no-grad
    renders would take the kernels) launch none of the seven kernels: the
    pose gradient needs the plain renderer."""
    import os

    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.training import parity
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    tr = parity.dm_trainer(str(tmp_path / "small"), cuda)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree, _ = load_pytree(os.path.join(root, "assets", "nerfh_synthetic_301.npz"))
    save_pytree(str(tmp_path / "nerfh" / "000301.npz"), {"params": tree})
    sc = tr.scene
    tr.nerf = FrozenNeRF.from_experiment(
        parse_args(["--basedir", str(tmp_path), "--expname", "nerfh", "--NeRFH",
                    "--encode_hist", "--tinyimg", "--tinyscale", "4", "--device", "cuda"]),
        sc.hwf, sc.near, sc.far, sc.world_setup)
    assert tr.nerf.uses_fast_render
    nk.reset_launches()
    loss, psnr = tr.train_epoch(np.random.default_rng(0))
    val = tr.eval_epoch()
    assert np.isfinite([loss, psnr, *val]).all()
    assert not any(nk.LAUNCHES.values()), nk.LAUNCHES


# ------------------------------------------------------------------ data layer

@pytest.mark.gpu
@pytest.mark.parametrize("dataset", ["7Scenes", "Cambridge"])
def test_replica_written_on_the_card_loads_back(cuda, tmp_path, dataset):
    """A small replica rendered on the card, its PNGs decoded by
    data/png.py, loaded by load_scene at the shipped stats setting: the
    frames bit for bit, the NeRF-frame poses the sphere poses within 1e-6,
    the images the frames / 255 area-downscaled (df 2; 854-wide Cambridge
    frames at df 4 take the fractional path)."""
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.color import downscale_area
    from dfnet_tpu_torch.data.loader import load_scene
    from dfnet_tpu_torch.data.png import read_png
    from dfnet_tpu_torch.scripts import replica

    if dataset == "7Scenes":
        rec = replica.write_seven_scenes_replica(str(tmp_path), n_frames=4, H=48, W=64,
                                                 device=cuda)
        frame = tmp_path / "deepslam_data" / "7Scenes" / "heads" / "seq-02" / \
            "frame-000001.color.png"
        keys, df = (2, 1), 2.0
    else:
        rec = replica.write_cambridge_replica(str(tmp_path), n_frames=4, H=48, W=86,
                                              device=cuda)
        frame = tmp_path / "deepslam_data" / "Cambridge" / "KingsCollege" / "train" / \
            "rgb" / "frame00001.png"
        keys, df = ("train", "test"), 4.0
    np.testing.assert_array_equal(read_png(str(frame)), rec["frames"][keys[0]][1])
    cfg = parse_args(["--datadir", rec["datadir"], "--dataset_type", dataset, "--df",
                      str(df), "--encode_hist", "--load_pose_avg_stats", "--device", "cuda"])
    scene = load_scene(cfg, stage="nerf")
    for split, key in zip((scene.train, scene.val), keys):
        np.testing.assert_allclose(split.poses, rec["poses"][key], atol=1e-6, rtol=0)
        want = [downscale_area((f / 255.0).astype(np.float32), df) for f in rec["frames"][key]]
        np.testing.assert_array_equal(split.images, np.stack(want))


@pytest.mark.gpu
def test_prefetcher_delivers_the_host_batches_through_its_side_stream(cuda):
    """PrefetchIterator on the card: every batch equals its host arrays, on
    the card, after a long kernel queued on the consumer's stream ahead of
    each (the copies run on the side stream; the consumer waits on their
    event), and an error in the producer surfaces at its batch."""
    from dfnet_tpu_torch.data.prefetch import PrefetchIterator

    rng = np.random.default_rng(0)
    host = [(rng.normal(size=(4, 240, 320, 3)).astype(np.float32),
             rng.integers(0, 100, (4, 10)).astype(np.int32)) for _ in range(6)]
    it = PrefetchIterator(lambda i: host[i], range(6), depth=2, device=cuda)
    assert it._stream != torch.cuda.current_stream(cuda)
    busy = torch.randn(2048, 2048, device=cuda)
    for i, (img, hist) in enumerate(it):
        for _ in range(8):
            busy = torch.tanh(busy @ busy * 1e-3)
        assert img.device.type == "cuda" and hist.dtype == torch.int32
        np.testing.assert_array_equal(img.cpu().numpy(), host[i][0])
        np.testing.assert_array_equal(hist.cpu().numpy(), host[i][1])

    def bad(i):
        if i == 1:
            raise ValueError("boom")
        return (host[i][1],)

    with pytest.raises(ValueError, match="boom"):
        list(PrefetchIterator(bad, range(3), depth=1, device=cuda))
