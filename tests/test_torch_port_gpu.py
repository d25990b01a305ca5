"""The port's CUDA kernels against their plain PyTorch versions on a card:
coarse_sigma_t, fine_raw_t (fine and static packs), fine_composite_t,
raw_bwd_t, proposal_z_rows (the mono path's sampler) and the layer-stack
probe's mlp_stack_bf16 / mlp_stack_int8, a NaN through the kernels'
forward ReLU; and the port's other paths on the card against the CPU
(stages 2 and 3, the data layer, the vanilla NeRF, the backbone zoo).

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

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

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
@pytest.mark.parametrize("N,S,W,static", [
    (19200, 128, 128, False),    # nerfh_w128.render_exact: a view in one chunk
    (4096, 192, 256, True),      # nerf_vanilla.train: the fine net's static sweep
    (19200, 24, 128, False),     # nerfh_w128.render_culled
    (19201, 24, 128, False),     # the same with a ragged last tile and spare consumers
])
def test_fine_raw_kernel_matches_plain_at_the_cells_shapes(cuda, N, S, W, static):
    """fine_raw_t at the benchmark cells' sweep shapes (D=8 skip 4), where
    each persistent block walks many rounds of tiles: against fine_raw_plain
    under the FLIP_SHARE rule at TOL_RAW, one launch counted, and a second
    call gives the same bits."""
    packed, spec, ro, rd, z, dpt, _ = _sweep_inputs(8, W, 4, static, N, S, cuda, N + S)
    args = (packed, ro, rd, z, dpt, spec)
    nk.reset_launches()
    got = nk.fine_raw_t(*args)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["fine_raw_t"] == 1
    assert got.shape == (spec.n_raw, N, S)
    _flip_close(got, nk.fine_raw_plain(*args), TOL_RAW)
    assert torch.equal(got, nk.fine_raw_t(*args))


@pytest.mark.gpu
def test_fine_raw_kernel_occupancy_and_width_limit(cuda):
    """One persistent block an SM at W <= 128 and at W = 256, its shared
    memory past the fine pack's consumer tiles (four of 32 KB at W=128, two
    of 56 KB at W=256) by at least two weight-ring stages; a wider net
    raises."""
    for W, tiles, stage in ((128, 4 * 32 * 1024, 16 * 1024), (256, 2 * 56 * 1024, 32 * 1024)):
        blocks, smem = nk.fine_raw_occupancy(W, 10)
        assert blocks == 1, W
        assert tiles + 2 * stage < smem <= 227 * 1024, (W, smem)
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
    fine_raw_t's rows on the card at 1e-5 (the same trunk, dt and transient
    activations, bit for bit, so only the heads' and the composite's sums
    run in another order); one launch counted; a second call gives the same
    bits."""
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
@pytest.mark.parametrize("D,W,skip,S", [(4, 64, 2, 24), (2, 256, 1, 64),
                                        (8, 256, 5, 64)])   # the original NeRF's trunk
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
@pytest.mark.parametrize("D,W,skip,S", [(8, 128, 4, 24), (2, 256, 1, 64), (8, 128, 4, 12),
                                        (8, 256, 5, 64), (4, 256, 2, 192)])
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


def _probe_pack(packed, spec, depth, cols):
    """The first `depth` trunk layers of `packed` with a tail whose fine_raw_t
    outputs are trunk layer depth - 1's activations at `cols`, exactly: sigma
    reads cols[0]; the dt layer copies cols[1:4] into d, and on the fine pack
    cols[4:9] into t0, which the identity transient chain carries to t3; the
    rgb and transient heads read those copies. Zero biases, so each output
    is one bf16 activation times 1 (its spec and pack)."""
    skip = spec.skip if spec.skip < depth else -1
    sp = nk.KernelSpec(D=depth, W=spec.W, skip=skip, F=spec.F, fine=spec.fine,
                       static=spec.static)
    v = nk.unpack(packed, spec)
    half = spec.W // 2
    parts = {n: v[n] for n, _ in nk._layout(sp)[0] if n in v and n[0] == "w" and n[1] != "_"}
    parts["b_trunk"] = v["b_trunk"][:depth]
    ws, bs = nk._layout(sp)
    for name, shape in ws + bs:
        if name not in parts:
            parts[name] = torch.zeros(shape, device=packed["w"].device)
    parts["w_heads"][3, cols[0]] = 1
    for k, c in enumerate(cols[1:4]):
        parts["w_dt"][k, c] = 1
        parts["w_heads"][k, k] = 1
    if spec.fine:
        for k, c in enumerate(cols[4:9]):
            parts["w_dt"][half + k, c] = 1
            parts["w_heads"][4 + k, half + k] = 1
        for i in range(3):
            parts[f"w_tr{i}"] = torch.eye(half, device=packed["w"].device)
    return sp, {"w": nk._flat(parts, ws, torch.bfloat16).contiguous(),
                "b": nk._flat(parts, bs, torch.float32).contiguous(), "freqs": packed["freqs"]}


@pytest.mark.gpu
@pytest.mark.parametrize("D,W,skip,S,static,N", [
    (8, 128, 4, 12, False, 37), (8, 128, 4, 64, True, 37), (8, 256, 5, 64, True, 37),
    (2, 256, 1, 24, False, 37),
    (4, 128, 2, 64, False, 600),   # 600 tiles: both kernels' blocks walk a second round
])
def test_raw_bwd_stash_trunk_matches_the_forward_sweep(cuda, D, W, skip, S, static, N):
    """The trunk activations bwd_stash recomputes (h0 .. h{D-1}) against those
    fine_raw_t computes on the same points, bit for bit: the backward's ReLU
    masks are the forward's. fine_raw_t runs the net cut after each layer,
    with a tail that copies that layer's activations to its outputs
    (_probe_pack; 4 columns a launch on the static pack, 9 on the fine). The
    share of activations that differ is held at zero."""
    packed, spec, ro, rd, z, dpt, g = _sweep_inputs(D, W, skip, static, N, S, cuda, 11)
    launches, _, stash = nk.raw_bwd_launches(packed, ro, rd, z, dpt, g, spec)
    dict(launches)["stash"]()
    views = nk.bwd_stash_views(stash, spec, N, S)
    per = spec.n_raw
    differ = {}
    for depth in range(1, D + 1):
        h = views[f"h{depth - 1}"].float()
        seen = torch.empty_like(h)
        for c0 in range(0, W, per):
            cols = [(c0 + k) % W for k in range(per)]
            sp, probe = _probe_pack(packed, spec, depth, cols)
            out = nk.fine_raw_t(probe, ro, rd, z, torch.zeros_like(dpt), sp).reshape(per, -1)
            # output row r reads column cols[order[r]]: sigma (row 3) cols[0]
            order = [1, 2, 3, 0] + list(range(4, per))
            for r in range(per):
                seen[:, cols[order[r]]] = out[r]
        differ[f"h{depth - 1}"] = (seen != h).float().mean().item()
    assert all(v == 0.0 for v in differ.values()), differ


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


@pytest.mark.gpu
def test_trainer_views_pack_once_on_the_card(cuda, tmp_path):
    """Two views through the trainer's render on the card: the first packs
    the weights (a miss), the second reuses them (a hit), and each is
    bit-equal to the view rendered with a fresh pack."""
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.render import fast
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    cfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                      "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
                      "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
                      "--expname", "nerfh", "--basedir", str(tmp_path), "--device", "cuda"])
    sc = make_synthetic_scene(n_train=2, n_val=2, H=12, W=16, focal=16.0, seed=0)
    tr = NeRFTrainer(cfg, sc)
    assert tr.uses_fast_render
    before = dict(fast.PACKS)
    for i in range(2):
        pose = torch.as_tensor(sc.val.poses[i], dtype=torch.float32, device=cuda)
        hist = torch.as_tensor(sc.val.hists[i], device=cuda)
        got = tr._render(tr.params, pose, hist, 0)
        want = fast.render_image_fast(tr.params, tr.model, pose, hist, sc.H, sc.W, sc.focal,
                                      tr.settings_test, chunk=sc.H * sc.W)
        torch.cuda.synchronize()
        for k in ("rgb", "disp", "acc"):
            assert torch.equal(got[k], want[k]), (i, k)
    assert {k: fast.PACKS[k] - before[k] for k in before} == {"hits": 1, "misses": 1}


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


# ------------------------------------------------------------------ NaN, the alternate models

@pytest.mark.gpu
@pytest.mark.parametrize("W", [128, 256])
def test_forward_relu_carries_nan(cuda, W):
    """A NaN in one hidden weight: fine_raw_t (the shipped trunk, fine pack)
    and mlp_stack_bf16 give NaN exactly where their plain versions do, as
    the TPU kernels' jnp.maximum does (fmaxf(NaN, 0) is 0). With the NaN
    taken out, each gives the bits it gave before it went in."""
    cfg = NeRFWConfig(D=8, W=W, skips=(4,), encode_appearance=True, encode_transient=True)
    params = init_nerfw_params(torch.Generator().manual_seed(W), cfg, cuda)
    emb = get_embedder(10)
    spec = nk.spec_of(cfg, emb, fine=True)
    ro, rd = _rays(37, seed=W, device=cuda)
    rng = np.random.default_rng(W)
    z = torch.tensor(np.sort(rng.uniform(NEAR, FAR, (37, 64)), -1).astype(np.float32),
                     device=cuda)
    dpt = torch.tensor(rng.normal(size=(37, spec.Wd)).astype(np.float32), device=cuda)

    def sweep():
        packed = {k: v.detach() for k, v in nk.pack_fine_t(params, cfg, emb).items()}
        args = (packed, ro, rd, z, dpt, spec)
        got = nk.fine_raw_t(*args)
        torch.cuda.synchronize()
        return got, nk.fine_raw_plain(*args)

    before, _ = sweep()
    assert torch.isfinite(before).all()
    w = params["xyz_2"]["w"]
    keep = float(w[5, 7])
    w[5, 7] = float("nan")
    got, want = sweep()
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    w[5, 7] = keep
    assert torch.equal(sweep()[0], before)

    x, ws = ms.probe_inputs("bf16", W, 1000, 3, cuda)
    before = ms.mlp_stack_bf16(x, ws)
    torch.cuda.synchronize()
    assert torch.isfinite(before).all()
    keep = ws[1, 3, 5].clone()
    ws[1, 3, 5] = float("nan")
    got, want = ms.mlp_stack_bf16(x, ws), ms.mlp_stack_bf16_plain(x, ws)
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ws[1, 3, 5] = keep
    assert torch.equal(ms.mlp_stack_bf16(x, ws), before)


@pytest.mark.gpu
def test_vanilla_render_on_the_card_matches_the_cpu(cuda):
    """The vanilla NeRF (NeRFH=False) at the shipped widths (D=8 W=128,
    skip 4, 64 + 64 samples), float32 with TF32 off: the coarse and fine
    passes within 1e-4 of the CPU, the fine z within 2e-3, the whole render
    within the rendered-rgb bar (training/parity.py::vanilla_render_agreement),
    and no kernel launched."""
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
    from dfnet_tpu_torch.training import parity

    cfg = parse_args(["--NeRFH", "False", "--device", "cpu"], stage="nerf")
    model, params = create_nerfh(cfg)
    assert type(model).__name__ == "VanillaNeRFModel" and model.cfg_fine.W == 128
    ro, rd = _rays(2048, seed=1, device="cpu")
    ro = ro * 0.2
    rd[:, 2] = -rd[:, 2].abs() - 1.0
    nk.reset_launches()
    ok, info = parity.vanilla_render_agreement(params, model, ro, rd,
                                               render_settings(cfg, NEAR, FAR, test=True),
                                               cuda)
    assert ok, info
    assert not any(nk.LAUNCHES.values()), nk.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [
    ("posenetv2", (2, 3, 64, 64)), ("efficientnet_b0", (2, 3, 37, 45)),
    ("efficientnet_b3", (2, 3, 33, 33)), ("resnet34_posenet", (2, 3, 64, 64)),
    ("mapnet", (2, 3, 3, 64, 64)), ("autoencoder_vgg1", (1, 3, 36, 36)),
    ("autoencoder_vgg2", (1, 3, 36, 36)), ("autoencoder_vgg3", (1, 3, 64, 64)),
    ("autoencoder_vgg4", (1, 3, 64, 64)), ("autoencoder_vgg5", (1, 3, 64, 64)),
    ("autoencoder_vgg6", (1, 3, 64, 64)), ("autoencoder_vgg7", (1, 3, 64, 64))])
def test_zoo_forward_on_the_card_matches_the_cpu(cuda, name, shape):
    """Each backbone family's float32 forward (TF32 off) at the CPU tests'
    input sizes, card against CPU, under the CPU tests' bars times each
    output's scale (training/parity.py::zoo_agreement)."""
    from dfnet_tpu_torch.training import parity

    x = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    ok, ratio = parity.zoo_agreement(name, x, cuda)
    assert ok, ratio


# ---------------------------------------------------------------------------
# the data mesh (parallel/mesh.py): two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

def _mesh_on_card():
    from dfnet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(2, "cuda", share_device=True)


@pytest.mark.gpu
def test_collectives_on_cuda_tensors_over_gloo(cuda):
    """gather_rows (uneven rows, forward and backward) and all_reduce_grads_
    (a leaf without a grad on rank 0) on CUDA tensors of two ranks sharing
    cuda:0 over gloo, against their closed forms on every rank."""
    from dfnet_tpu_torch.parallel.checks import collectives
    from dfnet_tpu_torch.parallel.mesh import launch

    res = launch(collectives, _mesh_on_card(), "cuda:0")
    assert len(res) == 2
    for r in res:
        assert r["device"] == "cuda:0"
        for k in ("gathered", "grad"):
            np.testing.assert_array_equal(r[k], r["want_" + k], err_msg=k)
        for k in ("a", "b", "extra"):
            np.testing.assert_allclose(r[k], r["want_" + k], rtol=1e-6, err_msg=k)


@pytest.mark.gpu
def test_stage1_step_world2_on_one_card_matches_world1(cuda):
    """The stage-1 kernel step (D=2 W=32, 16 + 16 samples, 301 rays,
    perturb and sigma noise on) at world 2, two ranks sharing cuda:0, against
    world 1 on the card: the loss and MSE within rtol 1e-5, every grad
    within one bf16 rounding of each rank's share, of the one-device grad
    and of the leaf's scale (the kernel returns the packed weights' grads in
    bf16, so each rank's share is rounded before the sum; the CPU tests'
    bar, tests/test_torch_port_mesh.py::_bf16_bar), and each rank launches
    fine_raw_t and raw_bwd_t twice."""
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.parallel.checks import stage1_step
    from dfnet_tpu_torch.parallel.mesh import launch

    cfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                      "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
                      "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
                      "--N_rand", "301", "--raw_noise_std", "0.5", "--device", "cuda"],
                     stage="nerf")
    sc = make_synthetic_scene(n_train=3, n_val=1, H=24, W=32, focal=30.0, seed=0)
    mesh = _mesh_on_card()
    w1 = stage1_step(cfg, sc, idx=1)
    w2 = launch(stage1_step, mesh, cfg, sc, None, mesh, 1)
    assert w1["fused"] and w2["fused"]
    assert np.isclose(w2["loss"], w1["loss"], rtol=1e-5, atol=0), (w2["loss"], w1["loss"])
    assert np.isclose(w2["mse"], w1["mse"], rtol=1e-5, atol=0)
    for k, w in w1["grads"].items():
        g, w = np.asarray(w2["grads"][k], np.float64), np.asarray(w, np.float64)
        bound = 2.0 ** -8 * (sum(np.abs(s[k]) for s in w2["shares"]) + np.abs(w)
                             + max(np.abs(w).max(), 1e-12))
        assert (np.abs(g - w) <= bound).all(), k
    for counts in w2["launches"]:
        assert counts["fine_raw_t"] == 2 and counts["raw_bwd_t"] == 2, w2["launches"]


@pytest.mark.gpu
@pytest.mark.parametrize("nf", [32, 12])
def test_culled_kernel_step_on_the_card_matches_the_plain_step(cuda, nf):
    """The culled stage-1 step (--train_cull_q 2e-3 --train_fine_total nf,
    the shipped D=8 W=128 nets, 64 placement samples, perturb 0, no sigma
    noise) after three culled epochs from the seeded init, on 301 rays of
    a train view: the card's kernel step against the same step on the CPU,
    whose wrappers run their plain versions, and against the card's plain
    render_rays step at bf16 matmul operands (parity.bf16_model), each
    under the fused-train bars of training/parity.py (fine z 2e-3, rgb0 /
    rgb / beta / acc 5e-3, loss rtol 1e-3, every non-proposal gradient
    3e-2 of its scale + 3e-7)."""
    import dataclasses

    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.training import parity
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    cfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                      "--train_cull_q", "2e-3", "--train_fine_total", str(nf),
                      "--N_rand", "512", "--lrate", "5e-3", "--device", "cuda"],
                     stage="nerf")
    tr = NeRFTrainer(cfg, make_synthetic_scene(n_train=4, n_val=1, H=24, W=32, focal=30.0,
                                               seed=0))
    assert tr.uses_fused_train
    for epoch in range(3):
        tr.train_epoch(epoch)
    st = dataclasses.replace(tr.settings, perturb=0.0, raw_noise_std=0.0)
    ro, rd, target, hist = tr.draw_batch(1)
    ro, rd, target = ro[:301], rd[:301], target[:301]
    hist = hist[None].expand(301, -1)
    args = (tr.params, parity.bf16_model(tr.model), cfg, st)
    nk.reset_launches()
    card = parity.train_step(*args, ro, rd, target, hist, True)
    # both sweeps of the outputs' no-grad render and of the step
    assert nk.LAUNCHES["fine_raw_t"] == 4 and nk.LAUNCHES["raw_bwd_t"] == 2
    assert card[1]["z_all"].shape == (301, nf)
    host = [t.cpu() for t in (ro, rd, target, hist)]
    ok, info = parity.train_step_agreement(card, parity.train_step(*args, *host, True))
    assert ok, info
    ok, info = parity.train_step_agreement(card, parity.train_step(*args, ro, rd, target,
                                                                   hist, False))
    assert ok, info


def _homographies(n: int, seed: int) -> np.ndarray:
    from dfnet_tpu_torch.utils import homography as hom

    rng = np.random.default_rng(seed)
    return np.linalg.inv(np.stack([hom.sample_homography_np((2, 2), shift=-1, rng=rng)
                                   for _ in range(n)]))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_homography_warp_on_the_card_matches_the_cpu(cuda, mode):
    from dfnet_tpu_torch.utils import homography as hom

    Hinv = _homographies(4, seed=0)
    img = np.random.default_rng(1).uniform(size=(4, 60, 80, 3)).astype(np.float32)
    got = hom.inv_warp_image_batch(torch.as_tensor(img, device=cuda),
                                   torch.as_tensor(Hinv, device=cuda), mode)
    assert got.device.type == "cuda"
    want = hom.inv_warp_image_batch(img, Hinv, mode, device="cpu")
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    pts = np.random.default_rng(2).uniform(-1, 1, (500, 2))
    torch.testing.assert_close(hom.warp_points(pts, Hinv, device=cuda).cpu(),
                               hom.warp_points(pts, Hinv, device="cpu"), atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
def test_valid_mask_on_the_card_matches_the_cpu(cuda, r):
    from dfnet_tpu_torch.utils import homography as hom

    Hinv = _homographies(3, seed=3)
    got = hom.compute_valid_mask((61, 80), torch.as_tensor(Hinv, device=cuda), r)
    want = hom.compute_valid_mask((61, 80), Hinv, r, device="cpu")
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)
    if r:
        base = hom.compute_valid_mask((61, 80), Hinv, device=cuda)
        assert torch.equal(hom.erode(base, r).cpu(), hom.erode(base.cpu(), r))
