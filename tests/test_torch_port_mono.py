"""The mono render path and the layer-stack probe, port against dfnet_tpu
on the CPU: the in-kernel sampler (proposal_z_rows, plain version here)
against JAX's Pallas kernel in interpret mode, the mono render against
JAX's mono render, the schedule gate that sends a mono call down the
two-kernel path, and the probe's plain stacks against the JAX probe's
kernels. Tolerances are the JAX package's own: fine z 2e-3
(tests/test_fast_render.py:239), rendered outputs 3e-2 (:200-202); the bf16
stacks are held under ops/mlp_stack.py's bf16_stack_agreement, which must
tell a sound stack from each of the probe's faulty controls."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.models.factory import render_settings as jax_render_settings
from dfnet_tpu.ops import nerf_kernels as jnk
from dfnet_tpu.render.fast import FastNeRFH as JaxFastNeRFH
from dfnet_tpu.render.fast import render_rays_fast as jax_render_rays_fast
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.ops import mlp_stack as ms
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.ops.tolerances import FLIP_CAP, FLIP_SHARE, TOL_Z
from dfnet_tpu_torch.render import fast as fast_mod
from dfnet_tpu_torch.scripts import bench_int8_wide as probe
from dfnet_tpu_torch.training.checkpoints import params_from_numpy

SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16"]
NEAR, FAR = 0.5, 3.5
TOL_RENDER = 3e-2


@pytest.fixture(scope="module")
def small():
    """A small NeRF-H with the default proposal (D=2, W=64, F=4), its JAX
    params copied into the port."""
    jcfg = jax_parse_args(SMALL, stage="nerf")
    jmodel, jparams = jax_create_nerfh(jcfg, jax.random.PRNGKey(0))
    cfg = parse_args(SMALL + ["--device", "cpu"], stage="nerf")
    model, _ = create_nerfh(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, cfg, model, params


def _rays(N, seed):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(N, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _close_z(got, want):
    """Fine z within TOL_Z, but for a FLIP_SHARE of the samples (a bf16
    rounding flip moves one CDF edge), none beyond FLIP_CAP x TOL_Z; every
    row sorted."""
    err = np.abs(got - want)
    assert (err > TOL_Z).sum() <= FLIP_SHARE * err.size, err.max()
    assert err.max() <= FLIP_CAP * TOL_Z, err.max()
    assert (np.diff(got, axis=-1) >= 0).all()


def test_proposal_z_rows_matches_jax_interpret(small):
    _, jmodel, jparams, _, model, params = small
    cp = jmodel.cfg_proposal
    assert (cp.D, cp.W, jmodel.embed_proposal.num_freqs) == (2, 64, 4)
    S, S_f = 64, 128
    lam = S / S_f
    N = 2 * jnk.tile_geometry(S, target=2048)[0]          # two sampling tiles
    ro, rd = _rays(N, seed=1)
    jspec = jnk.KernelSpec(D=cp.D, skip=-1, F=jmodel.embed_proposal.num_freqs,
                           fine=False, pe_mac=True)
    jpacked = jnk.pack_coarse_t(jparams["proposal"], cp, jmodel.embed_proposal)
    zr = jnk.proposal_z_rows(jpacked, jnp.asarray(ro), jnp.asarray(rd), jspec, S,
                             S_f, NEAR, FAR, lam, interpret=True)
    want = np.asarray(zr[0]).reshape(N, S_f)

    packed = nk.pack_coarse_t(params["proposal"], model.cfg_proposal,
                              model.embed_proposal)
    spec = nk.spec_of(model.cfg_proposal, model.embed_proposal, fine=False)
    got = nk.proposal_z_rows(packed, torch.tensor(ro), torch.tensor(rd), spec, S,
                             S_f, NEAR, FAR, lam)
    assert got.shape == (N, S_f) and got.dtype == torch.float32
    _close_z(got.numpy(), want)
    assert (got >= NEAR).all() and (got <= FAR).all()
    # a ragged ray count: the port takes any N, JAX only whole tiles
    n = N - 23
    part = nk.proposal_z_rows(packed, torch.tensor(ro[:n]), torch.tensor(rd[:n]),
                              spec, S, S_f, NEAR, FAR, lam)
    _close_z(part.numpy(), want[:n])


def test_proposal_z_plain_is_the_blended_draw(small):
    """proposal_z_plain is sample_pdf_blend over the proposal's composite
    weights; with lam=1 the draw is the uniform grid over the bin edges."""
    _, _, _, _, model, params = small
    packed = nk.pack_coarse_t(params["proposal"], model.cfg_proposal,
                              model.embed_proposal)
    spec = nk.spec_of(model.cfg_proposal, model.embed_proposal, fine=False)
    ro, rd = _rays(5, seed=2)
    S, S_f = 32, 48
    z = nk.proposal_z_plain(packed, torch.tensor(ro), torch.tensor(rd), spec, S, S_f,
                            NEAR, FAR, lam=1.0)
    step = (FAR - NEAR) / (S - 1)
    edges = np.linspace(NEAR + step / 2, FAR - step / 2, S_f)
    np.testing.assert_allclose(z.numpy(), np.broadcast_to(edges, (5, S_f)), atol=1e-5)


@pytest.fixture(scope="module")
def render_case(small):
    jcfg, jmodel, jparams, cfg, model, params = small
    st_j = jax_render_settings(jcfg, NEAR, FAR, test=True)
    st = render_settings(cfg, NEAR, FAR, test=True)
    jfast = JaxFastNeRFH.pack(jparams, jmodel)
    fast = fast_mod.FastNeRFH.pack(params, model)
    assert jfast.packed_proposal is not None and fast.packed_proposal is not None
    N = jfast.ray_align(st_j)
    ro, rd = _rays(N, seed=3)
    hist = np.random.default_rng(4).integers(0, 10, (N, jcfg.hist_bin)).astype(np.int32)
    return jfast, st_j, fast, st, ro, rd, hist


def _jax_render(case, **kw):
    jfast, st_j, _, _, ro, rd, hist = case
    return jax_render_rays_fast(jfast, jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(hist), st_j, interpret=True, **kw)


def _port_render(case, **kw):
    _, _, fast, st, ro, rd, hist = case
    return fast_mod.render_rays_fast(fast, torch.tensor(ro), torch.tensor(rd),
                                     torch.tensor(hist), st, **kw)


def test_mono_render_matches_jax_interpret(render_case, monkeypatch):
    want = _jax_render(render_case, exact_union=False, mono=True)
    calls = []
    orig = nk.proposal_z_rows
    monkeypatch.setattr(nk, "proposal_z_rows",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _port_render(render_case, exact_union=False, mono=True)
    assert calls == [1]
    for k in ("rgb", "acc", "depth", "disp"):
        assert torch.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL_RENDER, rtol=TOL_RENDER, err_msg=k)
    # the mono path matches the port's two-kernel blended path, as in JAX
    blend = _port_render(render_case, exact_union=False, mono=False)
    for k in ("rgb", "acc", "depth", "disp"):
        np.testing.assert_allclose(got[k].numpy(), blend[k].numpy(),
                                   atol=TOL_RENDER, rtol=TOL_RENDER, err_msg=k)


@pytest.mark.parametrize("gate", ["lindisp", "exact_union"])
def test_mono_gate_takes_the_two_kernel_path(render_case, gate, monkeypatch):
    """Where mono is asked for but the sampler cannot serve (lindisp, or the
    exact union), both packages render as if mono were off."""
    import dataclasses

    jfast, st_j, fast, st, ro, rd, hist = render_case
    if gate == "lindisp":
        st_j = dataclasses.replace(st_j, lindisp=True)
        st = dataclasses.replace(st, lindisp=True)
    case = (jfast, st_j, fast, st, ro, rd, hist)
    exact = gate == "exact_union"
    j_mono = _jax_render(case, exact_union=exact, mono=True)
    j_off = _jax_render(case, exact_union=exact, mono=False)

    def refuse(*a, **k):
        raise AssertionError("the gated mono call reached proposal_z_rows")

    monkeypatch.setattr(nk, "proposal_z_rows", refuse)
    p_mono = _port_render(case, exact_union=exact, mono=True)
    p_off = _port_render(case, exact_union=exact, mono=False)
    for k in ("rgb", "acc", "depth", "disp"):
        np.testing.assert_array_equal(np.asarray(j_mono[k]), np.asarray(j_off[k]))
        torch.testing.assert_close(p_mono[k], p_off[k], atol=0, rtol=0)
        np.testing.assert_allclose(p_mono[k].numpy(), np.asarray(j_mono[k]),
                                   atol=TOL_RENDER, rtol=TOL_RENDER, err_msg=k)


def _jax_probe(dtype, D, x, ws, T):
    """The JAX probe's Pallas kernel (scripts/bench_int8_wide.py), built as
    its `build` builds it but in interpret mode: (W, P) features in rows."""
    from scripts.bench_int8_wide import _kernel_bf16, _kernel_int8

    W, P = x.shape[1], x.shape[0]
    kern = _kernel_int8 if dtype == "int8" else _kernel_bf16
    fn = pl.pallas_call(
        functools.partial(kern, D), grid=(P // T,),
        in_specs=[pl.BlockSpec((W, T), lambda i: (0, i))]
        + [pl.BlockSpec((W, W), lambda i: (0, 0))] * D,
        out_specs=pl.BlockSpec((8, T), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((8, P), jnp.float32), interpret=True)
    jdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    return np.asarray(fn(jnp.asarray(x.T).astype(jdt),
                         *[jnp.asarray(w).astype(jdt) for w in ws])).T


@pytest.mark.parametrize("dtype,w_lo,w_hi", [
    ("int8", -4, 4),      # the probe's data: the stack goes to zero
    ("int8", -4, 5),      # centred weights: the requantisation is exercised
    ("bf16", None, None),
])
def test_probe_plain_stacks_match_jax_probe(dtype, w_lo, w_hi):
    W, T, G, D = 128, 256, 2, 2
    P = T * G
    rng = np.random.default_rng(5)
    if dtype == "int8":
        x = rng.integers(0, 64, (P, W)).astype(np.int8)
        ws = rng.integers(w_lo, w_hi, (D, W, W)).astype(np.int8)
        tx, tws = torch.tensor(x), torch.tensor(ws)
    else:
        x = (rng.uniform(size=(P, W)) * 0.5).astype(np.float32)
        ws = (rng.normal(size=(D, W, W)) / np.sqrt(W)).astype(np.float32)
        tx, tws = torch.tensor(x).bfloat16(), torch.tensor(ws).bfloat16()
        # both packages take the same bf16 values
        x, ws = tx.float().numpy(), tws.float().numpy()
    want = _jax_probe(dtype, D, x, ws, T)
    got = (ms.mlp_stack_int8 if dtype == "int8" else ms.mlp_stack_bf16)(tx, tws)
    assert got.shape == (P, ms.N_OUT) and got.dtype == torch.float32
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
        if w_hi == 5:
            assert (want > 0).mean() > 0.1 and len(np.unique(want)) > 2
    else:
        agree = ms.bf16_stack_agreement(got, torch.tensor(want))
        assert agree["ok"], agree


def _reordered_sums(x, ws):
    """A sound bf16 stack that sums each product over k in another order."""
    perm = torch.randperm(x.shape[1], generator=torch.Generator().manual_seed(0))
    return ms.mlp_stack_bf16_plain(x[:, perm], torch.cat([ws[:1, :, perm], ws[1:]]))


@pytest.mark.parametrize("W,D", [(128, 2), (128, 6), (256, 6)])
@pytest.mark.parametrize("stack", ["reordered sums", *probe.CONTROLS])
def test_bf16_agreement_tells_sound_from_faulty_stacks(W, D, stack):
    x, ws = ms.probe_inputs("bf16", W, 4096, D, "cpu")
    want = ms.mlp_stack_bf16_plain(x, ws)
    if stack == "reordered sums":
        agree = ms.bf16_stack_agreement(_reordered_sums(x, ws), want)
        assert agree["ok"] and agree["diff_share"] > 0, agree
    else:
        agree = ms.bf16_stack_agreement(probe.CONTROLS[stack](x, ws), want)
        assert not agree["ok"], agree


def test_probe_inputs_follow_the_reference_distributions():
    x, ws = ms.probe_inputs("int8", 64, 4096, 3, "cpu")
    assert x.dtype == torch.int8 and (x.shape, ws.shape) == ((4096, 64), (3, 64, 64))
    assert int(x.min()) == 0 and int(x.max()) == 63
    assert int(ws.min()) == -4 and int(ws.max()) == 3
    x, ws = ms.probe_inputs("bf16", 64, 4096, 3, "cpu")
    assert x.dtype == torch.bfloat16 and 0 <= float(x.min()) and float(x.max()) <= 0.5
    assert abs(float(ws.float().std()) - 64 ** -0.5) < 0.01
    with pytest.raises(ValueError, match="dtype"):
        ms.probe_inputs("fp8", 64, 16, 1, "cpu")
