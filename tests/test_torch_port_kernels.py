"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against dfnet_tpu's Pallas kernels in interpret mode, on the same numpy
inputs and params. Small nets (D <= 4 with a skip, narrow W, one W=256
D=2 case), at most two ray tiles of the JAX kernel. Tolerances: raw
pre-activation outputs 2e-2, composited outputs 3e-2 (bf16 operands in
both, rounded at other places)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.models import nerfw as jnerfw
from dfnet_tpu.models.embedder import get_embedder as jax_embedder
from dfnet_tpu.ops import nerf_kernels as jnk
from dfnet_tpu_torch.models import nerfw as tnerfw
from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.training.checkpoints import params_from_numpy

NEAR, FAR = 0.5, 3.5


def _nets(D, W, skip, F, fine, seed=0):
    kw = dict(D=D, W=W, skips=(skip,) if skip > 0 else (), in_xyz=6 * F + 3,
              in_dir=27, encode_appearance=fine, encode_transient=fine)
    jc = jnerfw.NeRFWConfig(**kw)
    key = jax.random.PRNGKey(seed)
    jp = (jnerfw.init_nerfw_params(key, jc) if fine
          else jnerfw.init_sigma_mlp(key, jc))
    return jc, jp, tnerfw.NeRFWConfig(**kw), params_from_numpy(
        jax.tree.map(np.asarray, jp))


def _rays(N, seed):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _dpt(jc, jp, tc, tp, N, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 27)).astype(np.float32)
    a = rng.normal(size=(N, 50)).astype(np.float32)
    t = rng.normal(size=(N, 20)).astype(np.float32)
    want = jnk.per_ray_row(jp, jc, *map(jnp.asarray, (d, a, t)))
    got = nk.per_ray_row(tp, tc, *map(torch.tensor, (d, a, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    return want, got


@pytest.mark.parametrize("D,W,skip,F,S", [
    (2, 64, -1, 4, 64),      # the proposal net's shape
    (4, 32, 2, 10, 32),      # narrow trunk with a skip
    (2, 256, 1, 10, 64),     # wide branch
])
def test_coarse_sigma_plain_matches_pallas(D, W, skip, F, S):
    jc, jp, tc, tp = _nets(D, W, skip, F, fine=False)
    spec_j = jnk.KernelSpec(D=D, skip=skip, F=F, fine=False, pe_mac=(F == 4))
    N = 2 * jnk.coarse_ray_tile(S, W)
    ro, rd = _rays(N, seed=D * 10 + W)
    want = jnk.coarse_sigma_t(jnk.pack_coarse_t(jp, jc, jax_embedder(F)),
                              jnp.asarray(ro), jnp.asarray(rd), spec_j, S,
                              NEAR, FAR, interpret=True)
    packed = nk.pack_coarse_t(tp, tc, get_embedder(F))
    spec = nk.spec_of(tc, get_embedder(F), fine=False)
    got = nk.coarse_sigma_t(packed, torch.tensor(ro), torch.tensor(rd), spec,
                            S, NEAR, FAR)
    assert got.shape == (N, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("D,W,skip,S", [(4, 32, 2, 64), (2, 256, 1, 64)])
def test_fine_raw_plain_matches_pallas(D, W, skip, S):
    F = 10
    jc, jp, tc, tp = _nets(D, W, skip, F, fine=True)
    N = 2 * jnk.ray_tile(S, W)
    ro, rd = _rays(N, seed=W)
    z = np.sort(np.random.default_rng(W).uniform(NEAR, FAR, (N, S)),
                -1).astype(np.float32)
    dpt_j, dpt_t = _dpt(jc, jp, tc, tp, N, seed=W + 1)
    spec_j = jnk.KernelSpec(D=D, skip=skip, F=F, fine=True)
    want = jnk.fine_raw_t(jnk.pack_fine_t(jp, jc, jax_embedder(F)),
                          jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                          dpt_j, spec_j, interpret=True)
    packed = nk.pack_fine_t(tp, tc, get_embedder(F))
    spec = nk.spec_of(tc, get_embedder(F), fine=True)
    got = nk.fine_raw_t(packed, torch.tensor(ro), torch.tensor(rd),
                        torch.tensor(z), dpt_t, spec)
    assert got.shape == (nk.N_RAW, N, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:nk.N_RAW],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("D,W,skip,S", [(4, 32, 2, 24), (2, 256, 1, 24)])
def test_fine_composite_plain_matches_pallas(D, W, skip, S):
    F = 10
    jc, jp, tc, tp = _nets(D, W, skip, F, fine=True, seed=1)
    N = jnk.ray_tile(S, W)
    ro, rd = _rays(N, seed=W + 2)
    z = np.sort(np.random.default_rng(W + 3).uniform(NEAR, FAR, (N, S)),
                -1).astype(np.float32)
    dpt_j, dpt_t = _dpt(jc, jp, tc, tp, N, seed=W + 4)
    z_rows = jnp.zeros((8, N * S), jnp.float32).at[0].set(jnp.asarray(z).reshape(-1))
    spec_j = jnk.KernelSpec(D=D, skip=skip, F=F, fine=True)
    want = jnk.fine_composite_t(jnk.pack_fine_t(jp, jc, jax_embedder(F)),
                                jnp.asarray(ro), jnp.asarray(rd), z_rows,
                                dpt_j, spec_j, interpret=True)
    packed = nk.pack_fine_t(tp, tc, get_embedder(F))
    spec = nk.spec_of(tc, get_embedder(F), fine=True)
    got = nk.fine_composite_t(packed, torch.tensor(ro), torch.tensor(rd),
                              torch.tensor(z), dpt_t, spec)
    assert got.shape == (nk.N_COMP, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-2, rtol=3e-2)


def test_plain_composite_equals_composite_of_plain_raw():
    """fine_composite_t's plain version is fine_raw_t's plus compositing."""
    from dfnet_tpu_torch.render.fast import composite_soa

    jc, jp, tc, tp = _nets(2, 64, 1, 10, fine=True, seed=2)
    N, S = 9, 24
    ro, rd = _rays(N, seed=5)
    z = torch.tensor(np.sort(np.random.default_rng(6).uniform(NEAR, FAR, (N, S)),
                             -1).astype(np.float32))
    dpt = torch.tensor(np.random.default_rng(7).normal(size=(N, 64)).astype(np.float32))
    packed = nk.pack_fine_t(tp, tc, get_embedder(10))
    spec = nk.spec_of(tc, get_embedder(10), fine=True)
    ro, rd = torch.tensor(ro), torch.tensor(rd)
    comp = nk.fine_composite_t(packed, ro, rd, z, dpt, spec)
    ref = composite_soa(nk.fine_raw_t(packed, ro, rd, z, dpt, spec), z)
    np.testing.assert_allclose(comp[0:3].t().numpy(), ref["rgb"].numpy(), atol=1e-5)
    np.testing.assert_allclose(comp[3].numpy(), ref["acc"].numpy(), atol=1e-5)
    np.testing.assert_allclose(comp[4].numpy(), ref["depth"].numpy(), atol=1e-4)
    np.testing.assert_allclose(comp[5:8].t().numpy(),
                               ref["rgb_static_only"].numpy(), atol=1e-5)


def test_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain version and leave the launch counts."""
    jc, jp, tc, tp = _nets(2, 64, -1, 4, fine=False)
    nk.reset_launches()
    ro, rd = _rays(5, seed=8)
    nk.coarse_sigma_t(nk.pack_coarse_t(tp, tc, get_embedder(4)),
                      torch.tensor(ro), torch.tensor(rd),
                      nk.spec_of(tc, get_embedder(4), fine=False), 8, NEAR, FAR)
    nk.proposal_z_rows(nk.pack_coarse_t(tp, tc, get_embedder(4)),
                       torch.tensor(ro), torch.tensor(rd),
                       nk.spec_of(tc, get_embedder(4), fine=False), 8, 12, NEAR, FAR, 0.5)
    from dfnet_tpu_torch.ops import mlp_stack as ms

    ms.mlp_stack_int8(*ms.probe_inputs("int8", 32, 8, 2, "cpu"))
    ms.mlp_stack_bf16(*ms.probe_inputs("bf16", 32, 8, 2, "cpu"))
    assert nk.LAUNCHES == {"coarse_sigma_t": 0, "fine_raw_t": 0,
                           "fine_composite_t": 0, "raw_bwd_t": 0,
                           "proposal_z_rows": 0, "mlp_stack_bf16": 0,
                           "mlp_stack_int8": 0}
