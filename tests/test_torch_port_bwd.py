"""raw_bwd_t's split into a stash and a grouped weight-grad GEMM, on the CPU.

The card runs raw_bwd_t as three launches (ops/csrc/raw_bwd.cu): bwd_stash
writes each weight's input activation A_l and masked output cotangent G_l
to a bf16 stash, bwd_wgrad computes every problem of the table
`bwd_problems` builds, bwd_reduce sums the chunks and d_dpt. Here the plain
stash (`raw_bwd_stash_plain`) goes through the same table with one float32
torch.matmul a problem (`raw_bwd_from_stash_plain`), and must give
`raw_bwd_plain`'s gradients: a wrong offset, pairing, row range or bias
slot in the table shows here without a card. Tolerance: atol 1e-5 (the
same float32 products, grouped otherwise), and for the bf16 d_w one bf16
step of rtol, since a sum that lands on a rounding midpoint may round the
other way. The plain backward itself is held against the JAX package in
tests/test_torch_port_train.py; here the split is also carried into the
params and held against the JAX package's raw sweep VJP.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.nerfw import NeRFWConfig, init_nerfw_params
from dfnet_tpu_torch.ops import nerf_kernels as nk

NEAR, FAR = 0.5, 3.5
N, S = 37, 24


def _inputs(static, D=4, W=32, skip=2, seed=3):
    cfg = NeRFWConfig(D=D, W=W, skips=(skip,), encode_appearance=True,
                      encode_transient=True)
    params = init_nerfw_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    emb = get_embedder(10)
    packed = (nk.pack_static_t if static else nk.pack_fine_t)(params, cfg, emb)
    packed = {k: v.detach() for k, v in packed.items()}
    spec = nk.spec_of(cfg, emb, fine=not static, static=static)
    rng = np.random.default_rng(seed)
    ro = torch.tensor((rng.normal(size=(N, 3)) * 0.3).astype(np.float32))
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd = torch.tensor(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    z = torch.tensor(np.sort(rng.uniform(NEAR, FAR, (N, S)), -1).astype(np.float32))
    dpt = torch.tensor(rng.normal(size=(N, spec.Wd)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(spec.n_raw, N, S)).astype(np.float32))
    return packed, ro, rd, z, dpt, g, spec


@pytest.mark.parametrize("static", [False, True], ids=["fine", "static"])
def test_stash_through_problem_table_gives_plain_grads(static):
    packed, ro, rd, z, dpt, g, spec = _inputs(static)
    stash = nk.raw_bwd_stash_plain(packed, ro, rd, z, dpt, g, spec)
    got = nk.raw_bwd_from_stash_plain(stash, spec, N, S)
    want = nk.raw_bwd_plain(packed, ro, rd, z, dpt, g, spec)
    assert got[0].dtype == torch.bfloat16 and got[2].shape == (N, spec.Wd)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=1e-5, rtol=2 ** -8)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=0)
    # every weight and bias gradient is reached (the heads' off-blocks are 0)
    named = nk.unpack({"w": got[0], "b": got[1]}, spec)
    for name, t in named.items():
        assert t.abs().sum() > 0, name


@pytest.mark.parametrize("static", [False, True], ids=["fine", "static"])
def test_problem_table_covers_each_gradient_once(static):
    """Every packed weight entry outside the heads' zero blocks, and every
    bias, is written by exactly one (problem, row, column)."""
    spec = _inputs(static)[-1]
    Pp = nk.bwd_points(N, S)
    ws, bs = nk._layout(spec)
    nw = sum(int(np.prod(s)) for _, s in ws)
    nb = sum(int(np.prod(s)) for _, s in bs)
    wcount, bcount = np.zeros(nw, int), np.zeros(nb, int)
    R = nk.bwd_stash_offsets(spec, Pp)
    spans = sorted((off, off + Pp * w) for n, (off, w) in R.items() if n != "total" and w)
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0                                   # regions tile the stash
    for go, gld, gcol, ao, ald, acol, M, K, r0, r1, w_off, w_ld, b_off in nk.bwd_problems(
            spec, Pp):
        assert gcol + M <= gld and acol + K <= ald and 0 <= r0 < r1 <= M
        assert M % 16 == 0 and K % 16 == 0          # whole WMMA fragments
        assert go % 8 == ao % 8 == gcol % 8 == acol % 8 == 0   # 16-byte copies
        for r in range(r0, r1):
            wcount[w_off + r * w_ld:w_off + r * w_ld + K] += 1
        if b_off >= 0:
            bcount[b_off + r0:b_off + r1] += 1
    heads = nk.unpack({"w": torch.arange(nw), "b": torch.arange(nb)}, spec)["w_heads"]
    half = spec.W // 2
    zero = torch.cat([heads[0:3, half:].reshape(-1)]
                     + ([heads[4:9, :half].reshape(-1)] if spec.fine else []))
    expect = np.ones(nw, int)
    expect[zero.numpy()] = 0
    assert (wcount == expect).all()
    assert (bcount == 1).all()


@pytest.mark.parametrize("N_,S_,n_sm", [(37, 24, 132), (1536, 128, 132), (1536, 64, 132),
                                        (1, 2, 4)])
def test_wgrad_chunks_split_the_stash(N_, S_, n_sm):
    Pp = nk.bwd_points(N_, S_)
    spec = _inputs(False)[-1]
    jobs = nk.bwd_jobs(nk.bwd_problems(spec, Pp))
    chunk, n_chunks = nk.bwd_chunks(Pp, len(jobs), n_sm)
    assert Pp % nk.BWD_TILE == 0 and chunk % nk.BWD_TILE == 0
    assert (n_chunks - 1) * chunk < Pp <= n_chunks * chunk
    if Pp >= 1 << 16:
        assert len(jobs) * n_chunks >= 2 * n_sm             # enough blocks to fill the card


@pytest.mark.parametrize("static", [False, True], ids=["fine", "static"])
def test_stash_backward_matches_jax_raw_sweep(static):
    """The whole split, as RawSweep's backward would run it (stash, problem
    table, chunk sums), carried through the pack into the params, against
    the JAX package's raw sweep VJP (its Pallas backward in interpret
    mode) on the same seeded params and inputs: each leaf within
    3e-2 * scale + 1e-7, the bar of tests/test_torch_port_train.py."""
    import jax
    import jax.numpy as jnp

    import dfnet_tpu.render.fused_train as jft
    from dfnet_tpu.models import nerfw as jnerfw
    from dfnet_tpu.models.embedder import get_embedder as jax_embedder
    from dfnet_tpu.ops import nerf_kernels as jnk
    from dfnet_tpu_torch.models import nerfw as tnerfw
    from dfnet_tpu_torch.training.checkpoints import params_from_numpy
    from dfnet_tpu_torch.training.nerf_trainer import named_leaves

    D, W, skip, F, S_ = 4, 64, 2, 10, 64
    fine = not static
    kw = dict(D=D, W=W, skips=(skip,), in_xyz=6 * F + 3, in_dir=27,
              encode_appearance=fine, encode_transient=True)
    jc, tc = jnerfw.NeRFWConfig(**kw), tnerfw.NeRFWConfig(**kw)
    jp = jax.tree.map(np.asarray, jnerfw.init_nerfw_params(jax.random.PRNGKey(7), jc))
    N_ = 2 * jnk.tile_geometry(S_, target=1024)[0]       # two JAX ray tiles
    rng = np.random.default_rng(11)
    ro = (rng.normal(size=(N_, 3)) * 0.3).astype(np.float32)
    rd = rng.normal(size=(N_, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(NEAR, FAR, (N_, S_)), -1).astype(np.float32)
    d = rng.normal(size=(N_, 27)).astype(np.float32)
    a = rng.normal(size=(N_, 50)).astype(np.float32)
    t = rng.normal(size=(N_, 20)).astype(np.float32)
    rows = nk.N_RAW if fine else nk.N_STATIC
    g = rng.uniform(size=(rows, N_, S_)).astype(np.float32)   # one-signed, as a loss gives
    spec_j = jnk.KernelSpec(D=D, skip=skip, F=F, fine=fine)

    def jax_raw(p):
        pack = (jnk.pack_fine_t if fine else jnk.pack_static_t)(p, jc, jax_embedder(F))
        dpt = (jnk.per_ray_row(p, jc, d, a, t) if fine
               else jnk.per_ray_row_static(p, jc, d))
        return jft.raw_sweep_ad(pack, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                                dpt, spec_j, True)

    _, vjp = jax.vjp(jax_raw, jax.tree.map(jnp.asarray, jp))
    g16 = np.zeros((jnk.OUT_ROWS, N_, S_), np.float32)
    g16[:rows] = g
    want = {p: np.asarray(v) for p, v in named_leaves(vjp(jnp.asarray(g16))[0])}

    tp = params_from_numpy(jp)
    for _, leaf in named_leaves(tp):
        leaf.requires_grad_(True)
    emb = get_embedder(F)
    packed = (nk.pack_fine_t if fine else nk.pack_static_t)(tp, tc, emb)
    dpt = (nk.per_ray_row(tp, tc, *map(torch.tensor, (d, a, t))) if fine
           else nk.per_ray_row_static(tp, tc, torch.tensor(d)))
    spec = nk.spec_of(tc, emb, fine=fine, static=static)
    args = ({k: v.detach() for k, v in packed.items()}, torch.tensor(ro), torch.tensor(rd),
            torch.tensor(z), dpt.detach(), torch.tensor(g), spec)
    stash = nk.raw_bwd_stash_plain(*args)
    d_w, d_b, d_dpt = nk.raw_bwd_from_stash_plain(stash, spec, N_, S_)
    torch.autograd.backward([packed["w"], packed["b"], dpt], [d_w, d_b, d_dpt])
    checked = 0
    for path, leaf in named_leaves(tp):
        got = np.zeros(leaf.shape) if leaf.grad is None else leaf.grad.numpy()
        w_ = np.asarray(want[path], np.float64)
        scale = max(np.abs(got).max(), np.abs(w_).max(), 1e-6)
        err = np.abs(got - w_).max()
        assert err < 3e-2 * scale + 1e-7, f"{path}: err {err:.2e} scale {scale:.2e}"
        checked += 1
    assert checked == len(want)
