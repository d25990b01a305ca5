"""Stage 2 on the data mesh (dfnet_tpu_torch/parallel/mesh.py), world 2
against world 1 in the port and against the JAX package's make_mesh(2),
on the CPU, in float32.

World 2 is two gloo processes spawned by mesh.launch, which import only
the port and run dfnet_tpu_torch/parallel/checks.py; one launch serves
every case. Each rank encodes its share of the siamese images and of the
RVS views, the taps and pooled features are gathered, and the adapt
branch, BatchNorm (train mode here, so its statistics and running stats
are the batch's), the triplet's rolled negatives, the hard-negative case
and the pose head run on every rank; the grads are averaged. World 1 runs
in this process on one torch thread, as each rank does: the encoder is
batch-invariant on the CPU, and the same thread count sums the replicated
head in the same order, so the two worlds differ only where the mesh
splits a sum (a threaded head flips ReLU masks of the adapt branch where a
pre-activation sits at float32 rounding of zero, moving grads by up to a
few percent: training/parity.py). Bars: the loss within rtol 1e-5, the BN
running stats within 1e-5, every grad within 1e-5 of its scale (the
largest magnitude of the leaf or of the ranks' summed shares, whose
float32 sum the all-reduce takes). Against JAX (its trainer under
make_mesh(2), the batch sharded by its constraints, run eagerly as
tests/test_torch_port_feature.py runs the golden step): that test's config
and init and the golden stage-2 bars. The control, every rank skipping
the grads' all-reduce, must miss the world-1 bar."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.convert import convert_dfnet_checkpoint
from dfnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.feature_trainer import FeatureTrainer as JaxFeatureTrainer
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.dfnet import (
    dfnet_params_from_jax,
    dfnet_params_to_jax,
    init_dfnet_params,
)
from dfnet_tpu_torch.parallel import checks
from dfnet_tpu_torch.parallel.mesh import Mesh, launch
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.checkpoints import save_pytree
from dfnet_tpu_torch.training.nerf_trainer import named_leaves
from test_torch_parity import _TorchDFNet
from test_torch_port_feature import _jax_scene
from test_torch_port_mesh import _close

TOL = 1e-5
JAX_ONLY = ["--aot_cache_dir", "", "--compilation_cache_dir", ""]
TRAIN_BN = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic", "--DFNet",
            "--tripletloss", "--random_view_synthesis", "--combine_loss_w", "0.3,0.4,0.5",
            "--feature_precision", "fp32"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    return make_synthetic_scene(n_train=4, n_val=2, H=32, W=48, focal=40.0, seed=0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A seeded port DFNet (train-BN cases) and the golden step's init (the
    reference replica of torch.manual_seed(3) through JAX's converter), as
    checkpoints both packages load; the golden batch."""
    base = tmp_path_factory.mktemp("mesh_train")
    params, state = init_dfnet_params(torch.Generator().manual_seed(5))
    seeded = str(base / "seeded.npz")
    save_pytree(seeded, dict(zip(("params", "state"), dfnet_params_to_jax(params, state))))
    torch.manual_seed(3)
    tnet = _TorchDFNet()
    with tempfile.TemporaryDirectory() as d:
        pt = os.path.join(d, "ckpt.pt")
        torch.save(tnet.state_dict(), pt)
        jp, js = convert_dfnet_checkpoint(pt)
    golden = str(base / "golden.npz")
    jax_save_pytree(golden, {"params": jp, "state": js})
    return dict(base=base, seeded=seeded, golden=golden,
                batch=[b.numpy() for b in parity.golden_batch()])


def _argv(s, flags, ckpt, b=4):
    return flags + ["--featurenet_batch_size", str(b), "--basedir", str(s["base"]),
                    "--pretrain_model_path", ckpt]


@pytest.fixture(scope="module")
def runs(setup):
    s = setup
    cfg = lambda flags, ckpt: parse_args(_argv(s, flags, ckpt) + ["--device", "cpu"],
                                         stage="feature")
    cases = {
        "train_bn": ("stage2_step", dict(cfg=cfg(TRAIN_BN, s["seeded"]), scene=_scene(),
                                         batch=s["batch"])),
        "batch3": ("stage2_step", dict(cfg=cfg(TRAIN_BN, s["seeded"]), scene=_scene(),
                                       batch=[b[:3] for b in s["batch"]])),
        "golden": ("stage2_step", dict(cfg=cfg(parity.GOLDEN_FLAGS, s["golden"]),
                                       scene=_scene(), batch=s["batch"])),
    }
    control = ("stage2_step", dict(cases["train_bn"][1], skip_reduce=True))
    mesh = Mesh(2, "cpu")
    world2 = launch(checks.run_all, mesh, [(f, dict(kw, mesh=mesh)) for f, kw in
                                           list(cases.values()) + [control]])
    world1 = checks.run_all(list(cases.values()))
    return dict(zip(cases, world1)), dict(zip(list(cases) + ["control"], world2))


@pytest.mark.parametrize("case", ["train_bn", "batch3", "golden"])
def test_stage2_step_world2_matches_world1(runs, case):
    """Batch 4 (8 siamese images and 4 RVS views: 4 + 2 encoded a rank),
    batch 3 (3 + 3 siamese, 2 + 1 RVS) and the golden config (freezeBN,
    the reference triplet axis): the loss, the BN running statistics and
    every grad."""
    w1, w2 = runs[0][case], runs[1][case]
    assert np.isclose(w2["loss"], w1["loss"], rtol=TOL, atol=0), (w2["loss"], w1["loss"])
    for (k, g), (_, w) in zip(named_leaves(w2["state"]), named_leaves(w1["state"])):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)
    assert _close(w2["grads"], w1["grads"], shares=w2["shares"]) < 1
    assert len(w2["shares"]) == 2 and len(w2["grads"]) >= 30


def test_train_bn_running_stats_move(runs):
    """The train-mode cases update BN's running statistics (from the
    init's zeros and ones); under freezeBN they stay."""
    for case, moved in (("train_bn", True), ("golden", False)):
        state = runs[1][case]["state"]["adapt"]["0"]
        assert (np.abs(state["mean"]).max() > 1e-6) == moved, case


def test_stage2_world2_matches_jax_make_mesh_2(runs, setup):
    """The golden step's config and init: JAX's loss (its trainer's
    _loss_fn, the batch sharded over make_mesh(2)) and grads against the
    port's world 2 under the golden stage-2 bars on every leaf; the
    freezeBN-cancelled adapt conv2 bias below 1e-6 on both sides."""
    s = setup
    jcfg = jax_parse_args(_argv(s, parity.GOLDEN_FLAGS, s["golden"]) + JAX_ONLY,
                          stage="feature")
    jt = JaxFeatureTrainer(jcfg, _jax_scene(_scene()), None, mesh=jax_make_mesh(2))
    jbatch = [jnp.asarray(b.transpose(0, 2, 3, 1)) if b.ndim == 4 else jnp.asarray(b)
              for b in s["batch"]]
    loss, g = jax.value_and_grad(lambda p: jt._loss_fn(p, jt.state, *jbatch)[0])(jt.params)
    ref = {k: v.numpy() for k, v in named_leaves(dfnet_params_from_jax(g, {})[0])}
    w2 = runs[1]["golden"]
    ok, info = parity.golden_agreement(w2["loss"], w2["grads"], float(loss), ref)
    assert ok, info
    assert info["grad_err"]["adapt/2/conv2/b"] < parity.ZERO_GRAD


def test_control_skipping_the_grad_reduce_fails(runs):
    """Every rank keeps its own grads: rank 0's encoder grads are twice its
    images' share, far outside the bar."""
    assert _close(runs[1]["control"]["grads"], runs[0]["train_bn"]["grads"],
                  shares=runs[1]["train_bn"]["shares"]) > 100
