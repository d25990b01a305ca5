"""Stage 3 on the data mesh (dfnet_tpu_torch/parallel/mesh.py), world 2
against world 1 in the port and against the JAX package's make_mesh(2),
on the CPU, in float32.

World 2 is two gloo processes spawned by mesh.launch, which import only
the port and run dfnet_tpu_torch/parallel/checks.py. F's forward and the
loss run on every rank; each rank renders half the rays of the predicted
pose with autograd through the plain renderer (FrozenNeRF with the mesh),
the rays are gathered, and the grads averaged, so the pose gradient
reaches both halves. Inputs are training/parity.py::dm_trainer's (the
CPU DM tests' NeRF and DFNet, train view 1, combine_loss_w [0, 0, 1],
svd_reg), rendered at one pose, JAX's predicted pose
(parity.dm_loss_and_grads' render_pose): the DM gradient is rough in the
pose below float32's rounding of it (ROADMAP.md Queue 3). World 1 runs in
this process on one torch thread, as each rank does. Bars: world 2
against world 1, the loss within rtol 1e-5, F's predicted pose within
1e-6, every grad within 1e-5 of its scale (the largest magnitude of the
leaf or of the ranks' summed shares); against JAX, whose FrozenNeRF
splits the render over make_mesh(2) (run eagerly, as
tests/test_torch_port_dm.py runs it), parity.dm_agreement. The control,
every rank skipping the grads' all-reduce, must miss the world-1 bar."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dfnet_tpu.training import dm_trainer as jdm
from dfnet_tpu.training.nerf_renderer import FrozenNeRF as JaxFrozenNeRF
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.dfnet import dfnet_params_from_jax
from dfnet_tpu_torch.parallel import checks
from dfnet_tpu_torch.parallel.mesh import Mesh, launch
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.nerf_trainer import named_leaves
from test_torch_port_feature import _jax_scene
from test_torch_port_mesh import _close

TOL = 1e-5
JAX_ONLY = ["--aot_cache_dir", "", "--compilation_cache_dir", ""]
VIEW = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    sc = make_synthetic_scene(n_train=6, n_val=3, H=48, W=64, focal=60.0, seed=0)
    sc.world_setup = parity.DM_WORLD
    return sc


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """parity.dm_trainer's checkpoints, JAX's DM trainer on them with its
    render split over make_mesh(2), the view, and JAX's predicted pose."""
    base = tmp_path_factory.mktemp("mesh_dm")
    parity.dm_trainer(str(base), "cpu")          # writes nerfh/000005.npz, dfnet.npz
    argv = parity.DM_FLAGS + JAX_ONLY + ["--basedir", str(base), "--pretrain_model_path",
                                         str(base / "dfnet.npz")]
    jcfg = jax_parse_args(argv, stage="dm")
    js = _jax_scene(_scene())
    jnerf = JaxFrozenNeRF.from_experiment(jcfg.replace(tinyimg=True, tinyscale=4.0),
                                          js.hwf, js.near, js.far, js.world_setup,
                                          mesh=jax_make_mesh(2))
    jt = jdm.DMTrainer(jcfg, js, jnerf)
    tr = _scene().train
    view = (tr.images[VIEW], tr.poses[VIEW].reshape(1, 12), tr.hists[VIEW])
    jpose = np.array(jt._predict_pose(jt.params, jnp.asarray(view[0])))[0]
    return dict(base=str(base), jt=jt, view=view, jpose=jpose)


@pytest.fixture(scope="module")
def runs(setup):
    s = setup
    kw = dict(base=s["base"], flags=(), image=s["view"][0], pose12=s["view"][1],
              hist=s["view"][2], render_pose=s["jpose"])
    mesh = Mesh(2, "cpu")
    world2 = launch(checks.run_all, mesh, [("stage3_step", dict(kw, mesh=mesh)),
                                           ("stage3_step", dict(kw, mesh=mesh,
                                                                skip_reduce=True))])
    return checks.stage3_step(**kw), world2[0], world2[1]


def test_stage3_step_world2_matches_world1(runs):
    """The loss, F's predicted pose, every grad of F (dL/dpose is
    fc_pose/b's, non-zero) and no kernel launched on either rank."""
    w1, w2, _ = runs
    assert np.isclose(w2["loss"], w1["loss"], rtol=TOL, atol=0), (w2["loss"], w1["loss"])
    np.testing.assert_allclose(w2["pose"], w1["pose"], atol=1e-6, rtol=0)
    assert _close(w2["grads"], w1["grads"], shares=w2["shares"]) < 1
    assert float(np.abs(w2["grads"]["fc_pose/b"]).max()) > 1e-3
    assert len(w2["launches"]) == 2
    assert not any(v for counts in w2["launches"] for v in counts.values())


def test_stage3_world2_matches_jax_make_mesh_2(runs, setup):
    """JAX's DM loss and F's grads (its render split over make_mesh(2)) at
    its predicted pose against the port's world 2 rendering there, under
    parity.dm_agreement; F's adapt leaves get no gradient on any side."""
    jt = setup["jt"]
    image, pose12, hist = setup["view"]
    (loss, _), g = jax.value_and_grad(
        lambda p: jt._loss_fn(p, jt.nerf.params, jt.feat_params, jnp.asarray(image),
                              jnp.asarray(pose12), jnp.asarray(hist)), has_aux=True)(jt.params)
    ref = {k: v.numpy() for k, v in named_leaves(dfnet_params_from_jax(g, {})[0])}
    w2 = runs[1]
    ok, info = parity.dm_agreement(w2["loss"], w2["grads"], float(loss), ref)
    assert ok, info


def test_control_skipping_the_grad_reduce_fails(runs):
    """Every rank keeps its own grads: rank 0's share of the render's part
    of F's grads comes out twice its rays', far outside the bar."""
    w1, w2, control = runs
    assert _close(control["grads"], w1["grads"], shares=w2["shares"]) > 100
