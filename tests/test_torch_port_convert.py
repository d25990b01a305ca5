"""The checkpoint converters, port against dfnet_tpu on the CPU: reference
`.tar` NeRFs (hist and index embeddings), `.pt` DFNets and torchvision
`features.N` VGG16 dicts, each written by one package's exporter (or
seeded in the reference's naming) and read by the other's converter, bit
for bit; the two `convert` CLIs write equal files; a checkpoint missing a
layer raises and names it. Then the loaders: FrozenNeRF from a `.tar`
(renders within the kernel path's 3e-2 of JAX's), FeatureTrainer from a
`.pt` (the pose at training/parity.py's float32 bar, the reference
triplet axis picked when triplet_ref_axis is unset, JAX's first-step loss
within the golden bar), and --vgg_init_path (JAX's converted encoder,
exactly)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu import convert as jconvert
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from dfnet_tpu.models import dfnet as jdf
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.training.checkpoints import load_pytree as jax_load_pytree
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.feature_trainer import FeatureTrainer as JaxFeatureTrainer
from dfnet_tpu.training.nerf_renderer import FrozenNeRF as JaxFrozenNeRF
from dfnet_tpu_torch import convert
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.dfnet import (
    dfnet_params_from_jax,
    dfnet_params_to_jax,
    init_dfnet_params,
)
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.models.vgg import CONV_NAMES, TORCH_CONV_INDEX
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.checkpoints import load_pytree, params_to_numpy, save_pytree
from dfnet_tpu_torch.training.feature_losses import triplet_axis
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

ROOT = __file__.rsplit("/tests/", 1)[0]
SMALL = ["--NeRFH", "--dataset_type", "synthetic", "--netdepth", "2", "--netwidth", "32",
         "--netdepth_fine", "2", "--netwidth_fine", "32", "--N_samples", "16",
         "--N_importance", "16", "--expname", "nerfh"]
WORLD = {"pose_scale": 0.8, "pose_scale2": 1.25, "move_all_cam_vec": [0.1, -0.05, 0.2]}
H, W = 32, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down many times over: this
    module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().cpu().numpy() if hasattr(v, "detach") \
                else np.asarray(v)
    return out


def _equal(got, want):
    """Same paths, and every leaf equal bit for bit, dtype included."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _hist_flags(hist):
    return ["--encode_hist"] if hist else []


@pytest.fixture(scope="module")
def dfnets():
    """(JAX params, state) and the port's (params, state) of two seeded
    full-width DFNets, with non-trivial running statistics."""
    jp, js = jdf.init_dfnet_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    js = {"adapt": {k: {"mean": jnp.asarray(rng.normal(0, 0.1, 128), jnp.float32),
                        "var": jnp.asarray(rng.uniform(0.5, 2.0, 128), jnp.float32)}
                    for k in js["adapt"]}}
    return (jp, js), init_dfnet_params(torch.Generator().manual_seed(5))


def _vgg16_state_dict(seed=2):
    """A seeded torchvision vgg16 state dict: features.N convs in its
    naming, and a classifier the converters must ignore."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for name in CONV_NAMES:
        cout = 64 if name.startswith("conv1") else 128 if name.startswith("conv2") else \
            256 if name.startswith("conv3") else 512
        i = TORCH_CONV_INDEX[name]
        sd[f"features.{i}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * 0.05
        sd[f"features.{i}.bias"] = torch.randn(cout, generator=g) * 0.05
        cin = cout
    sd["classifier.0.weight"] = torch.randn(16, 8, generator=g)
    sd["classifier.0.bias"] = torch.randn(16, generator=g)
    return sd


# ------------------------------------------------------------------ NeRF .tar

@pytest.mark.parametrize("hist", [True, False])
def test_nerf_tar_converts_both_ways_bit_for_bit(tmp_path, hist):
    """A .tar from JAX's exporter reads in the port as JAX reads it; a .tar
    from the port's exporter reads in JAX as the port's own leaves (less
    the proposal net, which a .tar has no place for)."""
    argv = SMALL + _hist_flags(hist)
    _, jparams = jax_create_nerfh(jax_parse_args(argv), jax.random.PRNGKey(0))
    jtar = str(tmp_path / "jax.tar")
    jconvert.export_nerf_checkpoint(jparams, jtar, global_step=7)
    got, meta = convert.convert_nerf_checkpoint(jtar, D=2)
    want, jmeta = jconvert.convert_nerf_checkpoint(jtar, D=2)
    _equal(got, want)
    assert meta == jmeta == {"global_step": 7}
    assert sorted(got) == ["coarse", "embedding_a", "embedding_t", "fine"]
    assert "trans_beta" in got["fine"] and "trans_beta" not in got["coarse"]

    _, params = create_nerfh(parse_args(argv + ["--device", "cpu"]),
                             torch.Generator().manual_seed(3))
    assert "proposal" in params
    ptar = str(tmp_path / "port.tar")
    convert.export_nerf_checkpoint(params, ptar, global_step=9)
    back, jmeta = jconvert.convert_nerf_checkpoint(ptar, D=2)
    assert jmeta == {"global_step": 9}
    _equal(back, {k: v for k, v in params_to_numpy(params).items() if k != "proposal"})
    ref = torch.load(jtar, weights_only=True)
    mine = torch.load(ptar, weights_only=True)
    assert sorted(ref) == sorted(mine)
    for k in ("network_fn_state_dict", "network_fine_state_dict"):
        assert sorted(ref[k]) == sorted(mine[k])


def test_nerf_tar_missing_a_layer_raises_naming_it(tmp_path):
    _, jparams = jax_create_nerfh(jax_parse_args(SMALL), jax.random.PRNGKey(0))
    sd = jconvert.nerfw_params_to_state_dict(jparams["fine"])
    del sd["xyz_encoding_2.0.weight"]
    tar = str(tmp_path / "cut.tar")
    torch.save({"network_fn_state_dict": jconvert.nerfw_params_to_state_dict(
        jparams["coarse"]), "network_fine_state_dict": sd,
        "embedding_a_state_dict": {"weight": torch.zeros(3, 2)},
        "embedding_t_state_dict": {"weight": torch.zeros(3, 2)}}, tar)
    with pytest.raises(KeyError, match="xyz_encoding_2.0.weight"):
        convert.convert_nerf_checkpoint(tar, D=2)
    with pytest.raises(KeyError, match="xyz_encoding_2.0.weight"):
        jconvert.convert_nerf_checkpoint(tar, D=2)


# ------------------------------------------------------------------ DFNet .pt, VGG16

def test_dfnet_pt_converts_both_ways_bit_for_bit(dfnets, tmp_path):
    """A .pt from JAX's exporter reads in the port as
    dfnet_params_from_jax(*JAX's convert); a .pt from the port's exporter
    reads in JAX as dfnet_params_to_jax(port), with the key set (and
    num_batches_tracked) of JAX's."""
    (jp, js), (p, s) = dfnets
    jpt = str(tmp_path / "jax.pt")
    jconvert.export_dfnet_checkpoint(jp, js, jpt)
    got_p, got_s = convert.convert_dfnet_checkpoint(jpt)
    want_p, want_s = dfnet_params_from_jax(*jconvert.convert_dfnet_checkpoint(jpt))
    _equal(got_p, want_p)
    _equal(got_s, want_s)
    assert got_p["encoder"]["conv1_1"]["w"].shape == (64, 3, 3, 3)     # OIHW
    assert got_p["fc_pose"]["w"].shape == (12, 512)

    ppt = str(tmp_path / "port.pt")
    convert.export_dfnet_checkpoint(p, s, ppt)
    back_p, back_s = jconvert.convert_dfnet_checkpoint(ppt)
    want_p, want_s = dfnet_params_to_jax(p, s)
    _equal(back_p, want_p)
    _equal(back_s, want_s)
    ref, mine = torch.load(jpt, weights_only=True), torch.load(ppt, weights_only=True)
    assert list(ref) == list(mine)
    assert int(mine["adaptation_layers.adapt_layer_0.3.num_batches_tracked"]) == 0


def test_vgg16_state_dict_converts_as_jax_does(tmp_path):
    path = str(tmp_path / "vgg16.pth")
    torch.save(_vgg16_state_dict(), path)
    got = convert.convert_vgg16_imagenet(path)
    want = dfnet_params_from_jax(jconvert.convert_vgg16_imagenet(path), {})[0]
    _equal(got, want)
    assert sorted(got) == sorted(CONV_NAMES)


def _run_cli(module, *args):
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_convert_clis_write_equal_files(dfnets, tmp_path):
    """`python -m dfnet_tpu_torch.convert` and the JAX package's `main` on
    the same sources: equal .npz files (keys, arrays, global_step) from a
    .tar, a .pt and a VGG16 dict, and equal reference files exported back
    from an .npz."""
    (jp, js), _ = dfnets
    _, jparams = jax_create_nerfh(jax_parse_args(SMALL + ["--encode_hist"]),
                                  jax.random.PRNGKey(1))
    src = {"tar": str(tmp_path / "nerf.tar"), "pt": str(tmp_path / "dfnet.pt"),
           "vgg": str(tmp_path / "vgg16.pth")}
    jconvert.export_nerf_checkpoint(jparams, src["tar"], global_step=11)
    jconvert.export_dfnet_checkpoint(jp, js, src["pt"])
    torch.save(_vgg16_state_dict(3), src["vgg"])
    cases = [(src["tar"], ["--netdepth", "2"]), (src["pt"], []),
             (src["vgg"], ["--kind", "vgg16"])]
    for i, (s, extra) in enumerate(cases):
        mine, ref = str(tmp_path / f"port{i}.npz"), str(tmp_path / f"jax{i}.npz")
        assert "converted" in _run_cli("dfnet_tpu_torch.convert", s, mine, *extra)
        jconvert.main([s, ref, *extra])
        _npz_equal(mine, ref)
    assert int(load_pytree(str(tmp_path / "port0.npz"))[1]["global_step"]) == 11

    # export: the shared npz back to the reference's formats
    for i, ext in ((0, "tar"), (1, "pt")):
        npz = str(tmp_path / f"jax{i}.npz")
        mine, ref = str(tmp_path / f"port_back.{ext}"), str(tmp_path / f"jax_back.{ext}")
        convert.main([npz, mine])
        jconvert.main([npz, ref])
        a, b = torch.load(mine, weights_only=True), torch.load(ref, weights_only=True)
        flat = lambda d: {k: v for k, v in d.items() if not isinstance(v, dict)} | {
            f"{k}/{j}": w for k, v in d.items() if isinstance(v, dict) for j, w in v.items()}
        a, b = flat(a), flat(b)
        assert sorted(a) == sorted(b)
        for k in b:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


# ------------------------------------------------------------------ loaders

def test_frozen_nerf_loads_a_tar_and_renders_as_jax(tmp_path, capsys):
    """Both packages' FrozenNeRF.from_experiment on a reference .tar (no
    proposal net: the port's kernel path places samples with the coarse
    net, as JAX's fast path does): one view within 3e-2 (the kernel path's
    bar), and the params equal to JAX's converted ones."""
    _, jparams = jax_create_nerfh(jax_parse_args(SMALL + ["--encode_hist"]),
                                  jax.random.PRNGKey(0))
    (tmp_path / "nerfh").mkdir()
    jconvert.export_nerf_checkpoint(jparams, str(tmp_path / "nerfh" / "000003.tar"), 3)
    argv = SMALL + ["--encode_hist", "--basedir", str(tmp_path)]
    sc = jax_scene(n_train=1, n_val=2, H=12, W=16, focal=15.0, seed=0)
    jnerf = JaxFrozenNeRF.from_experiment(jax_parse_args(argv), sc.hwf, sc.near, sc.far,
                                          WORLD)
    nerf = FrozenNeRF.from_experiment(parse_args(argv + ["--device", "cpu"]), sc.hwf,
                                      sc.near, sc.far, WORLD)
    assert capsys.readouterr().out.count("000003.tar") == 2
    assert "proposal" not in nerf.params and nerf.uses_fast_render
    _equal(nerf.params, jax.tree.map(np.asarray, jnerf.params))
    want = np.asarray(jnerf.render_at_pose(sc.val.poses[1], sc.val.hists[1]))
    got = nerf.render_at_pose(sc.val.poses[1], sc.val.hists[1]).numpy()
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_feature_trainer_from_a_pt_matches_jax(tmp_path):
    """FeatureTrainer of both packages from one reference .pt, the state
    dict of the reference-replica DFNet the golden step starts from
    (tests/test_torch_parity.py, torch.manual_seed(3)), under the golden
    step's flags with triplet_ref_axis unset: val poses within
    parity.EVAL_POSE_TOL, the reference triplet axis picked on both sides,
    and the first step's loss on the golden batch within parity.LOSS_TOL."""
    from test_torch_parity import _TorchDFNet

    torch.manual_seed(3)
    pt = str(tmp_path / "released.pt")
    torch.save(_TorchDFNet().state_dict(), pt)
    flags = [f for f in parity.GOLDEN_FLAGS]
    i = flags.index("--triplet_ref_axis")
    del flags[i:i + 2]
    argv = flags + ["--featurenet_batch_size", "4", "--basedir", str(tmp_path),
                    "--pretrain_model_path", pt, "--aot_cache_dir", ""]
    sc = make_synthetic_scene(n_train=4, n_val=2, H=H, W=W, focal=40.0)
    from test_torch_port_feature import _jax_scene

    jt = JaxFeatureTrainer(jax_parse_args(argv, stage="feature"), _jax_scene(sc), None)
    t = FeatureTrainer(parse_args(argv + ["--device", "cpu"], stage="feature"), sc, None)
    assert parse_args(argv, stage="feature").triplet_ref_axis is None
    assert t.triplet_axis == triplet_axis(True)

    x = sc.val.images
    _, jpose, _ = jdf.dfnet_forward(jt.params, jt.state, jnp.asarray(x))
    ok, err = parity.eval_agreement(t.predict(t.images(x)), torch.tensor(np.asarray(jpose)))
    assert ok, err

    batch = parity.golden_batch()
    jbatch = [jnp.asarray(b.permute(0, 2, 3, 1).numpy()) if b.ndim == 4 else
              jnp.asarray(b.numpy()) for b in batch]
    loss_j = float(jt._loss_fn(jt.params, jt.state, *jbatch)[0])
    loss, _ = parity.loss_and_grads(t, batch)
    assert abs(loss - loss_j) < parity.LOSS_TOL


def test_vgg_init_path_gives_jax_converted_encoder(tmp_path, capsys):
    path = str(tmp_path / "vgg16.pth")
    torch.save(_vgg16_state_dict(4), path)
    sc = make_synthetic_scene(n_train=2, n_val=1, H=H, W=W, focal=40.0)
    t = FeatureTrainer(parse_args(["--DFNet", "--vgg_init_path", path, "--device", "cpu",
                                   "--basedir", str(tmp_path)], stage="feature"), sc, None)
    assert f"ImageNet VGG16 init from {path}" in capsys.readouterr().out
    want = jconvert.convert_vgg16_imagenet(path)
    _equal(dfnet_params_to_jax(t.params["encoder"], {})[0], want)
    assert t.triplet_axis == triplet_axis(False)       # no .pt: the channel axis


def test_shared_npz_of_a_converted_pt_loads_in_jax(dfnets, tmp_path):
    """The port's `main` on a .pt writes the shared JAX-layout .npz: the
    JAX package's loader reads it to JAX's own convert of that .pt."""
    (jp, js), _ = dfnets
    pt, npz = str(tmp_path / "m.pt"), str(tmp_path / "m.npz")
    jconvert.export_dfnet_checkpoint(jp, js, pt)
    convert.main([pt, npz])
    tree, _ = jax_load_pytree(npz)
    want_p, want_s = jconvert.convert_dfnet_checkpoint(pt)
    _equal(tree["params"], want_p)
    _equal(tree["state"], want_s)
    jax_save_pytree(str(tmp_path / "j.npz"), {"params": want_p, "state": want_s})
    _npz_equal(npz, str(tmp_path / "j.npz"))
    save_pytree(str(tmp_path / "p.npz"), {"params": tree["params"], "state": tree["state"]})
    _npz_equal(npz, str(tmp_path / "p.npz"))
