"""DFNet, port against dfnet_tpu on the CPU: the same params (made by the
JAX package's init_dfnet_params and carried across by the weight bridge)
and the same seeded images through both packages' VGG16 encoder and
dfnet_forward. 32x48 images, the smallest the five 2x2 pools allow.
Tolerances: float32 at atol/rtol 1e-4 (the two packages sum the convs in
other orders); bf16 under the JAX package's own bf16 bars
(dfnet_tpu_torch/training/parity.py, from tests/test_feature_bf16.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.convert import export_dfnet_checkpoint as jax_export_dfnet
from dfnet_tpu.models import dfnet as jdf
from dfnet_tpu.models import vgg as jvgg
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.feature_trainer import load_dfnet_params as jax_load_dfnet
from dfnet_tpu_torch.models import vgg
from dfnet_tpu_torch.models.dfnet import (
    DFNet,
    DFNetConfig,
    conv_precision,
    dfnet_forward,
    dfnet_params_from_jax,
    dfnet_params_to_jax,
    init_dfnet_params,
)
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.checkpoints import save_pytree
from dfnet_tpu_torch.training.feature_trainer import load_dfnet_params

TOL = 1e-4
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


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_feats(got, want, tol=TOL):
    """Port features (L, B, C, H, W) against JAX's (L, B, H, W, C)."""
    _close(got.permute(0, 1, 3, 4, 2), want, tol)


@pytest.fixture(scope="module")
def nets():
    """{'full'|'small': (jax params, jax state, port params, port state)} with
    non-trivial running statistics, and 6 seeded images (NHWC numpy)."""
    out = {}
    rng = np.random.default_rng(1)
    for name, jcfg in (("full", jdf.DFNetConfig()), ("small", jdf.DFNetConfig.small())):
        jp, js = jdf.init_dfnet_params(jax.random.PRNGKey(0), jcfg)
        js = {"adapt": {k: {"mean": jnp.asarray(rng.normal(0, 0.1, 128), jnp.float32),
                            "var": jnp.asarray(rng.uniform(0.5, 2.0, 128), jnp.float32)}
                        for k in js["adapt"]}}
        out[name] = (jp, js) + dfnet_params_from_jax(jp, js)
    x = np.random.default_rng(0).random((6, H, W, 3), np.float32)
    return out, x


@pytest.mark.parametrize("run_to_end", [True, False])
def test_vgg16_features_match_jax(nets, run_to_end):
    (jp, _, p, _), x = nets[0]["full"], nets[1]
    taps = ("conv1_2", "conv3_3", "conv5_3")
    jx = jvgg.imagenet_normalize(jnp.asarray(x[:2]))
    jfinal, jtaps = jvgg.vgg16_features(jp["encoder"], jx, taps, run_to_end)
    final, got = vgg.vgg16_features(p["encoder"], vgg.imagenet_normalize(_nchw(x[:2])),
                                    taps, run_to_end)
    assert len(got) == 3
    _close(final.permute(0, 2, 3, 1), jfinal)
    for a, b in zip(got, jtaps):
        _close(a.permute(0, 2, 3, 1), b)
    if not run_to_end:          # the early exit returns the last tap itself
        assert final is got[-1]
    assert vgg.CONV_NAMES == jvgg.CONV_NAMES
    assert vgg.TORCH_CONV_INDEX == jvgg.TORCH_CONV_INDEX


CASES = {
    # name: (net, images, dfnet_forward kwargs)
    "single_eval_bn": ("full", 2, dict(is_single_stream=True)),
    "siamese_train_bn": ("full", 4, dict(train_bn=True)),
    "feature_count": ("full", 6, dict(train_bn=True, feature_count=4)),
    "siamese_eval_bn": ("full", 4, dict(train_bn=False)),
    "small_train_bn": ("small", 4, dict(train_bn=True)),
    "features_only": ("full", 4, dict(train_bn=True, return_pose=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dfnet_forward_matches_jax(nets, case):
    """Features, pose and the BN running-stat update (train mode: batch
    stats over exactly the first feature_count images; eval mode: the
    state unchanged) at float32."""
    net, n, kw = CASES[case]
    (jp, js, p, s), x = nets[0][net], nets[1][:n]
    jcfg = jdf.DFNetConfig.small() if net == "small" else jdf.DFNetConfig()
    cfg = DFNetConfig.small() if net == "small" else DFNetConfig()
    jf, jpose, jns = jdf.dfnet_forward(jp, js, jnp.asarray(x), jcfg, return_feature=True,
                                       upsample_h=H, upsample_w=W, **kw)
    f, pose, ns = dfnet_forward(p, s, _nchw(x), cfg, return_feature=True,
                                upsample_h=H, upsample_w=W, **kw)
    assert len(f) == len(jf)
    for a, b in zip(f, jf):
        assert a.dtype == torch.float32
        _close_feats(a, b)
    if kw.get("return_pose", True):
        assert pose.shape == (n, 12)
        _close(pose, jpose)
    else:
        assert pose is None and jpose is None
    for lvl in js["adapt"]:
        for k in ("mean", "var"):
            _close(ns["adapt"][lvl][k], jns["adapt"][lvl][k])
    if not kw.get("train_bn"):
        assert all(ns["adapt"][k] is s["adapt"][k] for k in s["adapt"])


def test_dfnet_forward_upsamples_to_another_size(nets):
    """Features of the conv3_3 and conv5_3 taps are smaller than the image:
    the bilinear align_corners upsample, to a size unlike the image's."""
    (jp, js, p, s), x = nets[0]["full"], nets[1][:2]
    jf, _, _ = jdf.dfnet_forward(jp, js, jnp.asarray(x), return_feature=True,
                                 is_single_stream=True, upsample_h=20, upsample_w=36)
    f, _, _ = dfnet_forward(p, s, _nchw(x), return_feature=True, is_single_stream=True,
                            upsample_h=20, upsample_w=36)
    assert f[0].shape == (3, 2, 128, 20, 36)
    _close_feats(f[0], jf[0])


def test_bf16_forward_and_grads_track_float32(nets):
    """The port's bf16 path against its float32 path under the JAX
    package's bf16 bars, and its bf16 pose against JAX's bf16 pose."""
    (jp, js, p, s), x = nets[0]["full"], nets[1][:4]
    ok, info = parity.bf16_agreement(p, s, _nchw(x))
    assert ok, info
    _, jpose, _ = jdf.dfnet_forward(jp, js, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    _, pose, _ = dfnet_forward(p, s, _nchw(x), compute_dtype=torch.bfloat16)
    assert pose.dtype == torch.float32
    ref = float(np.abs(np.asarray(jpose)).max())
    assert float(np.abs(pose.numpy() - np.asarray(jpose)).max()) < parity.BF16_POSE * max(ref, 1)


def test_bridge_round_trip_is_bit_exact(nets):
    jp, js, p, s = nets[0]["full"]
    assert p["encoder"]["conv1_1"]["w"].shape == (64, 3, 3, 3)
    assert p["fc_pose"]["w"].shape == (12, 512)
    assert p["adapt"]["0"]["conv2"]["w"].shape == (128, 64, 5, 5)
    rp, rs = dfnet_params_to_jax(p, s)
    assert jax.tree.structure(rp) == jax.tree.structure(jp)
    assert jax.tree.structure(rs) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(rp) + jax.tree.leaves(rs),
                    jax.tree.leaves(jp) + jax.tree.leaves(js)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoints_load_in_both_directions(nets, tmp_path):
    """A JAX-written checkpoint loads through the port's load_dfnet_params,
    a port-written one through JAX's, each with forwards equal to the
    writer's; so does a reference .pt of JAX's exporter."""
    (jp, js, _, _), x = nets[0]["full"], nets[1][:2]
    jpath = str(tmp_path / "jax.npz")
    jax_save_pytree(jpath, {"params": jp, "state": js}, epoch=3)
    p, s = load_dfnet_params(jpath)
    _, jpose, _ = jdf.dfnet_forward(jp, js, jnp.asarray(x))
    _close(dfnet_forward(p, s, _nchw(x))[1], jpose)

    p2, s2 = init_dfnet_params(torch.Generator().manual_seed(5))
    tpath = str(tmp_path / "port.npz")
    save_pytree(tpath, dict(zip(("params", "state"), dfnet_params_to_jax(p2, s2))), epoch=4)
    jp2, js2 = jax_load_dfnet(tpath, jdf.DFNetConfig())
    _, jpose2, _ = jdf.dfnet_forward(jp2, js2, jnp.asarray(x))
    _close(dfnet_forward(p2, s2, _nchw(x))[1], jpose2)
    pt = str(tmp_path / "model.pt")
    jax_export_dfnet(jp, js, pt)
    p3, s3 = load_dfnet_params(pt)
    _close(dfnet_forward(p3, s3, _nchw(x))[1], jpose)


def test_dfnet_module_holds_the_params_and_state(nets):
    """DFNet: the tree's leaves as Parameters under their paths, a forward
    equal to dfnet_forward's, and a train-BN forward that replaces state."""
    (_, _, p, s), x = nets[0]["full"], nets[1][:4]
    net = DFNet(p, s)
    keys = set(net.state_dict())
    assert "tree.encoder.conv5_3.w" in keys and "tree.adapt.2.bn_scale" in keys
    assert len(keys) == 2 * 13 + 3 * 6 + 2
    assert all(t.requires_grad for t in net.parameters())
    feats, pose = net(_nchw(x), return_feature=True, train_bn=True,
                      upsample_h=H, upsample_w=W)
    want_f, want_pose, want_s = dfnet_forward(p, s, _nchw(x), return_feature=True,
                                              train_bn=True, upsample_h=H, upsample_w=W)
    torch.testing.assert_close(pose, want_pose, rtol=0, atol=0)
    torch.testing.assert_close(feats[1], want_f[1], rtol=0, atol=0)
    torch.testing.assert_close(net.state["adapt"]["1"]["var"], want_s["adapt"]["1"]["var"])
    assert net.state is not s


@pytest.mark.parametrize("dtype,grad", [
    (torch.float32, True),            # a training step
    (torch.float32, False),           # predict / validate
    (torch.bfloat16, True),           # bf16 keeps every default
])
def test_conv_precision_sets_and_restores_the_flags(dtype, grad):
    """conv_precision: for float32, with or without grad, cuDNN and the
    matmuls' TF32 off; for bf16 the caller's flags; the caller's flags back
    on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.enabled, matmul.allow_tf32
    cudnn.enabled = matmul.allow_tf32 = True
    try:
        with torch.set_grad_enabled(grad), conv_precision(dtype):
            assert cudnn.enabled == matmul.allow_tf32 == (dtype != torch.float32)
        assert cudnn.enabled and matmul.allow_tf32
    finally:
        cudnn.enabled, matmul.allow_tf32 = before
