"""The backbone zoo, port against dfnet_tpu on the CPU: MobileNetV2 /
PoseNetV2, EfficientNet-B0/B3 and its APR, ResNet34 with the legacy
PoseNet and MapNet heads (the autoencoders and VGG19's index taps are in
tests/test_torch_port_zoo_ae.py).

Params are made by the JAX package's inits (BatchNorm params and running
stats then drawn from a seeded numpy generator, so eval mode normalises by
something other than identity) and carried across with
models/layers.py::params_from_jax. Inputs are seeded numpy arrays at the
JAX tests' sizes, and the bars are theirs: MobileNetV2 3e-4
(tests/test_mobilenet.py:73), EfficientNet-B0 2e-3 and B3 3e-3
(test_efficientnet.py:138,142), ResNet34 3e-4 (test_resnet.py:106).
BatchNorm's updated running stats are held at 1e-6; the converters from
torchvision-named state dicts bit for bit."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.models import efficientnet as jeff
from dfnet_tpu.models import mobilenet as jmob
from dfnet_tpu.models import resnet as jres
from dfnet_tpu_torch.models import efficientnet as eff
from dfnet_tpu_torch.models import mobilenet as mob
from dfnet_tpu_torch.models import resnet as res
from dfnet_tpu_torch.models.layers import params_from_jax, params_to_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(params, state, seed):
    """Seeded BatchNorm scales/biases and running stats in both JAX trees."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            return t
        if set(t) == {"scale", "bias"}:
            c = t["scale"].shape[0]
            return {"scale": jnp.asarray(rng.normal(1.0, 0.1, c), jnp.float32),
                    "bias": jnp.asarray(rng.normal(0.0, 0.05, c), jnp.float32)}
        if set(t) == {"mean", "var"}:
            c = t["mean"].shape[0]
            return {"mean": jnp.asarray(rng.normal(0.0, 0.05, c), jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}
        return {k: walk(v) for k, v in t.items()}

    return walk(params), walk(state)


def _images(shape, seed, lo=0.0, hi=1.0):
    """(B, H, W, 3) numpy, and the same as an NCHW tensor."""
    x = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return x, torch.tensor(x).permute(0, 3, 1, 2)


def _close(got, want, atol, rtol=0.0):
    """An NCHW (or any other) port tensor against JAX's NHWC array."""
    got = got.detach().float()
    want = np.asarray(want, np.float32)
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


def _close_tree(got, want, atol, rtol=0.0):
    g = params_to_jax(got)

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)
    walk(g, want)


def _bitwise_tree(got, want_jax):
    """A port tree equals the JAX tree carried across, leaf for leaf, bit
    for bit."""
    want = params_from_jax(want_jax)

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
    walk(got, want)


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("jmod,tmod", [(jmob, mob), (jeff, eff), (jres, res)],
                         ids=["mobilenet", "efficientnet", "resnet"])
def test_batchnorm_train_mode_matches_jax(jmod, tmod):
    """Each family's BatchNorm (its own momentum and eps) on one input, in
    train and in eval mode: outputs at 1e-5, new running stats at 1e-6."""
    from dfnet_tpu_torch.models.layers import batchnorm

    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (4, 9, 11, 16)).astype(np.float32)
    jp = {"scale": rng.normal(1, 0.1, 16).astype(np.float32),
          "bias": rng.normal(0, 0.1, 16).astype(np.float32)}
    js = {"mean": rng.normal(0, 0.1, 16).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    jbn = getattr(jmod, "_batchnorm", None) or jmod._bn
    for train in (True, False):
        jy, jns = jbn(jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, js),
                      jnp.asarray(x), train)
        ty, tns = batchnorm(_t(jp), _t(js), torch.tensor(x).permute(0, 3, 1, 2), train,
                            tmod.BN_MOMENTUM, tmod.BN_EPS)
        _close(ty, jy, 1e-5, 1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]), atol=1e-6,
                                       rtol=1e-6)


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


# ---------------------------------------------------------------- MobileNetV2

@pytest.fixture(scope="module")
def mobilenet():
    params, state = jmob.init_posenetv2_params(jax.random.PRNGKey(0))
    return _randomize_bn(params, state, 1)


# In train mode the last blocks normalise by the statistics of 2 x 2 x 2 = 8
# values a channel (B=2 at 64x64), which amplify float32 rounding: on these
# inputs JAX's own final features are 1.58e-3 from a float64 run of the same
# network, the port's 4.4e-4. So train-mode features are held at 3e-3 (about
# twice JAX's own error), eval mode at the JAX test's 3e-4. The running
# stats a whole network's train step leaves inherit those differences: JAX's
# own are up to 1.13e-5 (MobileNetV2) and 4.3e-6 (ResNet34) of 1 + |value|
# from float64, so they are held at 3e-5; BatchNorm alone, on the same
# input, is held at 1e-6 (test_batchnorm_train_mode_matches_jax).
TRAIN_BN_ATOL = 3e-3
TRAIN_BN_STATS = 3e-5


@pytest.mark.parametrize("train_bn", [False, True])
def test_mobilenet_features_and_block17_tap(mobilenet, train_bn):
    jp, js = mobilenet
    backbone = {k: v for k, v in jp.items() if k != "fc_pose"}
    x, xt = _images((2, 64, 64, 3), 0)
    jf, jt, jns = jmob.mobilenet_features(backbone, js, jnp.asarray(x), train_bn)
    tf_, tt, tns = mob.mobilenet_features(params_from_jax(backbone), params_from_jax(js),
                                          xt, train_bn)
    atol = TRAIN_BN_ATOL if train_bn else 3e-4
    _close(tf_, jf, atol)
    _close(tt[17], jt[17], atol)
    _close_tree(tns, jns, TRAIN_BN_STATS, TRAIN_BN_STATS)


@pytest.mark.parametrize("single", [False, True])
def test_posenetv2_heads(mobilenet, single):
    jp, js = mobilenet
    x, xt = _images((4, 64, 64, 3), 2)
    jfeat, jpose, _ = jmob.posenetv2_forward(jp, js, jnp.asarray(x), is_train=True,
                                             is_single_stream=single)
    tfeat, tpose, _ = mob.posenetv2_forward(params_from_jax(jp), params_from_jax(js), xt,
                                            is_train=True, is_single_stream=single)
    _close(tpose, jpose, 3e-4)
    assert tfeat[0].shape[:2] == ((1, 4) if single else (2, 2))
    _close(tfeat[0].flatten(0, 1), np.asarray(jfeat[0]).reshape((-1,) + jfeat[0].shape[2:]),
           3e-4)


def test_mobilenet_init_shapes_match_jax():
    tp, ts = mob.init_posenetv2_params(torch.Generator().manual_seed(0))
    jp, js = jmob.init_posenetv2_params(jax.random.PRNGKey(0))
    want = params_from_jax(jp)
    assert [tuple(a.shape) for a in _leaves(tp)] == [tuple(a.shape) for a in _leaves(want)]
    assert [tuple(a.shape) for a in _leaves(ts)] == [tuple(a.shape) for a in
                                                      _leaves(params_from_jax(js))]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _mobilenet_state_dict(seed):
    """A seeded torchvision mobilenet_v2 `features.*` state dict."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for bi, (kind, layers, _) in enumerate(mob.mobilenet_v2_structure()):
        if kind == "conv":
            names = [(f"features.{bi}.0", f"features.{bi}.1")]
        else:
            n = len(layers)
            names = [(f"features.{bi}.conv.{li}.0", f"features.{bi}.conv.{li}.1")
                     for li in range(n - 1)] + [(f"features.{bi}.conv.{n - 1}",
                                                 f"features.{bi}.conv.{n}")]
        for (cname, bname), (_, k, cin, cout, _, groups) in zip(names, layers):
            sd[f"{cname}.weight"] = torch.randn((cout, cin // groups, k, k), generator=g)
            sd[f"{bname}.weight"] = 1 + 0.1 * torch.randn(cout, generator=g)
            sd[f"{bname}.bias"] = 0.05 * torch.randn(cout, generator=g)
            sd[f"{bname}.running_mean"] = 0.05 * torch.randn(cout, generator=g)
            sd[f"{bname}.running_var"] = 0.5 + torch.rand(cout, generator=g)
    return sd


def test_convert_mobilenet_v2_bit_for_bit():
    sd = _mobilenet_state_dict(5)
    tp, ts = mob.convert_mobilenet_v2(sd)
    jp, js = jmob.convert_mobilenet_v2(sd)
    _bitwise_tree(tp, jp)
    _bitwise_tree(ts, js)


# ---------------------------------------------------------------- EfficientNet

def _efficientnet_state_dict(variant, seed):
    """A seeded efficientnet_pytorch-named state dict."""
    g = torch.Generator().manual_seed(seed)
    stem_c, blocks, last_c, head_c = jeff.efficientnet_structure(variant)
    sd = {}

    def conv(name, cout, cin, k, bias=False):
        sd[f"{name}.weight"] = 0.1 * torch.randn((cout, cin, k, k), generator=g)
        if bias:
            sd[f"{name}.bias"] = 0.1 * torch.randn(cout, generator=g)

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.05 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = 0.05 * torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=g)

    conv("_conv_stem", stem_c, 3, 3)
    bn("_bn0", stem_c)
    for bi, (k, cin, cout, _, expand) in enumerate(blocks):
        base, hidden, se_c = f"_blocks.{bi}", cin * expand, max(1, cin // 4)
        if expand != 1:
            conv(f"{base}._expand_conv", hidden, cin, 1)
            bn(f"{base}._bn0", hidden)
        conv(f"{base}._depthwise_conv", hidden, 1, k)
        bn(f"{base}._bn1", hidden)
        conv(f"{base}._se_reduce", se_c, hidden, 1, bias=True)
        conv(f"{base}._se_expand", hidden, se_c, 1, bias=True)
        conv(f"{base}._project_conv", cout, hidden, 1)
        bn(f"{base}._bn2", cout)
    conv("_conv_head", head_c, last_c, 1)
    bn("_bn1", head_c)
    return sd


@pytest.mark.parametrize("variant,hw,atol", [("b0", (37, 45), 2e-3), ("b3", (33, 33), 3e-3)])
def test_efficientnet_features_match_jax(variant, hw, atol):
    jp, js = jeff.convert_efficientnet(_efficientnet_state_dict(variant, 3), variant)
    x, xt = _images((2, *hw, 3), 0, -1.0, 1.0)
    jf, _, _ = jeff.efficientnet_features(jp, js, jnp.asarray(x), variant)
    tf_, _, _ = eff.efficientnet_features(params_from_jax(jp), params_from_jax(js), xt,
                                          variant)
    _close(tf_, jf, atol, 1e-3)


def test_efficientnet_structure_and_rounding():
    for variant in ("b0", "b3"):
        assert eff.efficientnet_structure(variant) == jeff.efficientnet_structure(variant)
    assert eff.round_filters(32, 1.2) == jeff.round_filters(32, 1.2) == 40
    assert eff.round_repeats(3, 1.4) == jeff.round_repeats(3, 1.4) == 5


def test_efficientnet_apr_head_and_train_bn():
    cfg_j = jeff.EfficientNetAPRConfig(variant="b0")
    cfg_t = eff.EfficientNetAPRConfig(variant="b0")
    jp, js = jeff.init_efficientnet_apr(jax.random.PRNGKey(0), cfg_j)
    jp, js = _randomize_bn(jp, js, 4)
    x, xt = _images((2, 37, 45, 3), 1)
    for train in (False, True):
        jpose, jns = jeff.efficientnet_apr_forward(jp, js, jnp.asarray(x), cfg_j, train)
        tpose, tns = eff.efficientnet_apr_forward(params_from_jax(jp), params_from_jax(js),
                                                  xt, cfg_t, train)
        _close(tpose, jpose, 2e-3, 1e-3)
        _close_tree(tns, jns, TRAIN_BN_STATS, TRAIN_BN_STATS)


def test_convert_efficientnet_bit_for_bit():
    sd = _efficientnet_state_dict("b0", 7)
    tp, ts = eff.convert_efficientnet(sd, "b0")
    jp, js = jeff.convert_efficientnet(sd, "b0")
    _bitwise_tree(tp, jp)
    _bitwise_tree(ts, js)


# ---------------------------------------------------------------- ResNet34

@pytest.fixture(scope="module")
def resnet():
    params, state = jres.init_resnet34_params(jax.random.PRNGKey(0))
    return _randomize_bn(params, state, 2)


@pytest.mark.parametrize("train_bn", [False, True])
def test_resnet34_features_match_jax(resnet, train_bn):
    jp, js = resnet
    x, xt = _images((2, 64, 64, 3), 0)
    jf, jns = jres.resnet34_features(jp, js, jnp.asarray(x), train_bn)
    tf_, tns = res.resnet34_features(params_from_jax(jp), params_from_jax(js), xt, train_bn)
    _close(tf_, jf, TRAIN_BN_ATOL if train_bn else 3e-4)
    _close_tree(tns, jns, TRAIN_BN_STATS, TRAIN_BN_STATS)


@pytest.mark.parametrize("mapnet_heads", [False, True])
def test_legacy_posenet_and_mapnet_heads(mapnet_heads):
    """The 12-dim head and the xyz / log-quaternion heads, and MapNet over
    (N, T) sequences, in eval and in train mode with dropout off."""
    kw = dict(feat_dim=64, mapnet_heads=mapnet_heads)
    jcfg, tcfg = jres.LegacyPoseNetConfig(**kw), res.LegacyPoseNetConfig(**kw)
    jp, js = jres.init_legacy_posenet(jax.random.PRNGKey(1), jcfg)
    jp, js = _randomize_bn(jp, js, 3)
    tp, ts = params_from_jax(jp), params_from_jax(js)
    x, xt = _images((2, 64, 64, 3), 4)
    for train in (False, True):
        jpose, _ = jres.legacy_posenet_forward(jp, js, jnp.asarray(x), jcfg, train=train)
        tpose, _ = res.legacy_posenet_forward(tp, ts, xt, tcfg, train=train)
        assert tuple(tpose.shape) == (2, 6 if mapnet_heads else 12)
        _close(tpose, jpose, 3e-4)
    seq, _ = _images((6, 64, 64, 3), 5)
    seq_t = torch.tensor(seq).reshape(2, 3, 64, 64, 3).permute(0, 1, 4, 2, 3)
    jposes, _ = jres.mapnet_forward(jp, js, jnp.asarray(seq.reshape(2, 3, 64, 64, 3)), jcfg)
    tposes, _ = res.mapnet_forward(tp, ts, seq_t, tcfg)
    assert tuple(tposes.shape) == (2, 3, 6 if mapnet_heads else 12)
    _close(tposes, jposes, 3e-4)


def test_legacy_posenet_dropout_keep_rate_and_scale():
    """Dropout draws from the explicit generator: about 1 - droprate of the
    features kept, each scaled by 1 / (1 - droprate); the same generator
    state gives the same mask, and no generator gives no dropout. An
    identity pose head shows the dropped features themselves."""
    cfg = res.LegacyPoseNetConfig(feat_dim=12, droprate=0.5)
    tp, ts = res.init_legacy_posenet(torch.Generator().manual_seed(0), cfg)
    tp["fc_pose"] = {"w": torch.eye(12), "b": torch.zeros(12)}
    x = torch.rand((64, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    run = lambda gen: res.legacy_posenet_forward(tp, ts, x, cfg, gen=gen, train=True)[0]
    h_off = run(None)
    h_a = run(torch.Generator().manual_seed(7))
    assert torch.equal(h_a, run(torch.Generator().manual_seed(7)))
    live = h_off > 0
    kept = (h_a != 0) & live
    share = float(kept.sum()) / float(live.sum())
    assert int(live.sum()) > 300 and abs(share - 0.5) < 0.1, (int(live.sum()), share)
    assert torch.equal(h_a[~kept], torch.zeros_like(h_a[~kept]))
    torch.testing.assert_close(h_a[kept], 2.0 * h_off[kept], atol=1e-6, rtol=1e-6)
