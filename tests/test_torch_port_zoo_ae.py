"""The autoencoder zoo and VGG19's index taps, port against dfnet_tpu on
the CPU: autoencoder_vgg1..7 and the conv autoencoder at the JAX tests'
sizes and bar, 1e-4 (tests/test_autoencoder_zoo.py:61), on the JAX
package's params carried across with models/layers.py::params_from_jax;
vgg_features_by_index at 1e-5; the JAX-layout bridge both ways."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.models import autoencoder as jae
from dfnet_tpu.models import mobilenet as jmob
from dfnet_tpu.models import resnet as jres
from dfnet_tpu.models import vgg as jvgg
from dfnet_tpu_torch.models import autoencoder as ae
from dfnet_tpu_torch.models import vgg
from dfnet_tpu_torch.models.layers import params_from_jax, params_to_jax
from test_torch_port_zoo import _close, _images, _leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vgg19_index_taps_match_jax():
    jp = jvgg.init_vgg_params(jax.random.PRNGKey(0), jvgg.VGG19_LAYOUT)
    x, xt = _images((1, 64, 64, 3), 0)
    idx = (0, 3, 4, 8, 17, 26, 35, 36)
    jf, jt = jvgg.vgg_features_by_index(jp, jnp.asarray(x), jvgg.VGG19_LAYOUT, idx)
    tf_, tt = vgg.vgg_features_by_index(params_from_jax(jp), xt, vgg.VGG19_LAYOUT, idx)
    assert vgg.VGG19_LAYOUT == jvgg.VGG19_LAYOUT
    _close(tf_, jf, 1e-5, 1e-5)
    for a, b in zip(tt, jt):
        _close(a, b, 1e-5, 1e-5)


def _ae_close(got, want, atol=1e-4):
    if want is None:
        assert got is None
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _ae_close(a, b, atol)
    else:
        _close(got, want, atol)


@pytest.mark.parametrize("variant,hw,extra", [
    (1, (36, 36), ()), (2, (36, 36), ()), (3, (64, 64), ()), (4, (64, 64), ()),
    (5, (64, 64), ()), (6, (64, 64), (48, 48)), (7, (64, 64), (32, 32))])
def test_autoencoder_vgg_zoo_matches_jax(variant, hw, extra):
    jp = getattr(jae, f"init_autoencoder_vgg{variant}")(jax.random.PRNGKey(variant))
    x, xt = _images((1, *hw, 3), variant, -1.0, 1.0)
    want = getattr(jae, f"autoencoder_vgg{variant}")(jp, jnp.asarray(x), *extra)
    got = getattr(ae, f"autoencoder_vgg{variant}")(params_from_jax(jp), xt, *extra)
    _ae_close(got, want)


def test_autoencoder_vgg_inits_match_jax_shapes():
    for v in range(1, 8):
        tp = getattr(ae, f"init_autoencoder_vgg{v}")(torch.Generator().manual_seed(v))
        jp = getattr(jae, f"init_autoencoder_vgg{v}")(jax.random.PRNGKey(v))
        assert [tuple(a.shape) for a in _leaves(tp)] == \
            [tuple(a.shape) for a in _leaves(params_from_jax(jp))]


def test_conv_autoencoder_and_transpose_conv_match_jax():
    jp = jae.init_autoencoder_params(jax.random.PRNGKey(0))
    x, xt = _images((2, 32, 32, 3), 0)
    jr, jf = jae.autoencoder_forward(jp, jnp.asarray(x), return_features=True)
    tr, tf_ = ae.autoencoder_forward(params_from_jax(jp), xt, return_features=True)
    _close(tr, jr, 1e-4)
    _close(tf_, jf, 1e-4)
    p = jae._torch_convT_init(jax.random.PRNGKey(1), 3, 3, 8, 4)
    h, ht = _images((1, 9, 11, 8), 1)
    for stride, pad, opad in ((1, 0, 0), (2, 1, 1), (4, 0, 0)):
        want = jae.conv2d_transpose(p, jnp.asarray(h), stride, pad, opad)
        _close(ae.conv2d_transpose(params_from_jax(p), ht, stride, pad, opad), want, 1e-5)


def test_params_bridge_round_trips():
    jp, js = jres.init_legacy_posenet(jax.random.PRNGKey(0),
                                      jres.LegacyPoseNetConfig(feat_dim=32))
    for tree in (jp, js, jae.init_autoencoder_vgg1(jax.random.PRNGKey(1)),
                 jmob.init_mobilenet_params(jax.random.PRNGKey(2))[0]):
        back = params_to_jax(params_from_jax(tree))
        for a, b in zip(_leaves(back), _leaves(jax.tree.map(np.asarray, tree))):
            assert a.shape == b.shape and np.array_equal(a, b)
