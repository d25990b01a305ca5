"""Golden parity vs PyTorch: the converters + JAX forward passes must
reproduce reference-architecture outputs numerically. The torch modules
here are built from the architecture spec (SURVEY.md §2/L2-L3), then
their weights are converted with dfnet_tpu.convert and compared."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dfnet_tpu.convert import (
    nerfw_state_dict_to_params,
    vgg16_state_dict_to_params,
)
from dfnet_tpu.models.nerfw import NeRFWConfig, nerfw_apply
from dfnet_tpu.models.vgg import VGG16_LAYOUT, vgg16_features
from dfnet_tpu.ops.resize import resize_bicubic, resize_bilinear_align_corners

torch.manual_seed(0)


# ------------------------------------------------------------------ resize

def test_bilinear_align_corners_matches_torch():
    x = torch.rand(2, 5, 7, 9)
    ref = F.interpolate(x, size=(11, 13), mode="bilinear", align_corners=True)
    ours = resize_bilinear_align_corners(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 11, 13)
    np.testing.assert_allclose(
        np.asarray(ours), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)


def test_bicubic_matches_torch():
    x = torch.rand(1, 3, 6, 8)
    ref = F.interpolate(x, size=(24, 32), mode="bicubic", align_corners=False)
    ours = resize_bicubic(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 24, 32)
    np.testing.assert_allclose(
        np.asarray(ours), ref.permute(0, 2, 3, 1).numpy(), atol=1e-4)


# ------------------------------------------------------------------ VGG16

def _torch_vgg16_features():
    layers = []
    cin = 3
    for e in VGG16_LAYOUT:
        if e == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers.append(nn.Conv2d(cin, e[1], 3, padding=1))
            layers.append(nn.ReLU(inplace=False))
            cin = e[1]
    return nn.Sequential(*layers)


def test_vgg16_features_and_taps_match_torch():
    tnet = _torch_vgg16_features().eval()
    sd = tnet.state_dict()
    params = vgg16_state_dict_to_params(sd, prefix="")

    x = torch.rand(1, 3, 32, 48)
    with torch.no_grad():
        # taps at conv outputs PRE-ReLU (torch sequential conv indices)
        tap_idx = {"conv1_2": 2, "conv3_3": 14, "conv5_3": 28}
        feats = {}
        h = x
        for i, layer in enumerate(tnet):
            h = layer(h)
            for name, idx in tap_idx.items():
                if i == idx:
                    feats[name] = h.clone()
        final_t = h

    final_j, taps_j = vgg16_features(
        jax.tree.map(jnp.asarray, params),
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
        taps=("conv1_2", "conv3_3", "conv5_3"))
    np.testing.assert_allclose(
        np.asarray(final_j), final_t.permute(0, 2, 3, 1).numpy(), atol=2e-4)
    for got, name in zip(taps_j, ("conv1_2", "conv3_3", "conv5_3")):
        np.testing.assert_allclose(
            np.asarray(got), feats[name].permute(0, 2, 3, 1).numpy(), atol=2e-4,
            err_msg=name)


# ------------------------------------------------------------------ DFNet full

class _TorchDFNet(nn.Module):
    """Reference-architecture DFNet (random init) for parity testing."""

    def __init__(self, levels=("conv1_2", "conv3_3", "conv5_3"), out_dim=128):
        super().__init__()
        self.encoder = _torch_vgg16_features()
        chans = {name: c for name, c in [e for e in VGG16_LAYOUT if e != "M"]}
        self.adaptation_layers = nn.Module()
        for i, name in enumerate(levels):
            layer = nn.Sequential(
                nn.Conv2d(chans[name], 64, 1), nn.ReLU(),
                nn.Conv2d(64, out_dim, 5, padding=2), nn.BatchNorm2d(out_dim))
            self.adaptation_layers.add_module(f"adapt_layer_{i}", layer)
        self.fc_pose = nn.Linear(512, 12)
        self.levels = levels
        self.tap_idx = [ {"conv1_2":2,"conv3_3":14,"conv5_3":28}[n] for n in levels ]

    def forward(self, x, upsample=(24, 32)):
        mean = torch.tensor([0.485, 0.456, 0.406])
        std = torch.tensor([0.229, 0.224, 0.225])
        x = (x - mean[:, None, None]) / std[:, None, None]
        feats = []
        h = x
        for i, layer in enumerate(self.encoder):
            h = layer(h)
            if i in self.tap_idx:
                feats.append(h.clone())
        feats = [getattr(self.adaptation_layers, f"adapt_layer_{i}")(f)
                 for i, f in enumerate(feats)]
        feats = [nn.UpsamplingBilinear2d(size=upsample)(f) for f in feats]
        pose = self.fc_pose(F.adaptive_avg_pool2d(h, 1).flatten(1))
        return torch.stack(feats), pose


def test_dfnet_forward_matches_torch_replica():
    from dfnet_tpu.convert import convert_dfnet_checkpoint
    from dfnet_tpu.models.dfnet import DFNetConfig, dfnet_forward

    tnet = _TorchDFNet().eval()
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.pt")
        torch.save(tnet.state_dict(), path)
        params, state = convert_dfnet_checkpoint(path)

    x = torch.rand(2, 3, 64, 96)
    with torch.no_grad():
        feats_t, pose_t = tnet(x, upsample=(32, 48))

    feats_j, pose_j, _ = dfnet_forward(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
        DFNetConfig(), return_feature=True, is_single_stream=True,
        upsample_h=32, upsample_w=48, train_bn=False)

    np.testing.assert_allclose(np.asarray(pose_j), pose_t.numpy(), atol=2e-4)
    # ours: (L,B,H,W,C) vs torch (L,B,C,H,W)
    np.testing.assert_allclose(
        np.asarray(feats_j[0]).transpose(0, 1, 4, 2, 3), feats_t.numpy(), atol=2e-3)


# ------------------------------------------------------------------ NeRF-W MLP

class _TorchNeRFW(nn.Module):
    """Reference-architecture NeRFW fine model (nerfw.py:220-354)."""

    def __init__(self, D=4, W=32, in_xyz=63, in_dir=27, in_a=10, in_t=6,
                 skips=(2,)):
        super().__init__()
        self.D, self.W, self.skips = D, W, list(skips)
        self.in_xyz, self.in_dir, self.in_a, self.in_t = in_xyz, in_dir, in_a, in_t
        for i in range(D):
            cin = in_xyz if i == 0 else (W + in_xyz if i in self.skips else W)
            setattr(self, f"xyz_encoding_{i+1}",
                    nn.Sequential(nn.Linear(cin, W), nn.ReLU(True)))
        self.xyz_encoding_final = nn.Linear(W, W)
        self.dir_encoding = nn.Sequential(
            nn.Linear(W + in_dir + in_a, W // 2), nn.ReLU(True))
        self.static_sigma = nn.Sequential(nn.Linear(W, 1), nn.Softplus())
        self.static_rgb = nn.Sequential(nn.Linear(W // 2, 3), nn.Sigmoid())
        self.transient_encoding = nn.Sequential(
            nn.Linear(W + in_t, W // 2), nn.ReLU(True),
            nn.Linear(W // 2, W // 2), nn.ReLU(True),
            nn.Linear(W // 2, W // 2), nn.ReLU(True),
            nn.Linear(W // 2, W // 2), nn.ReLU(True))
        self.transient_sigma = nn.Sequential(nn.Linear(W // 2, 1), nn.Softplus())
        self.transient_rgb = nn.Sequential(nn.Linear(W // 2, 3), nn.Sigmoid())
        self.transient_beta = nn.Sequential(nn.Linear(W // 2, 1), nn.Softplus())

    def forward(self, xyz, d, a, t):
        h = xyz
        for i in range(self.D):
            if i in self.skips:
                h = torch.cat([xyz, h], -1)
            h = getattr(self, f"xyz_encoding_{i+1}")(h)
        sigma = self.static_sigma(h)
        hf = self.xyz_encoding_final(h)
        dd = self.dir_encoding(torch.cat([hf, d, a], -1))
        rgb = self.static_rgb(dd)
        tt = self.transient_encoding(torch.cat([hf, t], -1))
        return torch.cat([rgb, sigma, self.transient_rgb(tt),
                          self.transient_sigma(tt), self.transient_beta(tt)], -1)


def test_nerfw_mlp_matches_torch_replica():
    tnet = _TorchNeRFW().eval()
    sd = tnet.state_dict()
    params = nerfw_state_dict_to_params(sd, D=4, encode_transient=True)
    cfg = NeRFWConfig(D=4, W=32, skips=(2,), in_xyz=63, in_dir=27, in_a=10,
                      in_t=6, encode_appearance=True, encode_transient=True)

    n = 33
    xyz = torch.randn(n, 63)
    d = torch.randn(n, 27)
    a = torch.randn(n, 10)
    t = torch.randn(n, 6)
    with torch.no_grad():
        ref = tnet(xyz, d, a, t).numpy()
    ours = nerfw_apply(
        jax.tree.map(jnp.asarray, params), cfg,
        jnp.asarray(xyz.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(a.numpy()), jnp.asarray(t.numpy()), output_transient=True)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=2e-5)


def test_convert_cli_roundtrip(tmp_path):
    """python -m dfnet_tpu.convert on a reference-format .tar produces a
    loadable npz whose renders match the torch weights' forward."""
    import os

    from dfnet_tpu import convert as convert_mod
    from dfnet_tpu.training.checkpoints import load_pytree

    fine = _TorchNeRFW(D=4, W=32).eval()
    coarse = _TorchNeRFW(D=4, W=32).eval()
    emb_a = nn.Embedding(100, 5)
    emb_t = nn.Embedding(100, 2)
    tar = os.path.join(str(tmp_path), "000100.tar")
    torch.save({
        "global_step": 100,
        "network_fn_state_dict": coarse.state_dict(),
        "network_fine_state_dict": fine.state_dict(),
        "embedding_a_state_dict": emb_a.state_dict(),
        "embedding_t_state_dict": emb_t.state_dict(),
    }, tar)
    out = os.path.join(str(tmp_path), "out.npz")
    convert_mod.main([tar, out, "--netdepth", "4"])
    tree, scalars = load_pytree(out)
    assert int(scalars["global_step"]) == 100
    assert tree["params"]["embedding_a"].shape == (100, 5)
    assert "trans_0" in tree["params"]["fine"]
    # numeric agreement of the fine MLP through converted weights
    cfg = NeRFWConfig(D=4, W=32, skips=(2,), in_xyz=63, in_dir=27, in_a=10,
                      in_t=6, encode_appearance=True, encode_transient=True)
    xyz = torch.randn(5, 63)
    d = torch.randn(5, 27)
    a = torch.randn(5, 10)
    t = torch.randn(5, 6)
    with torch.no_grad():
        ref = fine(xyz, d, a, t).numpy()
    ours = nerfw_apply(jax.tree.map(jnp.asarray, tree["params"]["fine"]), cfg,
                       jnp.asarray(xyz.numpy()), jnp.asarray(d.numpy()),
                       jnp.asarray(a.numpy()), jnp.asarray(t.numpy()),
                       output_transient=True)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=2e-5)


def test_vanilla_nerf_converter_matches_torch():
    """Vanilla NeRF state_dict conversion (post-ReLU skip concat)."""
    from dfnet_tpu.models.nerf_vanilla import (
        VanillaNeRFConfig, nerf_apply_rays, vanilla_state_dict_to_params)

    class _TorchVanilla(nn.Module):
        def __init__(self, D=4, W=32, in_xyz=63, in_dir=27):
            super().__init__()
            self.D, self.skips = D, [2]
            self.pts_linears = nn.ModuleList(
                [nn.Linear(in_xyz, W)] +
                [nn.Linear(W, W) if i not in self.skips else nn.Linear(W + in_xyz, W)
                 for i in range(D - 1)])
            self.feature_linear = nn.Linear(W, W)
            self.alpha_linear = nn.Linear(W, 1)
            self.views_linears = nn.ModuleList([nn.Linear(W + in_dir, W // 2)])
            self.rgb_linear = nn.Linear(W // 2, 3)
            self.in_xyz = in_xyz

        def forward(self, x, d):
            h = x
            for i, l in enumerate(self.pts_linears):
                h = torch.relu(l(h))
                if i in self.skips:
                    h = torch.cat([x, h], -1)
            alpha = self.alpha_linear(h)
            feat = self.feature_linear(h)
            hh = torch.relu(self.views_linears[0](torch.cat([feat, d], -1)))
            return torch.cat([self.rgb_linear(hh), alpha], -1)

    tnet = _TorchVanilla().eval()
    params = vanilla_state_dict_to_params(
        {k: v for k, v in tnet.state_dict().items()}, D=4)
    cfg = VanillaNeRFConfig(D=4, W=32, skips=(2,), in_xyz=63, in_dir=27)
    n, s = 3, 4
    xyz = torch.randn(n * s, 63)
    d = torch.randn(n, 27)
    with torch.no_grad():
        ref = tnet(xyz, d.repeat_interleave(s, 0)).numpy().reshape(n, s, 4)
    ours = nerf_apply_rays(jax.tree.map(jnp.asarray, params), cfg,
                           jnp.asarray(xyz.numpy()).reshape(n, s, 63),
                           jnp.asarray(d.numpy()))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=2e-5)


def test_frozen_nerf_loads_reference_tar(tmp_path):
    """FrozenNeRF.load accepts the reference's .tar format directly."""
    import os

    from dfnet_tpu.config import parse_args
    from dfnet_tpu.data.synthetic import make_synthetic_scene
    from dfnet_tpu.training.nerf_renderer import FrozenNeRF

    # framework models hardcode skips=(4,) (reference create_nerf parity)
    fine = _TorchNeRFW(D=8, W=32, in_xyz=63, in_dir=27, in_a=50, in_t=20,
                       skips=(4,)).eval()
    coarse = _TorchNeRFW(D=8, W=32, in_a=50, in_t=20, skips=(4,)).eval()
    tar = os.path.join(str(tmp_path), "000050.tar")
    torch.save({
        "global_step": 50,
        "network_fn_state_dict": coarse.state_dict(),
        "network_fine_state_dict": fine.state_dict(),
        "embedding_a_state_dict": nn.Embedding(1000, 5).state_dict(),
        "embedding_t_state_dict": nn.Embedding(1000, 2).state_dict(),
    }, tar)

    scene = make_synthetic_scene(n_train=2, n_val=1, H=8, W=8, seed=0)
    cfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                      "--netdepth", "8", "--netwidth", "32",
                      "--netdepth_fine", "8", "--netwidth_fine", "32",
                      "--N_samples", "4", "--N_importance", "4"], stage="nerf")
    nerf = FrozenNeRF(cfg, scene.hwf, scene.near, scene.far, scene.world_setup)
    nerf.load(tar)
    rgb = np.asarray(nerf.render_at_pose(scene.val.poses[0], scene.val.hists[0]))
    assert rgb.shape == (8, 8, 3) and np.isfinite(rgb).all()


def test_sample_pdf_matches_torch_reference_formula():
    """The gather-free inverse-CDF must reproduce the canonical
    searchsorted+gather formulation (reference rendering.py:24-65)."""
    from dfnet_tpu.render.sampling import sample_pdf

    torch.manual_seed(3)
    n, M, I = 17, 63, 64
    bins_t = torch.sort(torch.rand(n, M) * 3.0, dim=-1).values
    weights_t = torch.rand(n, M - 1) * 2.0

    # canonical formulation in torch
    w = weights_t + 1e-5
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0, I).expand(n, I).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins_t, 1, below)
    bins_a = torch.gather(bins_t, 1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_b),
                        cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    ref = (bins_b + t * (bins_a - bins_b)).numpy()

    ours = np.asarray(sample_pdf(jnp.asarray(bins_t.numpy()),
                                 jnp.asarray(weights_t.numpy()), I, det=True))
    np.testing.assert_allclose(ours, ref, atol=2e-5)
