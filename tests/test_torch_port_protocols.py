"""The port's three protocol drivers on the CPU, at small sizes:
parity_7scenes' dry run (one 7-Scenes leg on a replica written by
scripts/replica.py, two views; the JAX script's printed lines), the
.tar/.pt it writes read by the JAX package's converters (the port's params
bit for bit), quality_synthetic at two epochs of a D=2 W=32 NeRF-H on a
smaller scene (the four render paths' val PSNRs, the kernel paths within
QUALITY.md's 0.2 dB of the plain render, and the stage-2 leg), and
quality_stage2_precision at one epoch per precision on the shipped
301-epoch asset."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from dfnet_tpu.convert import convert_dfnet_checkpoint as jax_convert_dfnet
from dfnet_tpu.convert import convert_nerf_checkpoint as jax_convert_nerf
from dfnet_tpu_torch.convert import convert_dfnet_checkpoint, convert_nerf_checkpoint
from dfnet_tpu_torch.models.dfnet import dfnet_params_to_jax
from dfnet_tpu_torch.scripts import parity_7scenes, quality_stage2_precision, quality_synthetic
from dfnet_tpu_torch.training.checkpoints import load_pytree
from dfnet_tpu_torch.training.nerf_trainer import named_leaves

TINY_NET = ["--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
            "--netwidth_fine", "32"]


@pytest.fixture(autouse=True)
def _two_threads():
    # the drivers' CPU time on a loaded machine: two torch threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parity_dryrun_leg_prints_the_protocol_lines(tmp_path, capsys):
    args = parity_7scenes.build_parser().parse_args(
        ["--dryrun", "--max_render_views", "2", "--device", "cpu"])
    out = parity_7scenes.dryrun(args, legs=[("7Scenes", True)], workdir=str(tmp_path))
    text = capsys.readouterr().out
    for line in ("PARITY PROTOCOL COMPLETE", "mean test PSNR", "median error",
                 "replica .tar round-trip bit-exact", "replica .pt round-trip bit-exact"):
        assert line in text, line
    res = out[("7Scenes", True)]
    assert len(res["psnrs"]) == 2 and np.all(np.isfinite(res["psnrs"]))
    assert np.all(np.isfinite(res["median"])) and np.all(np.isfinite(res["mean"]))


@pytest.mark.parametrize("encode_hist", [True, False])
def test_replica_checkpoints_read_by_jax_equal_the_port(tmp_path, encode_hist):
    tar, pt = parity_7scenes.build_replica_ckpts(str(tmp_path), "cpu", encode_hist)
    want, meta = convert_nerf_checkpoint(tar, D=2)
    got, jmeta = jax_convert_nerf(tar, D=2)
    assert meta == jmeta == {"global_step": 123}
    assert set(got) == set(want) == {"coarse", "fine", "embedding_a", "embedding_t"}
    for key in want:
        flat_w = dict(named_leaves({key: want[key]}))
        flat_g = dict(named_leaves({key: got[key]}))
        assert flat_w.keys() == flat_g.keys()
        for k in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[k]), np.asarray(flat_w[k]))
    jparams, jstate = jax_convert_dfnet(pt)
    params, state = dfnet_params_to_jax(*convert_dfnet_checkpoint(pt))
    for a, b in ((jparams, params), (jstate, state)):
        fa, fb = dict(named_leaves(a)), dict(named_leaves(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]))


def test_quality_synthetic_two_epochs(tmp_path, capsys, monkeypatch):
    # the protocol's scene cut to 6 train / 2 val views of 32x40 (VGG16's
    # five pools need 32 px a side in the stage-2 leg)
    monkeypatch.setattr(quality_synthetic, "SCENE", dict(
        n_train=6, n_val=2, H=32, W=40, focal=40.0, seed=0, appearance_jitter=0.1))
    monkeypatch.setattr(quality_synthetic, "STAGE2_EPOCHS", 1)
    ckpt = str(tmp_path / "q.npz")
    out = quality_synthetic.main(["--epochs", "2", "--device", "cpu", "--stage2",
                                  "--save_ckpt", ckpt, *TINY_NET])
    text = capsys.readouterr().out
    assert "(kernel step)" in text
    psnr = out["psnr"]
    assert list(psnr) == list(quality_synthetic.PATHS)
    assert text.count("val PSNR") == 4 and np.all(np.isfinite(list(psnr.values())))
    plain = psnr[next(iter(quality_synthetic.PATHS))]
    for label, v in psnr.items():
        assert abs(v - plain) < 0.2, (label, v, plain)
    s2 = out["stage2"]
    assert np.isfinite(s2["train_loss"]) and np.isfinite(s2["val_loss"])
    tree, _ = load_pytree(ckpt)
    assert tree["fine"]["xyz_0"]["w"].shape == (63, 32)


def test_quality_stage2_precision_one_epoch_each(capsys):
    out = quality_stage2_precision.main(["--epochs", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert set(out) == {"bf16", "fp32"}
    for p, r in out.items():
        assert f"[{p}] 1 epochs" in text and "median err" in text
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
        assert np.all(np.isfinite(r["median"]))
