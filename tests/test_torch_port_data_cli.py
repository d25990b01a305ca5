"""The three shipped configs (configs/config_nerfh.txt, config_dfnet.txt,
config_dfnetdm.txt) through the port's CLIs on the CPU, from a small
7-Scenes replica written by scripts/replica.py, with the NeRF cut to D=2
W=32 and epochs 0-1; the prefetcher (data/prefetch.py) on the CPU; and a
stage-2 and a stage-3 run with --prefetch 2 equal to the same run
without it, bit for bit."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import glob
import json
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.cli import dm, feature, nerf
from dfnet_tpu_torch.data.color import downscale_area
from dfnet_tpu_torch.data.prefetch import PrefetchIterator, epoch_prefetch
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.scripts.replica import write_seven_scenes_replica

NET = ["--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
       "--netwidth_fine", "32", "--device", "cpu"]
N_FRAMES = 6             # a sequence: trainskip 5 leaves 2 views, testskip 50 one


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and test workers
    that each run a thread a core slow one another down: this module's
    torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(cli):
    """Wrap cli.load_scene; return the list of scenes it loads."""
    scenes, orig = [], cli.load_scene

    def load(cfg, stage="nerf"):
        scenes.append(orig(cfg, stage=stage))
        return scenes[-1]

    cli.load_scene = load
    return scenes, orig


def _metrics(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The replica (64x80 frames, two sequences of N_FRAMES), then stage 1
    (epochs 0-1 and --render_test), stage 2 (epochs 0-1) and stage 3
    (epochs 0-1, from stage 2's best checkpoint) through the CLIs with
    the shipped configs; the scenes each CLI loaded."""
    root = tmp_path_factory.mktemp("pipeline")
    rec = write_seven_scenes_replica(str(root / "data"), n_frames=N_FRAMES, H=64, W=80)
    base = str(root / "logs")
    link = ["--datadir", rec["datadir"], "--basedir", base, "--epochs", "1"]
    out = {"rec": rec, "base": base, "link": link, "scenes": {}}
    for name, cli in (("nerf", nerf), ("feature", feature), ("dm", dm)):
        scenes, orig = _recording(cli)
        try:
            if name == "nerf":
                nerf.train(["--config", "configs/config_nerfh.txt", "--i_weights", "1"]
                           + link + NET)
                out["psnr"] = nerf.train(["--config", "configs/config_nerfh.txt",
                                          "--render_test"] + link + NET)
            elif name == "feature":
                out["feature_err"] = feature.train(
                    ["--config", "configs/config_dfnet.txt"] + link + NET)
                out["stage2_ckpt"] = feature_best(base)
            else:
                ck = out["stage2_ckpt"]
                out["dm_err"] = dm.main(["--config", "configs/config_dfnetdm.txt",
                                         "--pretrain_model_path", ck,
                                         "--pretrain_featurenet_path", ck] + link + NET)
        finally:
            cli.load_scene = orig
        out["scenes"][name] = scenes
    return out


def feature_best(base):
    """The newest (best) stage-2 checkpoint EarlyStopping wrote."""
    return sorted(glob.glob(osp.join(base, "dfnet", "checkpoint-*.npz")))[-1]


def test_stage1_config_trains_and_renders_the_replica(pipeline):
    rec, base = pipeline["rec"], pipeline["base"]
    (scene,) = pipeline["scenes"]["nerf"][:1]
    assert scene.hwf == [16, 20, 585.0 / 4]             # df 4
    np.testing.assert_array_equal(scene.train.gt_idx, [0, 5])   # seq-02, trainskip 5
    np.testing.assert_array_equal(scene.val.gt_idx, [0])        # seq-01, testskip 50
    np.testing.assert_allclose(scene.train.poses, rec["poses"][2][::5], atol=1e-6, rtol=0)
    want = np.stack([downscale_area((f / 255.0).astype(np.float32), 4.0)
                     for f in rec["frames"][2][::5]])
    np.testing.assert_array_equal(scene.train.images, want)
    losses = [m["loss"] for m in _metrics(osp.join(base, "nerfh", "metrics.jsonl"))]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert np.isfinite(pipeline["psnr"])


def test_stage2_config_trains_on_the_replica(pipeline):
    base = pipeline["base"]
    scene = pipeline["scenes"]["feature"][0]
    assert scene.hwf == [32, 40, 585.0 / 2] and len(scene.val) == N_FRAMES
    m = _metrics(osp.join(base, "dfnet", "metrics.jsonl"))
    assert len(m) == 2
    assert np.all(np.isfinite([[r["train_loss"], r["val_loss"]] for r in m]))
    assert np.all(np.isfinite(pipeline["feature_err"]))


def test_stage3_config_trains_on_the_test_sequence(pipeline):
    """finetune_unlabel: the train split is seq-01 (the test sequence) at
    trainskip 5, the val split seq-01 at testskip 1."""
    rec, base = pipeline["rec"], pipeline["base"]
    scene = pipeline["scenes"]["dm"][0]
    np.testing.assert_array_equal(scene.train.gt_idx, [0, 5])
    np.testing.assert_array_equal(scene.val.gt_idx, np.arange(N_FRAMES))
    np.testing.assert_array_equal(scene.train.images, scene.val.images[::5])
    np.testing.assert_allclose(scene.train.poses, rec["poses"][1][::5], atol=1e-6, rtol=0)
    m = _metrics(osp.join(base, "dfnetdm", "metrics.jsonl"))
    assert len(m) == 2
    assert np.all(np.isfinite([[r["train_loss"], r["val_loss"], r["train_psnr"],
                                r["val_psnr"]] for r in m]))
    assert np.all(np.isfinite(pipeline["dm_err"]))


def _rerun_with_prefetch(pipeline, tmp_path, stage):
    """The stage's CLI again with --prefetch 2, from a copy of stage 1's
    checkpoint; its metrics and the pipeline's."""
    base = str(tmp_path / "logs")
    shutil.copytree(osp.join(pipeline["base"], "nerfh"), osp.join(base, "nerfh"))
    link = ["--datadir", pipeline["rec"]["datadir"], "--basedir", base, "--epochs", "1"]
    if stage == "dfnet":
        feature.train(["--config", "configs/config_dfnet.txt", "--prefetch", "2"] + link + NET)
    else:
        ck = pipeline["stage2_ckpt"]
        dm.main(["--config", "configs/config_dfnetdm.txt", "--prefetch", "2",
                 "--pretrain_model_path", ck, "--pretrain_featurenet_path", ck] + link + NET)
    return (_metrics(osp.join(base, stage, "metrics.jsonl")),
            _metrics(osp.join(pipeline["base"], stage, "metrics.jsonl")))


@pytest.mark.parametrize("stage", ["dfnet", "dfnetdm"])
def test_prefetch_run_equals_the_device_resident_run(pipeline, tmp_path, stage):
    got, want = _rerun_with_prefetch(pipeline, tmp_path, stage)
    keys = [k for k in want[0] if k != "wall_s"]
    assert [[r[k] for k in keys] for r in got] == [[r[k] for k in keys] for r in want]


def test_prefetch_iterator_order_and_structure():
    seen = []
    it = PrefetchIterator(lambda i: {"x": np.full((2, 2), i), "y": (np.arange(i), None)},
                          range(5), depth=2, device="cpu")
    assert len(it) == 5
    for b in it:
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        seen.append(int(b["x"][0, 0]))
        assert b["y"][0].tolist() == list(range(seen[-1])) and b["y"][1] is None
    assert seen == [0, 1, 2, 3, 4]

    scene = make_synthetic_scene(n_train=7, n_val=1, H=8, W=8, seed=0)
    order = np.random.default_rng(0).permutation(7)
    batches = list(epoch_prefetch(scene.train, batch_size=2, rng=np.random.default_rng(0),
                                  device="cpu"))
    assert len(batches) == 3                          # drop_last
    imgs, poses, hists = batches[1]
    np.testing.assert_array_equal(imgs.numpy(), scene.train.images[order[2:4]])
    np.testing.assert_array_equal(poses.numpy(), scene.train.poses[order[2:4]])
    np.testing.assert_array_equal(hists.numpy(), scene.train.hists[order[2:4]])


def test_prefetch_iterator_raises_the_producers_error_in_order():
    def make(i):
        if i == 2:
            raise ValueError("boom")
        return (np.zeros(1) + i,)

    got = []
    with pytest.raises(ValueError, match="boom"):
        for (x,) in PrefetchIterator(make, range(4), depth=1, device="cpu"):
            got.append(float(x))
    assert got == [0.0, 1.0]
