"""The port's real-dataset data layer against the JAX package's on the CPU:
data/color.py::downscale_area (against cv2.INTER_AREA, the JAX path),
data/png.py::read_png (against PIL's convert("RGB"), exactly), the pose
averaging, centering and dataset coordinate fixes (within 1e-12 in
float64), data/scene.py's metadata readers, and both dataset readers and
every data/loader.py::load_scene branch on the JAX tests' replicas and on
the port writer's (scripts/replica.py): images bit-equal, poses within
1e-6, hists, gt_idx, hwf, near/far, world_setup and a saved stats file
equal."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import json
import os
import os.path as osp
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dfnet_tpu import pose as jax_pose
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.data import scene as jax_scene
from dfnet_tpu.data.cambridge import load_cambridge_split as jax_load_cambridge
from dfnet_tpu.data.color import downscale_area as jax_downscale_area
from dfnet_tpu.data.loader import load_scene as jax_load_scene
from dfnet_tpu.data.seven_scenes import _load_image as jax_load_image
from dfnet_tpu.data.seven_scenes import load_seven_scenes_split as jax_load_7scenes
from dfnet_tpu_torch import pose
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data import scene as port_scene
from dfnet_tpu_torch.data.cambridge import load_cambridge_split
from dfnet_tpu_torch.data.color import downscale_area
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.data.png import encode_png, read_image, read_png, write_png
from dfnet_tpu_torch.data.seven_scenes import load_seven_scenes_split
from dfnet_tpu_torch.scripts.replica import write_cambridge_replica, write_seven_scenes_replica
from test_data import _write_fake_7scenes, _write_fake_cambridge


# ---------------------------------------------------------------- downscale_area

@pytest.mark.parametrize("h,w,df", [
    (480, 640, 2), (480, 640, 4), (480, 854, 2),      # df divides both sides
    (480, 854, 4),                                    # 854 / 4 is not an integer
    (481, 641, 2),
    (480, 854, 1.5), (480, 640, 2.5), (100, 77, 3.3),  # fractional factors
])
def test_downscale_area_matches_cv2(h, w, df):
    img = np.random.default_rng(h + w).uniform(0, 1, (h, w, 3)).astype(np.float32)
    got, want = downscale_area(img, df), jax_downscale_area(img, df)
    assert got.dtype == np.float32 and got.shape == want.shape == (int(h // df), int(w // df), 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if df == int(df) and h % df == 0 and w % df == 0:
        # cv2's area-fast case: its float32 block sums, bit for bit, and the
        # block mean within float32 rounding
        np.testing.assert_array_equal(got, want)
        k = int(df)
        mean = img.astype(np.float64).reshape(h // k, k, w // k, k, 3).mean((1, 3))
        np.testing.assert_allclose(got, mean, atol=1e-6, rtol=0)


def test_downscale_area_identity_and_gray():
    img = np.random.default_rng(0).uniform(0, 1, (30, 50)).astype(np.float32)
    assert downscale_area(img, 1.0) is img
    np.testing.assert_allclose(downscale_area(img, 2.5), jax_downscale_area(img, 2.5),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------- PNG

def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_read_png_matches_pil_for_each_color_and_filter_type(tmp_path, channels, ftype):
    rng = np.random.default_rng(10 * channels + ftype)
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    img[5:8] = img[4]                       # flat runs next to noise
    img[:, 9:] = np.cumsum(img[:, 9:], axis=1, dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fh:
        fh.write(encode_png(img, ftype))
    with Image.open(path) as im:             # PIL reads the encoder's file back
        np.testing.assert_array_equal(np.asarray(im).reshape(img.shape), img)
    np.testing.assert_array_equal(read_png(path), _pil_rgb(path))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_png_matches_pil_on_pil_written_files(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    arr = rng.integers(0, 256, (41, 57, 4), dtype=np.uint8)
    arr[:20] = arr[0]
    if mode == "P":
        im = Image.fromarray(arr[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=37)
    else:
        im = Image.fromarray(arr, "RGBA").convert(mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    np.testing.assert_array_equal(read_png(path), _pil_rgb(path))
    np.testing.assert_array_equal(read_image(path), jax_load_image(path))


def _ihdr_patched(data: bytes, **fields) -> bytes:
    """The PNG bytes with IHDR fields replaced and its CRC recomputed."""
    names = ("w", "h", "depth", "color", "compression", "filter", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    good = encode_png(img)
    cases = {
        "16bit.png": None,
        "interlaced.png": _ihdr_patched(good, interlace=1),
        "not_png.png": b"GIF89a" + good[6:],
        "bad_crc.png": good[:40] + bytes([good[40] ^ 1]) + good[41:],
    }
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(
        str(tmp_path / "16bit.png"))
    with Image.open(str(tmp_path / "16bit.png")) as im:
        assert im.mode.startswith("I")         # PIL wrote a 16-bit file
    for name, data in cases.items():
        path = str(tmp_path / name)
        if data is not None:
            with open(path, "wb") as fh:
                fh.write(data)
        with pytest.raises(ValueError, match=name):
            read_png(path)
    path = str(tmp_path / "ok.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


# ---------------------------------------------------------------- pose geometry

def _random_poses(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    t = rng.normal(size=(n, 3, 1)) * 2.0
    return np.concatenate([q, t], -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_geometry_matches_jax(seed):
    poses = _random_poses(9, seed)
    avg = _random_poses(1, seed + 100)[0]
    np.testing.assert_allclose(pose.average_poses(poses), jax_pose.average_poses(poses),
                               atol=1e-12, rtol=0)
    for a in (None, avg):
        (c, pa), (jc, jpa) = pose.center_poses(poses, a), jax_pose.center_poses(poses, a)
        np.testing.assert_allclose(c, jc, atol=1e-12, rtol=0)
        np.testing.assert_allclose(pa, jpa, atol=1e-12, rtol=0)
        for ours, theirs in ((pose.fix_coord_7scenes, jax_pose.fix_coord_7scenes),
                             (pose.fix_coord_cambridge, jax_pose.fix_coord_cambridge)):
            np.testing.assert_allclose(ours(poses, a), theirs(poses, a), atol=1e-12, rtol=0)


def test_world_setup_and_pose_avg_stats_match_jax(tmp_path):
    d = str(tmp_path)
    with open(osp.join(d, "world_setup.json"), "w") as fh:
        json.dump({"near": 0.25, "far": 4, "pose_scale": 0.5, "pose_scale2": 2,
                   "move_all_cam_vec": [1, -2.5, 0.125], "extra": 1}, fh)
    assert port_scene.load_world_setup(d) == jax_scene.load_world_setup(d)
    assert port_scene.load_pose_avg_stats(d) is None is jax_scene.load_pose_avg_stats(d)
    np.savetxt(osp.join(d, "pose_avg_stats.txt"), _random_poses(1, 3)[0])
    np.testing.assert_array_equal(port_scene.load_pose_avg_stats(d),
                                  jax_scene.load_pose_avg_stats(d))


# ---------------------------------------------------------------- readers and load_scene

REPLICAS = ("jax_7scenes", "jax_cambridge", "port_7scenes", "port_cambridge")


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    """datadir, dataset type and writer record of each replica: the JAX
    tests' (random frames, random translations) and the port writer's
    (blob renders at small H x W, sphere poses)."""
    root = str(tmp_path_factory.mktemp("replicas"))
    out = {
        "jax_7scenes": (_write_fake_7scenes(osp.join(root, "j7")), "7Scenes", None),
        "jax_cambridge": (_write_fake_cambridge(osp.join(root, "jc")), "Cambridge", None),
    }
    rec = write_seven_scenes_replica(osp.join(root, "p7"), n_frames=6, H=32, W=40, seed=1)
    out["port_7scenes"] = (rec["datadir"], "7Scenes", rec)
    rec = write_cambridge_replica(osp.join(root, "pc"), n_frames=5, H=24, W=44, seed=2)
    out["port_cambridge"] = (rec["datadir"], "Cambridge", rec)
    return out


def _isolated(datadir, dest):
    """A copy of the replica's metadata folder under `dest`, its frames
    linked, so that writing pose_avg_stats.txt there leaves the replica
    as it was. Returns the copy's datadir."""
    root, dataset, scene = datadir.rsplit(os.sep, 2)
    os.makedirs(osp.join(dest, dataset), exist_ok=True)
    os.symlink(osp.join(root, "deepslam_data"), osp.join(dest, "deepslam_data"))
    new = osp.join(dest, dataset, scene)
    shutil.copytree(datadir, new)
    return new


def _assert_same_scene(ours, theirs):
    for a, b in ((ours.train, theirs.train), (ours.val, theirs.val)):
        assert a.images.dtype == np.float32
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_allclose(a.poses, b.poses, atol=1e-6, rtol=0)
        assert a.poses.dtype == b.poses.dtype == np.float32
        np.testing.assert_array_equal(a.hists, b.hists)
        assert a.hists.dtype == b.hists.dtype
        np.testing.assert_array_equal(a.gt_idx, b.gt_idx)
    assert ours.hwf == theirs.hwf
    assert (ours.near, ours.far, ours.name) == (theirs.near, theirs.far, theirs.name)
    assert ours.world_setup == theirs.world_setup


def _argv(datadir, dataset, extra=()):
    return ["--datadir", datadir, "--dataset_type", dataset, "--df", "2",
            "--trainskip", "2", "--testskip", "1"] + list(extra)


LABELS = {"hist": ["--NeRFH", "--encode_hist"], "index": ["--NeRFH"],
          "fix_index": ["--NeRFH", "--fix_index"], "zeros": []}


@pytest.mark.parametrize("labels", list(LABELS))
@pytest.mark.parametrize("unlabel", [False, True])
@pytest.mark.parametrize("stage", ["nerf", "apr"])
@pytest.mark.parametrize("replica", REPLICAS)
def test_load_scene_matches_jax(replicas, replica, stage, unlabel, labels):
    datadir, dataset, _ = replicas[replica]
    argv = _argv(datadir, dataset, LABELS[labels] + (["--finetune_unlabel"] if unlabel else []))
    ours = load_scene(parse_args(argv + ["--device", "cpu"]), stage=stage)
    theirs = jax_load_scene(jax_parse_args(argv), stage=stage)
    _assert_same_scene(ours, theirs)
    if unlabel and stage != "nerf":      # the train split is the test sequences
        assert len(ours.train) == len(ours.val) // 2 + len(ours.val) % 2


@pytest.mark.parametrize("stage", ["nerf", "apr"])
@pytest.mark.parametrize("stats", ["save", "load"])
@pytest.mark.parametrize("replica", REPLICAS)
def test_load_scene_pose_avg_stats_match_jax(replicas, tmp_path, replica, stats, stage):
    datadir, dataset, _ = replicas[replica]
    mine, jaxs = (_isolated(datadir, str(tmp_path / k)) for k in ("port", "jax"))
    flag = "--save_pose_avg_stats" if stats == "save" else "--load_pose_avg_stats"
    if stats == "load":                   # a pose average that moves every pose
        avg = jax_pose.average_poses(_random_poses(4, 7))
        for d in (mine, jaxs):
            np.savetxt(osp.join(d, "pose_avg_stats.txt"), avg)
    extra = ["--NeRFH", "--encode_hist", flag]
    ours = load_scene(parse_args(_argv(mine, dataset, extra) + ["--device", "cpu"]),
                      stage=stage)
    theirs = jax_load_scene(jax_parse_args(_argv(jaxs, dataset, extra)), stage=stage)
    _assert_same_scene(ours, theirs)
    saved = [np.loadtxt(osp.join(d, "pose_avg_stats.txt")) for d in (mine, jaxs)]
    np.testing.assert_array_equal(*saved)


def test_load_scene_early_errors(replicas, tmp_path):
    cfg = parse_args(["--dataset_type", "7scenes", "--datadir", str(tmp_path / "nowhere"),
                      "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown dataset_type"):
        load_scene(cfg)
    datadir, dataset, _ = replicas["jax_7scenes"]
    cfg = parse_args(_argv(_isolated(datadir, str(tmp_path / "c")), dataset,
                           ["--load_pose_avg_stats"]) + ["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="pose_avg_stats.txt missing"):
        load_scene(cfg)


@pytest.mark.parametrize("skip", [1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_readers_match_jax(replicas, train, skip):
    for name, loader, jax_loader, scene in (
            ("jax_7scenes", load_seven_scenes_split, jax_load_7scenes, "heads"),
            ("port_7scenes", load_seven_scenes_split, jax_load_7scenes, "heads"),
            ("jax_cambridge", load_cambridge_split, jax_load_cambridge, "KingsCollege"),
            ("port_cambridge", load_cambridge_split, jax_load_cambridge, "KingsCollege")):
        datadir = replicas[name][0]
        img_root = osp.join(osp.dirname(osp.dirname(datadir)), "deepslam_data",
                            osp.basename(osp.dirname(datadir)))
        kw = dict(train=train, skip=skip, df=2.0, ret_hist=False, ret_idx=True)
        a, b = loader(img_root, scene, **kw), jax_loader(img_root, scene, **kw)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.poses, b.poses)
        np.testing.assert_array_equal(a.hists, b.hists)
        np.testing.assert_array_equal(a.gt_idx, b.gt_idx)


def test_shopfacade_drops_two_train_frames_as_jax(tmp_path):
    """44 frames of 8x8: the train split loses sorted indices 42 and 35;
    a missing pose file is a count mismatch in both packages."""
    datadir = _write_fake_cambridge(str(tmp_path), scene="ShopFacade", n=44, H=8, W=8)
    img_root = osp.join(str(tmp_path), "deepslam_data", "Cambridge")
    for train in (True, False):
        a = load_cambridge_split(img_root, "ShopFacade", train=train, df=1.0)
        b = jax_load_cambridge(img_root, "ShopFacade", train=train, df=1.0)
        assert len(a.images) == (42 if train else 44)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.poses, b.poses)
        np.testing.assert_array_equal(a.gt_idx, b.gt_idx)
    argv = ["--datadir", datadir, "--dataset_type", "Cambridge", "--df", "1",
            "--encode_hist"]
    _assert_same_scene(load_scene(parse_args(argv + ["--device", "cpu"])),
                       jax_load_scene(jax_parse_args(argv)))
    os.remove(osp.join(img_root, "ShopFacade", "test", "poses", "frame00003.txt"))
    for loader in (load_cambridge_split, jax_load_cambridge):
        with pytest.raises(ValueError, match="count does not match"):
            loader(img_root, "ShopFacade", train=False)


@pytest.mark.parametrize("replica", ["port_7scenes", "port_cambridge"])
@pytest.mark.parametrize("stage", ["nerf", "apr"])
def test_replica_round_trip(replicas, replica, stage):
    """The writer's frames and sphere poses come back out of load_scene at
    the shipped stats setting: poses within 1e-6, images the uint8 frames
    / 255 area-downscaled, bit for bit."""
    datadir, dataset, rec = replicas[replica]
    argv = _argv(datadir, dataset, ["--NeRFH", "--encode_hist", "--load_pose_avg_stats"])
    scene = load_scene(parse_args(argv + ["--device", "cpu"]), stage=stage)
    train_key, val_key = (2, 1) if dataset == "7Scenes" else ("train", "test")
    for split, key, skip in ((scene.train, train_key, 2), (scene.val, val_key, 1)):
        np.testing.assert_allclose(split.poses, rec["poses"][key][::skip], atol=1e-6, rtol=0)
        want = [downscale_area((f / 255.0).astype(np.float32), 2.0)
                for f in rec["frames"][key][::skip]]
        np.testing.assert_array_equal(split.images, np.stack(want))
        np.testing.assert_array_equal(split.gt_idx, np.arange(0, len(rec["poses"][key]), skip))
    focal = {"7Scenes": 585.0, "Cambridge": 744.0}[dataset] / 2
    assert scene.hwf == [scene.train.images.shape[1], scene.train.images.shape[2], focal]
    assert (scene.near, scene.far) == (0.5, 3.5)
