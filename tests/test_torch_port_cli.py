"""The port's stage-1 CLI and its import boundary, on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.cli import nerf as cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.training.checkpoints import save_pytree
from dfnet_tpu_torch.training.nerf_trainer import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_render_test_on_cpu_prints_psnr(tmp_path, capsys):
    argv = ["--config", "configs/config_synthetic.txt", "--basedir", str(tmp_path)]
    cfg = parse_args(argv + ["--device", "cpu"])
    _, params = create_nerfh(cfg, torch.Generator().manual_seed(3))
    save_pytree(str(tmp_path / "nerfh" / "000005.npz"), {"params": params},
                global_step=5)
    psnr = cli.train(argv + ["--render_test", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 5" in out
    assert f"Mean PSNR of this run is: {psnr}" in out
    assert np.isfinite(psnr)
    pngs = sorted(os.listdir(tmp_path / "nerfh" / "evaluate_val_test_000005"))
    assert pngs[:3] == ["000.png", "000_GT.png", "000_disp.png"]


def test_spiral_and_video_renders_refuse(tmp_path):
    """Training is ported; the spiral and video renders of stage 1 are not,
    and refuse before anything loads."""
    argv = ["--config", "configs/config_synthetic.txt", "--basedir", str(tmp_path),
            "--device", "cpu"]
    for flag in ("--render_pose_only", "--render_video_train", "--render_video_test"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.train(argv + [flag])
    assert not os.path.exists(tmp_path / "nerfh")


def test_no_gpu_raises_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.train(["--config", "configs/config_synthetic.txt", "--basedir",
                   str(tmp_path), "--render_test"])
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_write_png_round_trips(tmp_path):
    import struct
    import zlib

    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (7, 5)
    n = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img)


def test_port_imports_neither_jax_nor_dfnet_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dfnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(dfnet_tpu_torch.__path__, 'dfnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dfnet_tpu' or m.startswith('dfnet_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('dfnet_tpu_torch')]))\n"
        "assert 'dfnet_tpu_torch.cli.feature' in sys.modules\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 48      # stage 2 included
