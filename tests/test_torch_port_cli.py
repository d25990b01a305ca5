"""The port's stage-1 CLI and its import boundary, on the CPU."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.cli import nerf as cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.png import read_apng
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.training.checkpoints import save_pytree
from dfnet_tpu_torch.training.nerf_trainer import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down many times over: this
    module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The spiral and video renders of stage 1 run (they refused before the
    converters and view selection were ported): --render_pose_only writes
    a 120-frame animated PNG, --render_test with --render_video_train and
    --render_video_test the four split videos, all at JAX's names
    (tests/test_torch_port_tools.py holds their frames against JAX)."""
    argv = ["--config", "configs/config_synthetic.txt", "--basedir", str(tmp_path),
            "--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2",
            "--netwidth_fine", "16", "--N_samples", "4", "--N_importance", "4",
            "--render_factor", "4", "--device", "cpu"]
    _, params = create_nerfh(parse_args(argv), torch.Generator().manual_seed(3))
    save_pytree(str(tmp_path / "nerfh" / "000002.npz"), {"params": params}, global_step=2)
    path = cli.train(argv + ["--render_pose_only"])
    assert path == str(tmp_path / "nerfh" / "spiral_000002.png")
    assert read_apng(path).shape == (120, 12, 16, 3)
    cli.train(argv + ["--render_test", "--render_video_train", "--render_video_test"])
    for base, n in (("nerfh_trainset_000002_train", 12), ("nerfh_test_000002_test", 4)):
        for kind in ("rgb", "disp"):
            assert len(read_apng(str(tmp_path / "nerfh" / f"{base}_{kind}.png"))) == n


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
