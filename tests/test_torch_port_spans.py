"""The program's phase regions (utils/profiling.py::annotate) on the CPU,
where the kernels run their plain versions: none is opened outside a
profiler; under torch.profiler a render view, a fused stage-1 step and a
stage-3 step each record one root region with their phases inside it, in
the order they run; and the profiler leaves the results bit-equal.

Imports neither JAX nor dfnet_tpu, so it also runs on a machine that has
only PyTorch for CUDA; there the `gpu` test traces a view and a step on
the card:

    python -m pytest --noconftest tests/test_torch_port_spans.py

Tiny sizes: D=2 W=32 NeRF-H on 8x8 (train) and 12x16 (render) views; the
DM step is parity.dm_trainer's (48x64 frames, DFNet at full width)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.render import fast
from dfnet_tpu_torch.render.volume import chunked_rays
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, named_leaves
from dfnet_tpu_torch.utils import profiling

TINY = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
        "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
        "--netwidth_fine", "32", "--N_samples", "8", "--N_importance", "8",
        "--N_rand", "64", "--expname", "nerfh"]
CULLED = ["--render_cull_q", "2e-3", "--render_fine_total", "8",
          "--render_place_samples", "8"]
CHUNK = ["placement", "sample", "fine", "composite"]
TRAIN = ["step", "draw", "pack", "coarse", "composite", "sample", "pack", "fine",
         "composite", "proposal", "backward", "adam"]


def _trainer(tmp_path, device="cpu", *flags, H=8, W=8):
    cfg = parse_args(TINY + list(flags) + ["--basedir", str(tmp_path), "--device",
                                           str(device)])
    return NeRFTrainer(cfg, make_synthetic_scene(n_train=2, n_val=1, H=H, W=W,
                                                 focal=float(W), seed=0))


def _regions(prof):
    """(name, start, end) of the program's regions, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("dfnet.") and str(e.device_type()).endswith("CPU")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _traced(fn, device="cpu"):
    """(fn(), its regions, its host runtime calls: (name, start, end))."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=acts) as prof:
        out = fn()
    calls = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("cuda")]
    return out, _regions(prof), calls


def _phases(regions, stage):
    """The regions' phase names; each inside the first, the stage's root."""
    (_, s0, e0) = regions[0]
    assert all(s0 <= s and e <= e0 for _, s, e in regions)
    prefix = f"dfnet.{stage}."
    assert all(n.startswith(prefix) for n, _, _ in regions)
    return [n[len(prefix):] for n, _, _ in regions]


def _view(tr):
    pose = torch.as_tensor(tr.scene.val.poses[0], dtype=torch.float32, device=tr.device)
    hist = torch.as_tensor(tr.scene.val.hists[0], device=tr.device)
    return tr._render(tr.params, pose, hist, 0)


@contextlib.contextmanager
def _no_regions(monkeypatch):
    """Fail on any region opened inside the block."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    yield
    assert opened == []


# ---------------------------------------------------------------------------

def test_annotate_is_the_shared_noop_outside_a_profiler():
    assert profiling.annotate("dfnet.a") is profiling.annotate("dfnet.b")
    with profiling.annotate("dfnet.a") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("dfnet.a"), torch.profiler.record_function)
    assert profiling.annotate("dfnet.a") is profiling.annotate("dfnet.b")


def test_no_region_outside_a_profiler(tmp_path, monkeypatch):
    tr = _trainer(tmp_path)
    dm = parity.dm_trainer(str(tmp_path), "cpu")
    images, poses12, hists = dm.train_data
    with _no_regions(monkeypatch):
        _view(tr)
        tr.train_step(0, 1e-3)
        dm.train_step(images[:1], poses12[:1], hists[:1])


def test_train_step_regions_and_bit_equal_results(tmp_path):
    assert _trainer(tmp_path).uses_fused_train
    plain, traced = _trainer(tmp_path / "a"), _trainer(tmp_path / "b")
    loss, psnr = plain.train_step(0, 1e-3)
    (t_loss, t_psnr), regions, _ = _traced(lambda: traced.train_step(0, 1e-3))
    assert _phases(regions, "train") == TRAIN
    assert torch.equal(loss, t_loss) and torch.equal(psnr, t_psnr)
    for (p, a), (_, b) in zip(named_leaves(plain.params), named_leaves(traced.params)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("flags", [[], CULLED], ids=["exact", "culled"])
def test_view_regions_and_bit_equal_rgb(tmp_path, flags):
    # 12x16 views in chunks of 96 rays: two chunks a view
    tr = _trainer(tmp_path, "cpu", "--chunk", "96", *flags, H=12, W=16)
    assert tr.uses_fast_render
    want = _view(tr)
    got, regions, _ = _traced(lambda: _view(tr))
    assert _phases(regions, "render") == ["view", "pack"] + CHUNK + CHUNK
    for k in ("rgb", "disp", "acc"):
        assert torch.equal(want[k], got[k]), k


def test_mono_view_regions(tmp_path):
    """The mono path (proposal_z_rows, fine_composite_t) has no sample
    phase: placement, fine and composite a chunk."""
    tr = _trainer(tmp_path)
    settings = tr.settings_test
    pose = torch.as_tensor(tr.scene.val.poses[0], dtype=torch.float32)
    hist = torch.as_tensor(tr.scene.val.hists[0])
    packed = fast.FastNeRFH.pack(tr.params, tr.model)
    _, ro, rd = chunked_rays(8, 8, 8.0, pose, 64, None)
    _, regions, _ = _traced(lambda: fast.render_rays_fast(
        packed, ro[0], rd[0], hist[None], settings, exact_union=False, mono=True))
    assert [n for n, _, _ in regions] == ["dfnet.render.placement", "dfnet.render.fine",
                                          "dfnet.render.composite"]


def test_dm_step_regions(tmp_path):
    dm = parity.dm_trainer(str(tmp_path), "cpu")
    images, poses12, hists = dm.train_data
    _, regions, _ = _traced(lambda: dm.train_step(images[:1], poses12[:1], hists[:1]))
    assert _phases(regions, "dm") == ["step", "pose", "svd", "render", "match", "backward",
                                      "adam"]
    spans = dict((n, (s, e)) for n, s, e in regions)
    (ps, pe), (ss, se) = spans["dfnet.dm.pose"], spans["dfnet.dm.svd"]
    assert ps <= ss and se <= pe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_view_and_step_regions_on_the_card(tmp_path, cuda):
    """A traced view and stage-1 step on the card: every region, and the
    kernels' launches inside the roots."""
    tr = _trainer(tmp_path, cuda, "--chunk", "96", H=12, W=16)
    _view(tr)
    tr.train_step(0, 1e-3)          # builds the kernels outside the trace
    torch.cuda.synchronize()
    for fn, stage, want in ((lambda: _view(tr), "render", ["view", "pack"] + CHUNK + CHUNK),
                            (lambda: tr.train_step(0, 1e-3), "train", TRAIN)):
        _, regions, calls = _traced(lambda: (fn(), torch.cuda.synchronize()), "cuda")
        assert _phases(regions, stage) == want
        _, s0, e0 = regions[0]
        assert any(n.startswith("cudaLaunch") and s0 <= s and e <= e0 for n, s, e in calls)
