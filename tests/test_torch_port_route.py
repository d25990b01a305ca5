"""The kernel route's one gate, render/fast.py::kernels_serve, on a grid of
models and settings, and the import rules between the port's layers.

The gate's table was written by running the two gates it replaced (the
test render's and the stage-1 step's) on this grid. Each entry reads the
answers at W = 32, 128, 192, 256 (both nets that wide), "1" where the
kernels serve."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import ast
import dataclasses
import pathlib

import pytest

from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.nerf_vanilla import VanillaNeRFConfig
from dfnet_tpu_torch.models.nerfw import NeRFWConfig
from dfnet_tpu_torch.render.fast import kernels_serve
from dfnet_tpu_torch.render.volume import NeRFHModel, RenderSettings, VanillaNeRFModel

WIDTHS = (32, 128, 192, 256)

# case: (N_samples, N_importance, settings fields, model change). A render
# reads the case's test settings with cull_q = its train_cull_q.
CASES = {
    "tileable": (16, 16, {}, None),
    "odd_samples": (17, 15, {}, None),
    "odd_union": (16, 17, {}, None),
    "importance_only": (16, 15, {"fine_importance_only": True}, None),
    "culled": (16, 16, {"train_cull_q": 2e-3, "train_fine_total": 24}, None),
    "culled_odd_total": (16, 16, {"train_cull_q": 2e-3, "train_fine_total": 23}, None),
    "windowed": (16, 16, {}, "windowed"),
    "proposal_w48": (16, 16, {}, "proposal_w48"),
    "no_transient": (16, 16, {}, "no_transient"),
}

# (case, model, route) -> served at WIDTHS
TABLE = {
    ("tileable", "nerfh", "render"): "1101",
    ("tileable", "nerfh", "train"): "1101",
    ("tileable", "vanilla", "render"): "1101",
    ("tileable", "vanilla", "train"): "1101",
    ("odd_samples", "nerfh", "render"): "0000",
    ("odd_samples", "nerfh", "train"): "0000",
    ("odd_samples", "vanilla", "render"): "0000",
    ("odd_samples", "vanilla", "train"): "0000",
    ("odd_union", "nerfh", "render"): "0000",
    ("odd_union", "nerfh", "train"): "0000",
    ("odd_union", "vanilla", "render"): "0000",
    ("odd_union", "vanilla", "train"): "0000",
    ("importance_only", "nerfh", "render"): "0000",
    ("importance_only", "nerfh", "train"): "1101",
    ("importance_only", "vanilla", "render"): "0000",
    ("importance_only", "vanilla", "train"): "0000",
    ("culled", "nerfh", "render"): "1101",
    ("culled", "nerfh", "train"): "1101",
    ("culled", "vanilla", "render"): "0000",
    ("culled", "vanilla", "train"): "0000",
    ("culled_odd_total", "nerfh", "render"): "1101",
    ("culled_odd_total", "nerfh", "train"): "0000",
    ("culled_odd_total", "vanilla", "render"): "0000",
    ("culled_odd_total", "vanilla", "train"): "0000",
    ("windowed", "nerfh", "render"): "0000",
    ("windowed", "nerfh", "train"): "0000",
    ("windowed", "vanilla", "render"): "0000",
    ("windowed", "vanilla", "train"): "0000",
    ("proposal_w48", "nerfh", "render"): "0000",
    ("proposal_w48", "nerfh", "train"): "1101",
    ("no_transient", "nerfh", "render"): "1101",
    ("no_transient", "nerfh", "train"): "0000",
}


def _model(kind: str, W: int, change):
    reduce = 2 if change == "windowed" else -1
    xyz, dirs = (get_embedder(F, 0, reduce, 100) for F in (10, 4))
    if kind == "vanilla":
        c = VanillaNeRFConfig(D=4, W=W, skips=(2,))
        return VanillaNeRFModel(c, c, xyz, dirs)
    coarse = NeRFWConfig(D=4, W=W, skips=(2,))
    fine = dataclasses.replace(coarse, encode_appearance=True,
                               encode_transient=change != "no_transient")
    proposal = NeRFWConfig(D=2, W=48 if change == "proposal_w48" else 64, skips=())
    return NeRFHModel(coarse, fine, xyz, dirs, cfg_proposal=proposal,
                      embed_proposal=get_embedder(10))


def _served(case: str, kind: str, route: str) -> str:
    S, I, fields, change = CASES[case]
    st = RenderSettings(N_samples=S, N_importance=I, near=0.5, far=3.5, **fields)
    out = ""
    for W in WIDTHS:
        m = _model(kind, W, change)
        ok = (kernels_serve(m, st, train=True) if route == "train"
              else kernels_serve(m, st.test(), cull_q=st.train_cull_q))
        out += "1" if ok else "0"
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_serve_table(case):
    got = {key: _served(*key) for key in TABLE if key[0] == case}
    assert got == {key: v for key, v in TABLE.items() if key[0] == case}


def test_kernels_serve_refuses_other_models():
    assert not kernels_serve(object(), RenderSettings())


PORT = pathlib.Path(__file__).resolve().parents[1] / "dfnet_tpu_torch"


def _imports(path: pathlib.Path):
    """(module, names) of each absolute import statement of a source file;
    names is empty for `import m`."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((a.name, []) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, [a.name for a in node.names]


def _targets(module: str, names):
    """The modules an import statement may load: the module, and each
    name as a submodule of it."""
    return [module] + [f"{module}.{n}" for n in names]


def test_layers_import_one_way():
    """ops/ takes nothing from render/ but its leaf, render/sampling.py; the
    plain renderer and the train route do not import render/fast.py (the
    kernel render and the gate); no port module imports another module's
    _private name."""
    leaf, fast = "dfnet_tpu_torch.render.sampling", "dfnet_tpu_torch.render.fast"
    bad = []
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 50
    for path in files:
        rel = path.relative_to(PORT).as_posix()
        for module, names in _imports(path):
            targets = _targets(module, names)
            if rel.startswith("ops/") and any(
                    t.startswith("dfnet_tpu_torch.render.")
                    and not (t == leaf or t.startswith(leaf + ".")) for t in targets):
                bad.append((rel, module, names))
            if rel in ("render/volume.py", "render/fused_train.py") and any(
                    t == fast or t.startswith(fast + ".") for t in targets):
                bad.append((rel, module, names))
            if module.startswith("dfnet_tpu_torch") and any(n.startswith("_")
                                                            for n in names):
                bad.append((rel, module, names))
    assert bad == []
