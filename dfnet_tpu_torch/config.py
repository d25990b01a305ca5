"""Unified typed configuration — the port's copy of dfnet_tpu/config.py.

The same schema and `.txt` parsing as the JAX package, so the shipped
`configs/*.txt` files parse to the same fields in both packages. The
reference carries three overlapping configargparse parsers
(models/options.py, feature/options.py, dm/options.py in the DFNet
sources). Here there is ONE schema (`Config`) plus
per-stage default overlays (`STAGE_DEFAULTS`), while keeping the
reference's `--config file.txt` CLI surface: the same shipped config
files (`key = value` lines, `#` comments, bracketed float lists such as
`combine_loss_w = [0., 0., 1.]`) parse unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Config:
    # ---- experiment / IO ----
    config: Optional[str] = None
    expname: str = "exp"
    basedir: str = "../logs"
    datadir: str = "./data/llff/fern"
    model_name: str = "dfnet"
    dataset_type: str = "llff"          # 7Scenes / Cambridge / synthetic

    # ---- dataset ----
    trainskip: int = 1
    testskip: int = 1
    df: float = 1.0
    batch_size: int = 1
    val_batch_size: int = 1
    save_pose_avg_stats: bool = False
    load_pose_avg_stats: bool = False
    finetune_unlabel: bool = False      # stage 3 self-supervised mode: train split = test seqs
    half_res: bool = False

    # ---- NeRF model ----
    netdepth: int = 8
    netwidth: int = 128
    netdepth_fine: int = 8
    netwidth_fine: int = 128
    N_rand: int = 1536
    lrate: float = 5e-4
    lrate_decay: float = 250.0          # exponential decay horizon, in 1000s of steps
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64
    no_reload: bool = False
    ft_path: Optional[str] = None
    no_grad_update: bool = False

    # ---- NeRF-Hist ----
    NeRFH: bool = False
    N_vocab: int = 1000
    fix_index: bool = False
    encode_hist: bool = False
    hist_bin: int = 10
    in_channels_a: int = 50             # appearance embedding dim (hist_bin * N_a)
    in_channels_t: int = 20             # transient embedding dim (hist_bin * N_tau)

    # ---- rendering ----
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    use_viewdirs: bool = True
    i_embed: int = 0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    render_only: bool = False
    render_test: bool = False
    render_factor: int = 0
    reduce_embedding: int = -1
    epochToMaxFreq: int = -1
    render_pose_only: bool = False
    render_video_train: bool = False
    render_video_test: bool = False
    no_ndc: bool = True
    lindisp: bool = False
    white_bkgd: bool = False
    beta_min: float = 0.1
    tinyimg: bool = False
    out_channel_size: int = 3          # >3 = feature-field NeRF (rgb + C feature channels)
    tinyscale: float = 4.0

    # ---- stage-2/3 (APR / direct matching) ----
    pose_only: int = 1
    learning_rate: float = 1e-4
    featurenet_batch_size: int = 8
    dm_batch_size: int = 1             # stage-3 images per update: 1 = reference per-image loop;
                                       # K>1 batches pose-predict/render/features into one dispatch
    pretrain_model_path: str = ""
    pretrain_featurenet_path: str = ""
    combine_loss: bool = False
    combine_loss_w: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])
    patience: List[int] = field(default_factory=lambda: [200, 50])
    freezeBN: bool = False
    preprocess_ImgNet: bool = False
    eval: bool = False
    no_save_multiple: bool = False
    save_all_ckpt: bool = False
    DFNet: bool = False
    DFNet_s: bool = False
    featurelossonly: bool = False
    poselossonly: bool = False
    tripletloss: bool = False
    triplet_margin: float = 1.0
    # triplet pairwise-distance reduction axis: None = auto (reference's
    # W axis for .pt-ported models, C otherwise); True forces the
    # reference-exact axis, False forces C (see training/feature_losses)
    triplet_ref_axis: Optional[bool] = None
    random_view_synthesis: bool = False
    rvs_refresh_rate: int = 2
    rvs_trans: float = 5.0
    rvs_rotation: float = 1.2
    d_max: float = 1.0
    featuremetric: bool = False
    svd_reg: bool = False
    val_on_psnr: bool = False
    feature_matching_lvl: List[int] = field(default_factory=lambda: [0, 1, 2])
    per_channel: bool = False
    render_feature_only: bool = False
    i_eval: int = 50

    # ---- training schedule / logging ----
    epochs: int = 600
    i_print: int = 1
    i_weights: int = 200
    i_testset: int = 200

    # ---- additions of the JAX package (not in the reference); the port
    # reads them all so both packages parse the same files ----
    precision: str = "fp32"             # fp32 | bf16 — MLP matmul precision
    feature_precision: str = "bf16"     # fp32 | bf16 — DFNet conv-stack compute
                                        # dtype (stages 2/3); master weights, BN
                                        # stats and losses stay f32 either way
    fine_importance_only: bool = False  # fast profile: fine MLP on importance samples only
    fast_render: bool = True            # fused CUDA kernels for test-time renders (no-grad paths)
    fused_train: bool = True            # fused kernels for the stage-1 train step (training slice)
    render_cull_q: float = 0.0          # >0: culled fast-path sampling (empty-space + termination)
    render_fine_total: int = 0          # culled mode: fine samples/ray (0 = N_samples+N_importance)
    render_place_samples: int = 0       # culled mode: placement-sweep samples (0 = N_samples)
    train_cull_q: float = 0.0           # >0: culled TRAIN-time fine sampling (stage 1)
    train_fine_total: int = 0           # culled train: fine samples/ray (0 = N_samples+N_importance)
    train_cull_warmup: int = 0          # culled train: epochs on the reference schedule first.
                                        # Measured: warmup does NOT help (QUALITY.md round-4
                                        # ablation) — kept as a schedule-research knob
    proposal: bool = True               # train a tiny proposal sampler alongside NeRF-H stage 1
    proposal_D: int = 2                 # proposal MLP depth
    proposal_W: int = 64                # proposal MLP width
    proposal_multires: int = 4          # proposal PE frequencies (small: cheap features suffice)
    proposal_loss_w: float = 1.0        # weight of the interlevel bound loss
    proposal_render: bool = True        # place test-render samples with the proposal net when present
    mesh_shape: Optional[int] = None    # data-parallel mesh size; None = all local devices
    prefetch: int = 0                   # >0: double-buffered host→HBM batches (depth), for
                                        # larger-than-HBM datasets; 0 = device-resident/sync
    donate_step: bool = True            # donate params/opt_state buffers in jitted steps
    check_numerics: bool = False        # failure detection: error out on NaN/Inf in any jitted op
    compilation_cache_dir: str = "~/.cache/dfnet_tpu/xla"  # JAX package only; parsed and unused here
    aot_cache_dir: str = "~/.cache/dfnet_tpu/aot"  # JAX package only; parsed and unused here
    rng_seed: int = 0
    device: str = "cuda"                # port only: torch device of the entry points ("cpu" to opt out of the GPU)
    vgg_init_path: str = ""             # torchvision VGG16 ImageNet state-dict file, read by
                                        # torch.load (convert.py::convert_vgg16_imagenet)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Per-entry-point default overlays reproducing the reference parsers'
# conflicting defaults (nerf: models/options.py, feature:
# feature/options.py, dm: dm/options.py).
STAGE_DEFAULTS = {
    "nerf": dict(epochs=600, no_grad_update=False),
    "feature": dict(
        epochs=2000, learning_rate=1e-4, NeRFH=True, no_grad_update=False,
        combine_loss_w=[1.0, 1.0, 1.0], pose_only=1,
    ),
    "dm": dict(
        epochs=2000, learning_rate=1e-5, no_grad_update=True,
        combine_loss_w=[0.5, 0.5], pose_only=0, basedir="../logs/",
    ),
}

_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(name: str, raw, current):
    """Coerce a raw string (or list of strings) to the field's type."""
    f = _FIELDS[name]
    # `from __future__ import annotations` stringizes f.type, so compare
    # against the string forms ("bool", "Optional[bool]").
    ftype = f.type if isinstance(f.type, str) else str(f.type)
    is_bool_field = (ftype in ("bool", "Optional[bool]")
                     or isinstance(current, bool))
    if isinstance(raw, bool):
        # a bare flag (no value) parses as True — fine for bool fields,
        # a user error for anything else (e.g. `--pretrain_model_path
        # --epochs 2` after an empty shell substitution)
        if not is_bool_field:
            raise SystemExit(
                f"[config] --{name} requires a value (got a bare flag)")
        return raw
    if is_bool_field:
        if isinstance(raw, str):
            return raw.strip().lower() in ("true", "1", "yes", "on")
        return bool(raw)
    if isinstance(current, list) or (isinstance(raw, list)):
        items = raw if isinstance(raw, list) else _split_list(raw)
        elem = float if name in ("combine_loss_w",) else int
        if name == "feature_matching_lvl" or name == "patience":
            elem = int
        return [elem(x) for x in items]
    if isinstance(current, int) and not isinstance(current, bool):
        return int(float(raw))
    if isinstance(current, float):
        return float(raw)
    if raw == "None":
        return None
    return raw


def _split_list(s: str) -> List[str]:
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        s = s[1:-1]
    parts = [p for p in s.replace(",", " ").split() if p]
    return parts


def _strip_comment(line: str) -> str:
    # a '#' starts a comment unless inside brackets — the shipped configs
    # only use trailing comments, so a simple split is enough.
    out = []
    for ch in line:
        if ch == "#":
            break
        out.append(ch)
    return "".join(out)


def parse_config_file(path: str) -> dict:
    """Parse the reference's configargparse-style `key = value` text file."""
    kv = {}
    with open(path) as fh:
        for line in fh:
            line = _strip_comment(line).strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key, val = key.strip(), val.strip()
            if key:
                kv[key] = val
    return kv


def _field_help() -> Dict[str, str]:
    """Flag help scraped from this file's own field comments (trailing
    `# ...` plus immediately-preceding full-line comments inside the
    Config body) — one source of truth, no duplicated help table."""
    help_kv: Dict[str, str] = {}
    pending: List[str] = []
    in_config = False
    # inspect.getsource consults the module loader (works for zipimport /
    # relocated installs where __file__ is stale); reading __file__ is the
    # fallback. Bytecode-only installs have no source — help degrades to
    # flag names only, which argparse still renders.
    try:
        import inspect

        src = inspect.getsource(sys.modules[__name__]).splitlines()
    except Exception:
        try:
            src = open(__file__).read().splitlines()
        except OSError:
            return help_kv
    for line in src:
        if line.startswith("class Config"):
            in_config = True
            continue
        if in_config and line and not line.startswith((" ", ")")):
            break  # left the class body
        if not in_config:
            continue
        stripped = line.strip()
        if not stripped:
            pending = []  # blank line detaches preceding comments
            continue
        if stripped.startswith("#"):
            text = stripped.lstrip("# ")
            if not text.startswith("----"):  # skip section dividers
                pending.append(text)
            continue
        m = re.match(r"(\w+)\s*:\s*[^=]+=\s*[^#]*(?:#\s*(.*))?$", stripped)
        if m and m.group(1) in _FIELDS:
            parts = pending + ([m.group(2)] if m.group(2) else [])
            if parts:
                help_kv[m.group(1)] = " ".join(parts)
            pending = []
        elif stripped:
            # continuation line of a multi-line default; keep trailing
            # comments attached to the last seen field
            pass
    return help_kv


def print_help(stage: str = "nerf") -> None:
    """--help for the three CLIs: every flag with its (stage-overlaid)
    default and the comment from the Config schema."""
    prog = {"nerf": "python -m dfnet_tpu_torch.cli.nerf"}.get(stage, stage)
    print(f"usage: {prog} [--config FILE.txt] [--FLAG VALUE ...]\n")
    print("Reference-compatible flags (CLI overrides --config file, "
          "which overrides stage defaults):\n")
    helps = _field_help()
    defaults = dict(STAGE_DEFAULTS.get(stage, {}))
    for f in dataclasses.fields(Config):
        d = defaults.get(f.name, f.default if f.default is not
                         dataclasses.MISSING else f.default_factory())
        h = helps.get(f.name, "")
        print(f"  --{f.name:<24} (default: {d!r}) {h}")


def parse_args(argv: Optional[List[str]] = None, stage: str = "nerf") -> Config:
    """Build a Config from CLI args + optional --config file, with
    per-stage defaults. CLI flags override the config file, which
    overrides stage defaults (same precedence as configargparse)."""
    if argv is None:
        argv = sys.argv[1:]
    if "-h" in argv or "--help" in argv:
        print_help(stage)
        sys.exit(0)
    cfg = Config()
    for k, v in STAGE_DEFAULTS.get(stage, {}).items():
        object.__setattr__(cfg, k, v)

    cli_kv = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            i += 1
            continue
        name = tok[2:]
        if "=" in name:
            name, val = name.split("=", 1)
            cli_kv[name] = val
            i += 1
            continue
        # boolean flags may appear bare; list flags may take several values
        vals = []
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            vals.append(argv[j])
            j += 1
        if not vals:
            cli_kv[name] = True
        elif len(vals) == 1:
            cli_kv[name] = vals[0]
        else:
            cli_kv[name] = vals
        i = j

    file_kv = {}
    cfg_path = cli_kv.get("config")
    if isinstance(cfg_path, str):
        file_kv = parse_config_file(cfg_path)
        cfg = cfg.replace(config=cfg_path)

    merged = dict(file_kv)
    merged.update(cli_kv)
    unknown = []
    for k, v in merged.items():
        if k not in _FIELDS:
            unknown.append(k)
            continue
        cur = getattr(cfg, k)
        object.__setattr__(cfg, k, _coerce(k, v, cur))
    if unknown:
        print(f"[config] ignoring unknown keys: {sorted(unknown)}", file=sys.stderr)
    return cfg


@contextlib.contextmanager
def apply_runtime_flags(cfg: Config):
    """The runtime knobs of a CLI run, for the run's duration (`with
    apply_runtime_flags(cfg): ...`; call once per CLI).

    check_numerics is the failure-detection knob, the counterpart of the
    JAX package's jax_debug_nans: torch's autograd anomaly mode with its
    NaN check, so a backward op that returns a NaN raises and names
    itself; and each trainer's step checks its loss (check_finite_loss),
    so the step that makes a non-finite loss raises FloatingPointError
    before it updates a weight. Anomaly mode is global in torch, so it is
    put back as it was when the run ends."""
    if not cfg.check_numerics:
        yield
        return
    import torch

    prev = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev[0], check_nan=prev[1])


def check_finite_loss(loss, where: str) -> None:
    """Raise FloatingPointError naming `where` when the scalar `loss` is NaN
    or infinite (check_numerics; reads the loss back, a device sync)."""
    value = float(loss.detach())
    if not math.isfinite(value):
        raise FloatingPointError(f"--check_numerics: loss {value} at {where}")
