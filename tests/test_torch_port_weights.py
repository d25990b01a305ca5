"""The port's checkpoint format and weight bridge against the JAX package:
the trained assets round-trip bit-exact through
load_pytree -> params_from_numpy -> params_to_numpy -> save_pytree and
read back with dfnet_tpu's load_pytree."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from dfnet_tpu.training.checkpoints import load_pytree as jax_load_pytree
from dfnet_tpu_torch.training import checkpoints as ck


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("asset", ["nerfh_synthetic_301.npz",
                                   "nerfh_synthetic_301_w256.npz"])
def test_asset_round_trip_bit_exact(asset, tmp_path):
    src = f"assets/{asset}"
    tree, scalars = ck.load_pytree(src)
    params = ck.params_from_numpy(tree, "cpu")
    for name, t in _leaves(params):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32, name
    back = ck.params_to_numpy(params)
    out = tmp_path / "rt.npz"
    ck.save_pytree(str(out), back, **scalars)

    want, want_sc = jax_load_pytree(src)
    got, got_sc = jax_load_pytree(str(out))
    want_l, got_l = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(want_l) == sorted(got_l)
    assert len(want_l) == 70          # every array of coarse/fine/proposal/embeddings
    for k in want_l:
        assert want_l[k].dtype == got_l[k].dtype, k
        np.testing.assert_array_equal(got_l[k], want_l[k], err_msg=k)
    assert {k: int(v) for k, v in got_sc.items()} == {
        k: int(v) for k, v in want_sc.items()}
    with np.load(src) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)


def test_latest_checkpoint_picks_highest_step(tmp_path):
    for step in (3, 12, 7):
        ck.save_pytree(str(tmp_path / f"{step:06d}.npz"), {"x": np.zeros(1)},
                       global_step=step)
    (tmp_path / "notes.npz").write_bytes(b"")
    assert ck.latest_checkpoint(str(tmp_path)).endswith("000012.npz")
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None
