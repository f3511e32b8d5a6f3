"""The port's checkpoint manager: the reference's three cases
(``tests/test_ckpt_and_serve.py``) with bf16 leaves, and checkpoints
read across the packages in both directions (the same on-disk layout).
Restored values must be bit-equal: no tolerance."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefManager
from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticData as RefData
from repro.models.registry import build_model as ref_build_model
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train import step as ref_step
from repro_torch.ckpt import manager
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ShapeSpec, get_reduced_config
from repro_torch.data.pipeline import SyntheticData
from repro_torch.models.param import (params_from_numpy, tree_leaves,
                                      tree_map)
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the models here are tiny, and torch's thread
    pool spins when the test workers share the cores (a 16x slower file
    under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.full((2, 3), 0.3, dtype=torch.bfloat16)},
            "n": torch.tensor(3, dtype=torch.int32)}


def _equal(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_ckpt_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, tree_map(lambda x: x + s, _tree()))
    assert mgr.latest_step() == 3
    assert sorted(mgr.all_steps()) == [2, 3]          # keep=2 GC'd step 1
    got = mgr.restore(3, tree_map(lambda x: x.to("meta"), _tree()))
    _equal(got, tree_map(lambda x: x + 3, _tree()))
    meta = json.loads((tmp_path / "step_000000000003" / "meta.json")
                      .read_text())
    # the reference's record: bf16 as a uint8 view, jax's leaf order
    assert meta["dtypes"] == ["float32", "bfloat16", "bfloat16", "int32"]
    assert meta["shapes"] == [[3, 4], [10], [2, 6], []]
    assert (tmp_path / "LATEST").read_text() == "step_000000000003"


def test_ckpt_async_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    tree = {"w": torch.full((64, 64), 2.0),
            "h": torch.full((8, 8), -1.5, dtype=torch.bfloat16)}
    mgr.save(10, tree)
    tree["w"].fill_(7.0)           # the save snapshotted before returning
    mgr.wait()
    s, got = mgr.restore_latest(tree)
    assert s == 10
    assert torch.equal(got["w"], torch.full((64, 64), 2.0))
    assert torch.equal(got["h"], tree["h"])


def test_ckpt_ignores_partial_tmp(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(5, {"x": torch.ones(3)})
    # a crashed writer leaves a tmp dir behind: it must be invisible
    (tmp_path / "step_000000000009.tmp.123.456").mkdir()
    assert mgr.latest_step() == 5
    assert mgr.all_steps() == [5]


def test_ckpt_write_error_raises_at_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, async_save=True)

    def full(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(manager.np, "savez", full)
    mgr.save(1, {"x": torch.ones(3)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                      # reported once
    assert mgr.latest_step() is None


def test_restore_onto_a_device_and_shape_check(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _tree())
    got = mgr.restore(1, _tree(), device="cpu")
    _equal(got, _tree())
    bad = _tree()
    bad["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"a": torch.zeros(3, 4)})


# ---------------------------------------------------------------------------
# across the packages: a reduced qwen train state with bf16 moments
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=1, moment_dtype="bfloat16")


@pytest.fixture(scope="module")
def states():
    """The reference's state after one step, and the port's after one
    step from the same params and batch (fp32 masters, bf16 moments)."""
    ref_cfg = dataclasses.replace(ref_reduced_config("qwen1_5_4b"),
                                  dtype="float32")
    cfg = dataclasses.replace(get_reduced_config("qwen1_5_4b"),
                              dtype="float32")
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_state, _ = ref_step.init_train_state(ref_model, RefOptConfig(**OPT),
                                             jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_state["params"]),
                               "cpu")
    batch = RefData(ref_cfg, RefShapeSpec("t", 16, 2, "train")).batch(0)
    ref_state, _ = jax.jit(ref_step.make_train_step(
        ref_model, RefOptConfig(**OPT)))(ref_state, batch)
    state = step.init_train_state(model, OptConfig(**OPT), params=params)
    data = SyntheticData(cfg, ShapeSpec("t", 16, 2, "train"), device="cpu")
    state, _ = step.make_train_step(model, OptConfig(**OPT))(
        state, data.batch(0))
    return model, ref_state, state


def test_reference_checkpoint_restores_in_the_port(tmp_path, states):
    model, ref_state, state = states
    RefManager(tmp_path, async_save=False).save(1, ref_state)
    got = CheckpointManager(tmp_path).restore(1, state)
    want = tree_leaves(got)
    ref = jax.tree.leaves(ref_state)
    assert len(want) == len(ref) > 10
    assert {t.dtype for t in tree_leaves(got["opt"]["m"])} == {
        torch.bfloat16}
    for g, r in zip(want, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        if r.dtype.name == "bfloat16":
            assert torch.equal(g, torch.from_numpy(
                r.view(np.int16).copy()).view(torch.bfloat16))
        else:
            np.testing.assert_array_equal(g.numpy(), r)


def test_port_checkpoint_restores_in_the_reference(tmp_path, states):
    model, ref_state, state = states
    CheckpointManager(tmp_path, async_save=False).save(4, state)
    mgr = RefManager(tmp_path)
    assert mgr.latest_step() == 4
    got = mgr.restore(4, jax.eval_shape(lambda: ref_state))
    for g, p in zip(jax.tree.leaves(got), tree_leaves(state)):
        g = np.asarray(g)
        assert g.shape == tuple(p.shape)
        if p.dtype == torch.bfloat16:
            assert g.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                g.view(np.int16), p.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(g, p.numpy())
