"""The port's AdamW against the reference's ``optim/adamw.py``.

Both packages get the same fp32 params and, each step, the same seeded
gradients.  Tolerances: fp32 results (params, fp32 moments, the error
feedback, ``grad_norm``, ``lr``) within 1e-6 of the value plus 1e-6 of
the leaf's largest magnitude (a few ulps: pow, cos, sqrt, the reduction
order of the norm and XLA's fused multiply-adds differ in the last bits,
and a moment's two terms can cancel); bf16 moments within one bf16 ulp
of the reference's (one rounding of an fp32 value that may differ in its
last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adamw

RTOL = 1e-6
SHAPES = {"w": (24, 16), "b": (16,), "sub": {"u": (3, 8, 5), "s": (7,)}}


def _tree(fn, shapes=SHAPES, path=()):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, path + (k,)) for k, v in shapes.items()}
    return fn(path, shapes)


def _draw(seed):
    rng = np.random.default_rng(seed)
    return _tree(lambda path, s: rng.standard_normal(s).astype(np.float32))


def _bf16_ulp(x):
    a = np.abs(x.astype(np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _close(got, want, moment_bf16=False):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    if moment_bf16:
        assert np.all(np.abs(g - w) <= _bf16_ulp(w)), np.abs(g - w).max()
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("step", [0, 1, 2, 50, 99, 100, 101, 1000, 9999,
                                  10_000, 12_345])
def test_schedule(step):
    cfg = adamw.OptConfig()
    ref = ref_adamw.OptConfig()
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = ref_adamw.schedule(ref, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32 and got.ndim == 0
    _close(got, np.asarray(want))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [None, "bf16", "bf16_ef"])
def test_apply_updates_three_steps(moment_dtype, compress):
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=6, clip_norm=5.0,
              moment_dtype=moment_dtype, compress=compress)
    cfg, ref_cfg = adamw.OptConfig(**kw), ref_adamw.OptConfig(**kw)
    p0 = _draw(0)
    params = _tree(lambda path, s: torch.from_numpy(
        p0[path[0]] if len(path) == 1 else p0[path[0]][path[1]]).clone())
    state = adamw.init_opt_state(cfg, params)
    ref_params = jax.tree.map(jnp.asarray, p0)
    ref_state = ref_adamw.init_opt_state(ref_cfg, ref_params)
    for step in range(3):
        # a gradient scale that crosses the clip norm on the second step
        g = jax.tree.map(lambda a: a * (3.0 if step == 1 else 0.5),
                         _draw(100 + step))
        grads = jax.tree.map(torch.from_numpy, g)
        params, state, stats = adamw.apply_updates(cfg, params, grads, state)
        ref_params, ref_state, ref_stats = ref_adamw.apply_updates(
            ref_cfg, ref_params, jax.tree.map(jnp.asarray, g), ref_state)
        assert int(state["count"]) == int(ref_state["count"]) == step + 1
        for k in ("grad_norm", "lr"):
            _close(stats[k], np.asarray(ref_stats[k]))
        for a, b in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
            assert a.dtype == torch.float32
            _close(a, np.asarray(b))
        for key in ("m", "v"):
            for a, b in zip(tree_leaves(state[key]),
                            jax.tree.leaves(ref_state[key])):
                assert str(a.dtype).endswith(moment_dtype)
                _close(a, np.asarray(b, np.float32),
                       moment_bf16=moment_dtype == "bfloat16")
        assert ("ef" in state) == ("ef" in ref_state) == (
            compress == "bf16_ef")
        if compress == "bf16_ef":
            for a, b in zip(tree_leaves(state["ef"]),
                            jax.tree.leaves(ref_state["ef"])):
                _close(a, np.asarray(b))


def test_global_norm_and_leaf_order():
    tree = {"b": torch.ones(3), "a": {"y": torch.full((2,), 2.0),
                                      "x": torch.zeros(1)}}
    assert [float(t.sum()) for t in tree_leaves(tree)] == [0.0, 4.0, 3.0]
    assert float(adamw.global_norm(tree)) == pytest.approx(np.sqrt(11.0))


def test_update_is_in_place_and_grads_untouched():
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=1)
    params = {"w": torch.ones(4, 4)}
    ptr = params["w"].data_ptr()
    state = adamw.init_opt_state(cfg, params)
    grads = {"w": torch.full((4, 4), 0.5)}
    new, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert new["w"].data_ptr() == ptr
    assert not torch.equal(new["w"], torch.ones(4, 4))
    assert torch.equal(grads["w"], torch.full((4, 4), 0.5))
    assert not new["w"].requires_grad
