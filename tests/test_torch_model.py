"""The port's dense LM against the reference on the reference's params.

The reference's ``init_lm`` params go into the port through
``params_from_numpy`` (bit-exact, bf16 included).  The config is the
reduced qwen1.5-4b enlarged so that every attention and MLP weight and
the head are >= 512 on both sides and pack.

Tolerances: float32 logits within 2e-4 (fp32 sums in another order
through 2 layers); bf16 logits within 6e-2 (bf16 rounding of every
activation, in different places in the two frameworks, on logits of
magnitude ~1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import registry as ref_registry
from repro.models import lm as ref_lm
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import pack_tree_for_serving as ref_pack_tree
from repro_torch.configs.base import get_reduced_config
from repro_torch.core import registry
from repro_torch.models import lm
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import pack_tree_for_serving


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    """The port's plan, measurement and miss files in a temporary
    directory (planning persists)."""
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))


WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4, head_dim=128)
TOL = {"float32": 2e-4, "bfloat16": 6e-2}


def configs(dtype):
    ref_cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE, dtype=dtype)
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE, dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


@pytest.fixture
def isolated_registries(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    ref_registry.clear_memory()
    registry.clear_memory()
    yield
    ref_registry.clear_memory()


def reference_params(ref_cfg):
    params, axes = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    return params, axes, jax.tree.map(np.asarray, params)


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=TOL[dtype], atol=TOL[dtype])


# GLM-4-9B's attention at full width (32 query heads on 2 KV heads of 128,
# QKV bias: wk/wv are (4096, 256)), one layer and a narrow MLP
GLM_ATTN = dict(d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
                d_ff=1024, num_layers=1, dtype="bfloat16")


def _converted_bit_exact(ref_cfg):
    """Every leaf of the reference's bf16 tree, carried across, keeps its
    shape and bits; returns the port's tree."""
    _, _, np_params = reference_params(ref_cfg)
    tp = params_from_numpy(np_params, "cpu")

    def check(t, a, path):
        if isinstance(a, dict):
            assert sorted(t) == sorted(a), path
            for k in a:
                check(t[k], a[k], path + (k,))
            return
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, path
        assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16)), \
            path

    check(tp, np_params, ())
    return tp


def test_params_from_numpy_is_bit_exact():
    ref_cfg, _ = configs("bfloat16")
    _converted_bit_exact(ref_cfg)


def test_params_from_numpy_covers_the_glm4_tree():
    attn = _converted_bit_exact(ref_reduced_config("glm4_9b").reduced(
        **GLM_ATTN))["layers"]["attn"]
    assert attn["wk"].shape == attn["wv"].shape == (1, 4096, 256)
    assert attn["bk"].shape == attn["bv"].shape == (1, 256)
    assert attn["bq"].shape == (1, 4096)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match(dtype):
    ref_cfg, cfg = configs(dtype)
    params, _, np_params = reference_params(ref_cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want, _, _ = ref_lm.lm_forward(params, ref_cfg,
                                   {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, _, _ = lm.lm_forward(params_from_numpy(np_params, "cpu"), cfg,
                              {"tokens": torch.from_numpy(tokens)})
    _close(got, want, dtype)


@pytest.mark.parametrize("packed", [False, True])
def test_prefill_and_decode_logits_match(packed, isolated_registries):
    dtype = "float32"
    ref_cfg, cfg = configs(dtype)
    params, axes, np_params = reference_params(ref_cfg)
    tparams = params_from_numpy(np_params, "cpu")
    if packed:
        params, ref_report = ref_pack_tree(params, axes, (1, 2))
        tparams, report = pack_tree_for_serving(tparams, axes, (1, 2))
        assert sorted(report) == sorted(ref_report) and len(report) == 8
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    pad = np.array([0, 3])
    feed = rng.integers(0, cfg.vocab_size, (3, 2, 1))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "pad": jnp.asarray(pad, jnp.int32)}
    want, cache = ref_lm.lm_prefill(params, ref_cfg, batch,
                                    ref_lm.init_cache(ref_cfg, 2, 24))
    tcache = lm.init_cache(cfg, 2, 24, "cpu")
    got, tcache = lm.lm_prefill(tparams, cfg,
                                {"tokens": torch.from_numpy(tokens),
                                 "pad": torch.from_numpy(pad)}, tcache)
    _close(got, want, dtype)
    for t in feed:
        want, cache = ref_lm.lm_decode_step(params, ref_cfg, cache,
                                            jnp.asarray(t, jnp.int32))
        got, tcache = lm.lm_decode_step(tparams, cfg, tcache,
                                        torch.from_numpy(t))
        _close(got, want, dtype)
    assert int(tcache["pos"]) == int(cache["pos"]) == 15


def test_bf16_prefill_logits_match(isolated_registries):
    dtype = "bfloat16"
    ref_cfg, cfg = configs(dtype)
    params, axes, np_params = reference_params(ref_cfg)
    params, _ = ref_pack_tree(params, axes, (1,))
    tparams, _ = pack_tree_for_serving(params_from_numpy(np_params, "cpu"),
                                       axes, (1,))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 16))
    want, _ = ref_lm.lm_prefill(params, ref_cfg,
                                {"tokens": jnp.asarray(tokens, jnp.int32)},
                                ref_lm.init_cache(ref_cfg, 1, 20))
    got, _ = lm.lm_prefill(tparams, cfg, {"tokens": torch.from_numpy(tokens)},
                           lm.init_cache(cfg, 1, 20, "cpu"))
    _close(got, want, dtype)


def test_prefill_row_matches_reference():
    """Ragged admission of one left-padded request into a live cache row."""
    ref_cfg, cfg = configs("float32")
    params, _, np_params = reference_params(ref_cfg)
    tparams = params_from_numpy(np_params, "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 8))
    pad = np.array([2])
    want, cache = ref_lm.lm_prefill_row(
        params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                          "pad": jnp.asarray(pad, jnp.int32)},
        ref_lm.init_cache(ref_cfg, 2, 24), 1, 10)
    got, tcache = lm.lm_prefill_row(
        tparams, cfg, {"tokens": torch.from_numpy(tokens),
                       "pad": torch.from_numpy(pad)},
        lm.init_cache(cfg, 2, 24, "cpu"), 1, 10)
    _close(got, want, "float32")
    np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                  np.asarray(cache["slot_pos"]))
    np.testing.assert_array_equal(tcache["valid_from"].numpy(),
                                  np.asarray(cache["valid_from"]))
    np.testing.assert_allclose(tcache["k"].numpy(), _np(cache["k"]),
                               rtol=2e-4, atol=2e-4)
