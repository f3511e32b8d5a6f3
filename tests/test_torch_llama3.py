"""The port's llama3-405b (the dense LM at rope theta 500000) against the
reference, on the CPU.

Both packages get the reference's ``init_lm`` params through numpy.  The
reduced config (2 layers, d_model 128) runs in float32; ``WIDE``
enlarges it so every leaf reaches 512 and packs.  The published config
is counted from shapes alone (the meta device; nothing allocated).
Tolerances: float32 logits and cache slabs within rtol = atol = 1e-4;
``slot_pos``, ``pos`` and the converted parameters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import install as ref_install
from repro.core import registry as ref_registry
from repro.core.plan import buckets_for, length_buckets_for
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import param_count as ref_param_count
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import install, registry
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import (active_param_count, build_model,
                                         param_count)
from repro_torch.serve.engine import Engine

ARCH = "llama3_405b"
WIDE = dict(d_model=512, num_heads=4, num_kv_heads=1, head_dim=128,
            d_ff=1024)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    """The port's plan, measurement and miss files (and the reference's
    plan file) in a temporary directory for the module."""
    d = tmp_path_factory.mktemp("port_cache")
    with pytest.MonkeyPatch.context() as mp:
        for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                          ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                          ("REPRO_TORCH_MISS_LOG", "misses.json"),
                          ("REPRO_PLAN_CACHE", "ref_plans.json")):
            mp.setenv(var, str(d / name))
        registry.clear_memory()
        ref_registry.clear_memory()
        yield
        registry.clear_memory()
        ref_registry.clear_memory()


def configs(wide=False):
    over = dict(WIDE if wide else {}, dtype="float32")
    ref_cfg = ref_reduced_config(ARCH).reduced(**over)
    cfg = get_reduced_config(ARCH).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.rope_theta == 500000.0
    return ref_cfg, cfg


def reference(wide=False):
    ref_cfg, cfg = configs(wide)
    rm = ref_build_model(ref_cfg)
    params, _ = rm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return ref_cfg, cfg, rm, params, tparams


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_config_equals_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref_get_config(ARCH))


def test_param_count_of_the_published_config_matches_reference():
    """405,853,388,800 parameters, counted from shapes alone: no leaf of
    the 126-layer tree is allocated."""
    want = ref_param_count(ref_build_model(ref_get_config(ARCH)))
    m = build_model(get_config(ARCH))
    assert param_count(m) == active_param_count(m) == want == 405853388800
    params, _ = m.init(MetaGenerator())
    assert all(t.device.type == "meta" for _, t in _leaves(params))


@pytest.mark.parametrize("wide", [False, True])
def test_params_from_numpy_bit_exact(wide):
    _, cfg, _, params, tparams = reference(wide)
    ours = dict(_leaves(build_model(cfg).init(MetaGenerator())[0]))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want) == sorted(ours)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape == tuple(ours[path].shape)
        assert np.array_equal(got[path].numpy().view(np.uint8),
                              w.view(np.uint8)), path


@pytest.mark.parametrize("wide", [False, True])
def test_prefill_and_decode_match_reference(wide):
    """Forward, then prefill + 3 greedy steps: logits and the K/V slabs
    (RoPE at theta 500000)."""
    _, cfg, rm, params, tparams = reference(wide)
    m = build_model(cfg)
    tokens = _tokens(cfg, (2, 12), 1)
    want, _ = rm.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, _ = m.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    cache, tcache = rm.init_cache(2, 24), m.init_cache(2, 24, "cpu")
    want, cache = rm.prefill(params, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)}, cache)
    got, tcache = m.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                            tcache)
    _close(got, want)
    for _ in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, cache = rm.decode_step(params, cache, jnp.asarray(tok))
        got, tcache = m.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(got, want)
    for k in ("k", "v"):
        _close(tcache[k], cache[k])
    for k in ("slot_pos", "pos"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(cache[k]))


def test_serving_shapes_and_problems_keep_the_reference():
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert install.serving_shapes(cfg) == ref_install.serving_shapes(ref_cfg)
    assert (16384, 53248) in install.serving_shapes(cfg)
    assert (53248, 16384) in install.serving_shapes(cfg)
    assert (16384, 128256) in install.serving_shapes(cfg)
    buckets, lengths = buckets_for(2), length_buckets_for(512)
    got = [p.key() for p in install.serving_problems(cfg, buckets, lengths)]
    want = [p.key() for p in ref_install.serving_problems(ref_cfg, buckets,
                                                          lengths)]
    assert got == want


def test_install_then_serve_matches_reference_with_no_miss():
    """``install --measure`` on the CPU, then a packed engine (every leaf
    packed; wk / wv (512, 128) too narrow, planned per call) serves one
    group of 2 x 16 tokens: 0 registry misses, tokens and last logits
    equal to the reference model's."""
    ref_cfg, cfg, rm, params, tparams = reference(wide=True)
    registry.clear_memory()
    install.install_arch(cfg, (1, 2), length_buckets_for(16), measure=True,
                         iters=1, device="cpu")
    registry.flush()
    registry.clear_memory()
    registry.reset_stats()
    axes = build_model(cfg).init(MetaGenerator())[1]
    eng = Engine(build_model(cfg), tparams, axes, max_len=32, max_batch=2,
                 max_prompt=16, device="cpu")
    assert not any(p.endswith(("/wk", "/wv")) for p in eng.pack_report)
    assert len(eng.pack_report) == 6
    eng.precompile()
    tokens = _tokens(cfg, (2, 16), 2)
    res = eng.generate({"tokens": torch.from_numpy(tokens)}, steps=3)
    stats = registry.stats()
    assert stats["misses"] == 0 and stats["hits"] > 0
    cache = rm.init_cache(2, 32)
    logits, cache = rm.prefill(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, cache)
    for i in range(3):
        want_tok = np.argmax(np.asarray(logits)[:, -1], -1)
        np.testing.assert_array_equal(res.tokens[:, i].numpy(), want_tok)
        logits, cache = rm.decode_step(
            params, cache, jnp.asarray(want_tok[:, None], jnp.int32))
    _close(res.logits_last, logits)
