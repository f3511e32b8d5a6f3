"""The GLM-4-9B slice: prefill through the tall-A path, then decode.

A GLM-shaped config (the reference's ``glm4_9b`` reduced to d_model 1024,
8 query heads on 2 KV heads of 128, d_ff 2048, 2 layers, float32), so
that ``wk``/``wv`` are (1024, 256): unpacked (narrower than the packing
floor of 512 columns) and, at a prefill of 2 x 1024 tokens (m = 2048),
tall-A TSMMs with their QKV bias fused.  Both packages see the
reference's parameters, packed for serving as the engines pack them,
and run prefill and 4 decode steps under ``serving_ctx``.

Tolerance: max |delta| of the last logits <= 1e-3 * max |logit| (fp32
sums in another order through 2 layers and the head).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import glm4_9b as ref_glm4
from repro.core import registry as ref_registry
from repro.core.linear import serving_ctx as ref_serving_ctx
from repro.models import lm as ref_lm
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import pack_tree_for_serving as ref_pack_tree
from repro_torch.configs import glm4_9b
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import registry
from repro_torch.core.linear import serving_ctx
from repro_torch.core.plan import Problem
from repro_torch.kernels import variants
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


GLM = dict(d_model=1024, num_heads=8, num_kv_heads=2, head_dim=128,
           d_ff=2048, dtype="float32")
BATCH, PROMPT, STEPS = 2, 1024, 4


def test_config_is_the_reference_config():
    for port, ref in ((get_config("glm4_9b"), ref_glm4.CONFIG),
                      (get_reduced_config("glm4_9b"), ref_glm4.REDUCED),
                      (glm4_9b.CONFIG.reduced(**GLM),
                       ref_glm4.CONFIG.reduced(**GLM))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = get_config("glm4_9b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias) == (
        40, 4096, 32, 2, 128, 13696, 151552, True)


@pytest.fixture
def isolated_registries(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    ref_registry.clear_memory()
    registry.clear_memory()
    yield
    ref_registry.clear_memory()


def test_glm4_prefill_tall_path_and_decode_match_reference(
        isolated_registries, monkeypatch):
    ref_cfg = ref_glm4.CONFIG.reduced(**GLM)
    cfg = glm4_9b.CONFIG.reduced(**GLM)
    params, axes = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    attn = tparams["layers"]["attn"]
    assert attn["wk"].shape == attn["wv"].shape == (2, 1024, 256)
    assert attn["bk"].shape == (2, 256) and attn["bq"].shape == (2, 1024)
    params, ref_report = ref_pack_tree(params, axes, (BATCH,))
    tparams, report = pack_tree_for_serving(tparams, axes, (BATCH,))
    assert sorted(report) == sorted(ref_report)
    assert not any(p.endswith(("/wk", "/wv")) for p in report)

    calls = []
    run_tall_a = variants.run_tall_a

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return run_tall_a(*args, **kw)

    monkeypatch.setattr(variants, "run_tall_a", spy)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
    feed = rng.integers(0, cfg.vocab_size, (STEPS, BATCH, 1))
    max_len = PROMPT + STEPS

    wants, gots = [], []
    with ref_serving_ctx():
        want, cache = ref_lm.lm_prefill(
            params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32)},
            ref_lm.init_cache(ref_cfg, BATCH, max_len))
        wants.append(want)
        for t in feed:
            want, cache = ref_lm.lm_decode_step(params, ref_cfg, cache,
                                                jnp.asarray(t, jnp.int32))
            wants.append(want)
    with torch.inference_mode(), serving_ctx():
        got, tcache = lm.lm_prefill(tparams, cfg,
                                    {"tokens": torch.from_numpy(tokens)},
                                    lm.init_cache(cfg, BATCH, max_len, "cpu"))
        gots.append(got)
        prefill_calls = list(calls)
        for t in feed:
            got, tcache = lm.lm_decode_step(tparams, cfg, tcache,
                                            torch.from_numpy(t))
            gots.append(got)

    # wk and wv of both layers went down the tall branch at prefill only
    assert prefill_calls == [(1024, 256)] * 4 and calls == prefill_calls
    plan = registry.peek(Problem(BATCH * PROMPT, 1024, 256, "float32").key(),
                         "cpu")
    assert plan is not None and plan.orientation == "tall_a"
    for got, want in zip(gots, wants):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max(), err
