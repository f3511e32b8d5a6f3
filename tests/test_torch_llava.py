"""The port's VLM backbone (LLaVA-NeXT Mistral-7B: the dense block fed
image embeddings before the tokens) against the reference, on the CPU.

Both packages get the reference's ``init_lm`` params through numpy.  The
reduced config (8 image tokens, 2 layers, d_model 128) runs in float32;
``WIDE`` enlarges it so every leaf reaches 512 and packs.  The batch is
the reference test's ``make_batch`` layout (``tests/test_smoke_archs.py``)
with seeded embeddings.  Tolerances: float32 logits and cache slabs
within rtol = atol = 1e-4; ``slot_pos``, ``pos`` and the converted
parameters exactly.
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
from repro_torch.core.plan import Problem
from repro_torch.launch.serve import make_group
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import build_model, param_count
from repro_torch.serve.engine import Engine
from repro_torch.serve.programs import batch_template

ARCH = "llava_next_mistral_7b"
WIDE = dict(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
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
    assert cfg.embeds_input and cfg.num_image_tokens == 8
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


def make_batch(cfg, b, s, seed=0):
    """``s`` positions: ``num_image_tokens`` seeded embeddings (fp32
    values on the bf16 grid, so both packages read the same numbers),
    then ``s - num_image_tokens`` tokens."""
    rng = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens
    toks = rng.integers(0, cfg.vocab_size, (b, s - n_img)).astype(np.int32)
    emb = torch.from_numpy(rng.standard_normal(
        (b, n_img, cfg.d_model)).astype(np.float32))
    emb = emb.to(torch.bfloat16).float().numpy()
    return ({"tokens": jnp.asarray(toks), "embeds": jnp.asarray(emb)},
            {"tokens": torch.from_numpy(toks),
             "embeds": torch.from_numpy(emb)})


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _same_cache(tcache, cache):
    for k in ("k", "v"):
        _close(tcache[k], cache[k])
    for k in ("slot_pos", "pos", "valid_from"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(cache[k]))


def test_params_from_numpy_bit_exact():
    _, cfg, _, params, tparams = reference()
    ours = dict(_leaves(build_model(cfg).init(MetaGenerator())[0]))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want) == sorted(ours)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape == tuple(ours[path].shape)
        assert np.array_equal(got[path].numpy().view(np.uint8),
                              w.view(np.uint8)), path


def test_param_count_matches_reference():
    want = ref_param_count(ref_build_model(ref_get_config(ARCH)))
    assert param_count(build_model(get_config(ARCH))) == want


def test_forward_puts_the_image_embeddings_first():
    _, cfg, rm, params, tparams = reference()
    jb, tb = make_batch(cfg, 2, 32)
    want, _ = rm.forward(params, jb)
    got, _ = build_model(cfg).forward(tparams, tb)
    assert got.shape == (2, 32, cfg.vocab_size)
    _close(got, want)


def test_prefill_with_embeds_then_decode_matches_reference():
    """The prefill counts the image positions (``pos`` = 8 + tokens),
    fills their K/V slots, then 3 greedy steps."""
    _, cfg, rm, params, tparams = reference()
    m = build_model(cfg)
    jb, tb = make_batch(cfg, 2, 24, 1)
    cache, tcache = rm.init_cache(2, 40), m.init_cache(2, 40, "cpu")
    want, cache = rm.prefill(params, jb, cache)
    got, tcache = m.prefill(tparams, tb, tcache)
    _close(got, want)
    _same_cache(tcache, cache)
    assert int(tcache["pos"]) == 24
    for _ in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, cache = rm.decode_step(params, cache, jnp.asarray(tok))
        got, tcache = m.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(got, want)
        _same_cache(tcache, cache)


def test_batch_template_and_group_carry_the_embeddings():
    _, cfg = configs()
    t = batch_template(2, 16, pad=False, cfg=cfg)
    assert t["embeds"].shape == (2, 8, cfg.d_model)
    assert t["embeds"].dtype == torch.bfloat16
    g = make_group(cfg, 2, 16, "cpu")
    assert g["embeds"].shape == t["embeds"].shape and not g["embeds"].any()
    assert make_group(cfg, 2, 16, "cpu", seed=1)["embeds"].any()


def test_serving_problems_plan_the_image_rows():
    """Every reference problem, plus the rows the prefill really runs:
    bucket x (num_image_tokens + prompt) (a superset of the reference's)."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert install.serving_shapes(cfg) == ref_install.serving_shapes(ref_cfg)
    _, wcfg = configs(wide=True)
    ref_wcfg = ref_reduced_config(ARCH).reduced(**WIDE, dtype="float32")
    buckets, lengths = buckets_for(2), length_buckets_for(16)
    got = {p.key() for p in install.serving_problems(wcfg, buckets, lengths)}
    want = {p.key() for p in ref_install.serving_problems(ref_wcfg, buckets,
                                                          lengths)}
    assert want < got
    rows = install.prefill_rows(wcfg, buckets, lengths)
    assert rows == sorted({bb * (8 + lb) for bb in buckets for lb in lengths})
    assert {Problem.from_key(k).m for k in got - want} <= set(rows)


def test_ragged_admission_is_refused():
    eng = _engine()
    assert eng.model.prefill_row is not None and not eng.ragged_supported()
    with pytest.raises(ValueError, match=r"ragged prompt lengths \[5, 9\] "
                       r"need an attention-cache LM \(family=vlm\)"):
        eng.serve([{"tokens": torch.arange(n, dtype=torch.int32),
                    "embeds": torch.zeros((8, eng.model.cfg.d_model))}
                   for n in (5, 9)], steps=2)


def _engine(wide=False):
    _, cfg, _, _, tparams = reference(wide)
    axes = build_model(cfg).init(MetaGenerator())[1]
    return Engine(build_model(cfg), tparams, axes, max_len=40, max_batch=2,
                  max_prompt=16, device="cpu")


def test_install_then_serve_matches_reference_with_no_miss():
    """``install --measure`` on the CPU, then a packed engine serves one
    group (8 image embeddings + 16 tokens each) through its eager cells,
    its prefill cell holding the embeddings' buffer: 0 registry misses,
    0 cells acquired by traffic, tokens and logits equal to the
    reference model's."""
    ref_cfg, cfg, rm, params, _ = reference(wide=True)
    registry.clear_memory()
    install.install_arch(cfg, (1, 2), length_buckets_for(16), measure=True,
                         iters=1, device="cpu")
    registry.flush()
    registry.clear_memory()
    registry.reset_stats()
    eng = _engine(wide=True)
    assert len(eng.pack_report) == 8
    rows = eng.precompile()
    loaded = eng.programs.stats()
    jb, tb = make_batch(cfg, 2, 24, 2)
    res = eng.generate(tb, steps=3)
    stats, st = registry.stats(), eng.programs.stats()
    assert stats["misses"] == 0 and stats["hits"] > 0
    assert st["eager"] == loaded["eager"] == len(rows)
    cache = rm.init_cache(2, 40)
    logits, cache = rm.prefill(params, jb, cache)
    for i in range(3):
        want_tok = np.argmax(np.asarray(logits)[:, -1], -1)
        np.testing.assert_array_equal(res.tokens[:, i].numpy(), want_tok)
        logits, cache = rm.decode_step(
            params, cache, jnp.asarray(want_tok[:, None], jnp.int32))
    _close(res.logits_last, logits)
