"""The port's sliding-window LM (h2o-danube-1.8b) against the reference,
on the CPU.

Both packages get the reference's ``init_lm`` params through numpy.  The
reduced config (window 16, 2 layers, d_model 128) runs in float32;
``WIDE`` enlarges it so every leaf reaches 512 and packs.  Tolerances:
float32 logits and cache slabs within rtol = atol = 1e-4 (fp32 sums in
another order); ``slot_pos``, ``pos`` and the converted parameters
exactly.
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
from repro_torch.core.packing import PackedTensor
from repro_torch.models import lm as LM
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import build_model, param_count
from repro_torch.serve.engine import Engine, iter_packable
from repro_torch.serve.scheduler import ContinuousScheduler

ARCH = "h2o_danube_1_8b"
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
    assert cfg.sliding_window == 16
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


def _same_cache(tcache, cache):
    for k in ("k", "v"):
        _close(tcache[k], cache[k])
    for k in ("slot_pos", "pos", "valid_from"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(cache[k]))


# ---------------------------------------------------------------------------
# parameters and the cache layout
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("max_len", [12, 40])
def test_init_cache_holds_min_of_max_len_and_window(max_len):
    ref_cfg, cfg = configs()
    want = ref_build_model(ref_cfg).init_cache(2, max_len)
    got = build_model(cfg).init_cache(2, max_len, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert got["slot_pos"].shape == (min(max_len, 16),)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_reference():
    """The windowed mask in the chunked prefill body."""
    _, cfg, rm, params, tparams = reference()
    tokens = _tokens(cfg, (2, 40))
    want, _ = rm.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, _ = build_model(cfg).forward(tparams,
                                      {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_reference_24_token_case_decodes_past_the_window():
    """The reference's own case: a 16-token prefill into a 16-slot cache,
    then tokens 16..23 decoded one at a time, slot ``pos % 16`` wrapping
    to 0 at position 16: every step's logits and the rolled cache."""
    _, cfg, rm, params, tparams = reference()
    m = build_model(cfg)
    toks = ((np.arange(24) * 7) % cfg.vocab_size).reshape(1, 24)
    cache, tcache = rm.init_cache(1, 16), m.init_cache(1, 16, "cpu")
    held = dict(tcache)
    want, cache = rm.prefill(params, {"tokens": jnp.asarray(toks[:, :16],
                                                            jnp.int32)}, cache)
    got, tcache = m.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :16])}, tcache)
    _close(got, want)
    _same_cache(tcache, cache)
    for t in range(16, 24):
        tok = toks[:, t:t + 1].astype(np.int32)
        want, cache = rm.decode_step(params, cache, jnp.asarray(tok))
        got, tcache = m.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(got, want)
        _same_cache(tcache, cache)
    assert int(tcache["slot_pos"][0]) == 16
    assert all(tcache[k] is held[k] for k in held)
    full, _ = m.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prompt", [24, 37])
def test_rolled_prefill_matches_reference(prompt):
    """A prompt longer than the window: the last 16 positions scattered
    into slot p % 16 IN PLACE, the slabs and ``slot_pos`` equal to the
    reference's rolled copy; then 3 decode steps."""
    _, cfg, rm, params, tparams = reference()
    m = build_model(cfg)
    tokens = _tokens(cfg, (2, prompt), 3)
    cache, tcache = rm.init_cache(2, 64), m.init_cache(2, 64, "cpu")
    held = dict(tcache)
    want, cache = rm.prefill(params, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)}, cache)
    got, tcache = m.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                            tcache)
    _close(got, want)
    _same_cache(tcache, cache)
    sp = tcache["slot_pos"].numpy()
    assert sorted(sp) == list(range(prompt - 16, prompt))
    assert all(p % 16 == j for j, p in enumerate(sp))
    for _ in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, cache = rm.decode_step(params, cache, jnp.asarray(tok))
        got, tcache = m.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(got, want)
        _same_cache(tcache, cache)
    assert all(tcache[k] is held[k] for k in held)


def test_decode_slot_is_computed_on_the_device():
    """The decode step reads the position from the cache tensor only: a
    position set past the wrap writes slot pos % slots."""
    _, cfg, _, _, tparams = reference()
    m = build_model(cfg)
    cache = m.init_cache(1, 16, "cpu")
    with torch.inference_mode():
        cache["pos"].fill_(35)
        m.decode_step(tparams, cache, torch.zeros((1, 1), dtype=torch.int32))
    assert int(cache["slot_pos"][35 % 16]) == 35
    assert int(cache["pos"]) == 36


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_ragged_admission_is_refused():
    _, cfg, _, _, tparams = reference()
    m = build_model(cfg)
    assert m.prefill_row is None
    with pytest.raises(NotImplementedError, match="sliding-window"):
        LM.lm_prefill_row(tparams, cfg, {"tokens": torch.zeros(
            (1, 8), dtype=torch.int32)}, m.init_cache(1, 16, "cpu"), 0, 8)
    eng = _engine()
    assert not eng.ragged_supported()
    with pytest.raises(ValueError, match=r"ragged prompt lengths \[5, 9\] "
                       r"need an attention-cache LM \(family=dense\)"):
        eng.serve([{"tokens": torch.arange(n, dtype=torch.int32)}
                   for n in (5, 9)], steps=2)
    with pytest.raises(ValueError, match="continuous batching needs an "
                       "attention-cache LM"):
        ContinuousScheduler(eng)


def test_serving_shapes_and_problems_keep_the_reference():
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert install.serving_shapes(cfg) == ref_install.serving_shapes(ref_cfg)
    buckets, lengths = buckets_for(2), length_buckets_for(4352)
    got = [p.key() for p in install.serving_problems(cfg, buckets, lengths)]
    want = [p.key() for p in ref_install.serving_problems(ref_cfg, buckets,
                                                          lengths)]
    assert got == want
    assert install.prefill_rows(cfg, buckets, lengths) == []


def _engine(wide=False, max_len=48):
    _, cfg, _, _, tparams = reference(wide)
    axes = build_model(cfg).init(MetaGenerator())[1]
    return Engine(build_model(cfg), tparams, axes, max_len=max_len,
                  max_batch=2, max_prompt=32, device="cpu")


def test_install_then_serve_matches_reference_with_no_miss():
    """``install --measure`` on the CPU, then a packed engine serves one
    group of 2 x 32 tokens (rolled past the window) through its eager
    cells: 0 registry misses, every leaf packed, tokens and last logits
    equal to the reference model fed the same tokens."""
    ref_cfg, cfg, rm, params, _ = reference(wide=True)
    registry.clear_memory()
    install.install_arch(cfg, (1, 2), length_buckets_for(32), measure=True,
                         iters=1, device="cpu")
    registry.flush()
    registry.clear_memory()
    registry.reset_stats()
    eng = _engine(wide=True)
    assert all(isinstance(leaf, PackedTensor) for _, leaf, _ in
               iter_packable(eng.params, build_model(cfg).init(
                   MetaGenerator())[1]))
    eng.precompile()
    tokens = _tokens(cfg, (2, 32), 4)
    res = eng.generate({"tokens": torch.from_numpy(tokens)}, steps=3)
    stats = registry.stats()
    assert stats["misses"] == 0 and stats["hits"] > 0
    cache = rm.init_cache(2, 48)
    logits, cache = rm.prefill(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, cache)
    for i in range(3):
        want_tok = np.argmax(np.asarray(logits)[:, -1], -1)
        np.testing.assert_array_equal(res.tokens[:, i].numpy(), want_tok)
        logits, cache = rm.decode_step(
            params, cache, jnp.asarray(want_tok[:, None], jnp.int32))
    # the engine's last logits are those of the step fed token 2
    _close(res.logits_last, logits)
