"""The port's hybrid (Zamba2-2.7B: Mamba2 groups and one shared attention
+ MLP block) against the reference, on the CPU.

Both packages get the reference's ``init_hybrid`` params through numpy
(the port reshapes the Mamba stack from the reference's (groups,
per_group, ...) to (num_layers, ...)).  The reduced config (4 Mamba
layers in 2 groups, d_model 128, 4 heads of 32) runs in float32; ``WIDE``
enlarges it so the Mamba leaves, the shared block's 2 x d_model-wide
projections and the head reach 512 and pack.  Tolerances: float32
logits and cache slabs within rtol = atol = 1e-4 (fp32 sums in another
order); ``slot_pos``, ``pos`` and the converted parameters exactly.
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
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import param_count as ref_param_count
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import install, registry
from repro_torch.core.packing import PackedTensor
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch.models import attention as A
from repro_torch.models import hybrid as HY
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import (active_param_count, build_model,
                                         param_count)
from repro_torch.serve.engine import Engine, iter_packable
from repro_torch.serve.programs import check_cells
from repro_torch.serve.scheduler import ContinuousScheduler

ARCH = "zamba2_2_7b"
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
    return ref_cfg, cfg


def reference(wide=False):
    ref_cfg, cfg = configs(wide)
    rm = ref_build_model(ref_cfg)
    params, axes = rm.init(jax.random.PRNGKey(0))
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


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_params_from_numpy_reshapes_the_mamba_stack_bit_exact():
    """Every leaf carried over bit for bit; the Mamba stack's (groups,
    per_group, ...) leaves become (num_layers, ...), the port's own
    layout (its init on the meta device gives the same shapes)."""
    ref_cfg, cfg, _, params, tparams = reference()
    ours = dict(_leaves(build_model(cfg).init(MetaGenerator())[0]))
    got = dict(_leaves(tparams))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert sorted(got) == sorted(want) == sorted(ours)
    for path, w in want.items():
        g = got[path].numpy()
        if path[0] == "mamba_layers":
            assert w.shape[:2] == (2, 2)
            w = w.reshape(-1, *w.shape[2:])
        assert g.shape == w.shape == tuple(ours[path].shape), path
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "olmoe_1b_7b"])
def test_params_from_numpy_keeps_the_lm_layouts(arch):
    """The dense and MoE trees keep their layout: no leaf is reshaped."""
    ref_cfg = ref_reduced_config(arch).reduced(dtype="float32")
    params, _ = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    want = dict(_leaves(tree))
    got = dict(_leaves(params_from_numpy(tree, "cpu")))
    for path, w in want.items():
        assert got[path].shape == w.shape
        assert np.array_equal(got[path].numpy(), w), path


def test_param_counts_match_reference():
    """The published Zamba2-2.7B, counted on the meta device."""
    want = ref_param_count(ref_build_model(ref_get_config(ARCH)))
    m = build_model(get_config(ARCH))
    assert param_count(m) == active_param_count(m) == want


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_reference():
    ref_cfg, cfg, rm, params, tparams = reference()
    tokens = _tokens(cfg, (2, 16))
    want, want_aux = rm.forward(params, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    got, aux = build_model(cfg).forward(tparams,
                                        {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


def test_init_cache_layout_matches():
    ref_cfg, cfg = configs()
    want = ref_build_model(ref_cfg).init_cache(2, 24)
    got = build_model(cfg).init_cache(2, 24, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def _same_cache(tcache, cache):
    for k in ("ssm", "conv", "k", "v"):
        _close(tcache[k], cache[k])
    for k in ("slot_pos", "pos"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(cache[k]))


def test_prefill_and_three_decode_steps_match_reference():
    """Prefill, then 3 greedy steps: logits and every cache entry (each
    layer's state, each application's K/V) against the reference; the
    port writes them into the cache's own tensors."""
    ref_cfg, cfg, rm, params, tparams = reference()
    m = build_model(cfg)
    tokens = _tokens(cfg, (2, 12), 1)
    cache, tcache = rm.init_cache(2, 24), m.init_cache(2, 24, "cpu")
    held = dict(tcache)
    want, cache = rm.prefill(params, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)}, cache)
    got, tcache = m.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                            tcache)
    _close(got, want)
    _same_cache(tcache, cache)
    for _ in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, cache = rm.decode_step(params, cache, jnp.asarray(tok))
        got, tcache = m.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(got, want)
        _same_cache(tcache, cache)
    assert all(tcache[k] is held[k] for k in held)


def test_shared_block_reads_x_and_x0():
    """The shared block's input is [x, x0] (2 x d_model): the MLP's
    w_gate and the attention's wq are (2d, .)."""
    _, cfg = configs()
    params, _ = build_model(cfg).init(MetaGenerator())
    d2 = 2 * cfg.d_model
    sh = params["shared"]
    assert sh["attn"]["wq"].shape[0] == sh["mlp"]["w_gate"].shape[0] == d2
    assert sh["mlp"]["w_down"].shape[1] == sh["attn"]["wo"].shape[1] \
        == cfg.d_model
    assert params["mamba_layers"]["mamba"]["w_in"].shape[0] == cfg.num_layers


# ---------------------------------------------------------------------------
# flash at the shared block's head dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_d80_matches_pallas_interpret(causal):
    """The plain version the CUDA kernel is held to on the card, against
    the reference's Pallas kernel in interpret mode, at D = 80."""
    b, h, s, d = 1, 2, 64, 80
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, bq=16, bkv=16, interpret=True)
    got = flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v)), causal=causal)
    _close(got.transpose(1, 2), want)


def test_flash_gate_takes_d80(monkeypatch):
    """Zamba2's shared block (head dim 80) passes the flash gate on the
    card at a multiple of 256 tokens."""
    assert 80 in HEAD_DIMS
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q = torch.zeros((1, 256, 4, 80))
    assert A.flash_eligible(q, q, q, window=0, q_offset=0, k_offset=0,
                            valid_from=None)


# ---------------------------------------------------------------------------
# serving: shapes, packing, refusal, the engine and the store
# ---------------------------------------------------------------------------


def test_serving_shapes_add_the_shared_blocks_projections():
    """The reference's shapes stay (their plan keys do not move); the
    shared block's (2d, H*hd) = (2d, KH*hd) and (2d, d_ff) are added.  At
    the published widths (2d, H*hd) = (5120, 2560) is also the Mamba
    ``w_out``'s (d_inner, d), which the reference has: one shape is new."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    got, want = install.serving_shapes(cfg), ref_install.serving_shapes(ref_cfg)
    assert want <= got
    assert {(5120, 2560), (5120, 10240)} <= got
    assert got - want == {(5120, 10240)}


@pytest.mark.parametrize("wide", [False, True])
def test_serving_shapes_cover_every_packable_leaf(wide):
    _, cfg = configs(wide)
    params, axes = build_model(cfg).init(MetaGenerator())
    leaves = list(iter_packable(params, axes))
    assert bool(leaves) == wide
    for path, leaf, _ in leaves:
        assert tuple(leaf.shape[-2:]) in install.serving_shapes(cfg), path


def _engine(wide=False, **kw):
    _, cfg, _, _, tparams = reference(wide)
    axes = build_model(cfg).init(MetaGenerator())[1]
    return Engine(build_model(cfg), tparams, axes, max_len=48, max_batch=2,
                  max_prompt=16, device="cpu", **kw), cfg


def test_every_leaf_packs_at_load():
    """The Mamba stack (3-D on the layers axis; w_in zero-padded to whole
    blocks), the shared block and the head are PackedTensors after load."""
    eng, _ = _engine(wide=True)
    mamba = eng.params["mamba_layers"]["mamba"]
    assert all(isinstance(mamba[k], PackedTensor) for k in ("w_in", "w_out"))
    assert mamba["w_in"].lead_shape == (4,)
    shared = eng.params["shared"]
    assert all(isinstance(shared[b][w], PackedTensor)
               for b, ws in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down")))
               for w in ws)
    assert len(eng.pack_report) == 10


def test_engine_matches_the_reference_model():
    """A packed engine's group (prefill + 3 steps, through its cells)
    against the reference model fed the same tokens."""
    registry.clear_memory()
    ref_cfg, cfg, rm, params, _ = reference(wide=True)
    eng, _ = _engine(wide=True)
    tokens = _tokens(cfg, (2, 16), 2)
    res = eng.generate({"tokens": torch.from_numpy(tokens)}, steps=3)
    cache = rm.init_cache(2, 48)
    logits, cache = rm.prefill(params, {"tokens": jnp.asarray(tokens,
                                                              jnp.int32)}, cache)
    for i in range(3):
        want_tok = np.argmax(np.asarray(logits)[:, -1], -1)
        np.testing.assert_array_equal(res.tokens[:, i].numpy(), want_tok)
        if i < 2:
            logits, cache = rm.decode_step(
                params, cache, jnp.asarray(want_tok[:, None], jnp.int32))
    logits, _ = rm.decode_step(params, cache, jnp.asarray(
        res.tokens[:, 2:].numpy(), jnp.int32))
    _close(res.logits_last, logits)


def test_install_then_serve_makes_no_miss():
    """With the shared block's shapes in the sweep, the engine's load,
    prefill and decode are registry lookups only (the reference's sweep
    would miss its (2d, .) projections)."""
    _, cfg = configs(wide=True)
    registry.clear_memory()
    install.install_arch(cfg, (1, 2), (8, 16), device="cpu")
    registry.flush()
    registry.clear_memory()
    registry.reset_stats()
    eng, _ = _engine(wide=True)
    eng.precompile()
    eng.generate({"tokens": torch.arange(32).reshape(2, 16) % 512}, steps=2)
    stats = registry.stats()
    assert stats["misses"] == 0 and stats["hits"] > 0


def test_ragged_refusal():
    eng, _ = _engine()
    assert eng.model.prefill_row is None and not eng.ragged_supported()
    with pytest.raises(ValueError, match=r"ragged prompt lengths \[5, 9\] "
                       r"need an attention-cache LM \(family=hybrid\)"):
        eng.serve([{"tokens": torch.arange(n, dtype=torch.int32)}
                   for n in (5, 9)], steps=2)
    with pytest.raises(ValueError, match="continuous batching needs an "
                       "attention-cache LM"):
        ContinuousScheduler(eng)


def test_check_cells_restores_the_recurrent_state():
    eng, _ = _engine()
    rows = eng.precompile()
    assert {r["kind"] for r in rows} == {"prefill", "decode"}
    cache = eng.programs.static_cache(2, eng.max_len)
    with torch.inference_mode():
        cache["ssm"].normal_()
        cache["conv"].normal_()
    out = check_cells(eng.programs)
    assert len(out) == len(rows) and all(c["equal"] for c in out)


def test_cache_slabs_cover_each_layer_and_application():
    _, cfg = configs()
    cache = HY.hybrid_init_cache(cfg, 2, 24, "cpu")
    slabs = HY.cache_slabs(cfg, cache)
    ng = cfg.num_layers // cfg.attn_every
    assert len(slabs) == cfg.num_layers + ng
    slabs[-1][0].fill_(1.0)
    slabs[0][0].fill_(2.0)
    assert float(cache["k"][ng - 1].min()) == 1.0
    assert float(cache["ssm"][0, 0].min()) == 2.0
