"""The port's MoE family as a whole against the reference, on the CPU.

OLMoE-1B-7B (64 routed experts, MHA) and DeepSeek-V2 (MLA, 2 shared +
160 routed experts, one leading dense layer), reduced; both packages
get the reference's ``init_lm`` params through numpy.  The reduced MoE
configs are drop-free (capacity factor 8).  ``WIDE`` enlarges each so
every attention projection, the dense layer's MLP and the head are
>= 512 on both sides and pack (the expert stacks never pack).

Tolerances: float32 logits, cache slabs and aux within
rtol = atol = 1e-4 (fp32 sums in another order through 2 layers and the
absorbed MLA decode); ``valid_from``, ``slot_pos`` and every token
exactly.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import install as ref_install
from repro.core import registry as ref_registry
from repro.models import lm as ref_lm
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import param_count as ref_param_count
from repro.models.registry import \
    active_param_count as ref_active_param_count
from repro.serve.engine import pack_tree_for_serving as ref_pack_tree
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import install, registry
from repro_torch.core.linear import serving_ctx
from repro_torch.core.plan import buckets_for, length_buckets_for
from repro_torch.models import lm
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import (active_param_count, build_model,
                                         param_count)
from repro_torch.serve.engine import (Engine, iter_packable,
                                      pack_tree_for_serving)
from repro_torch.serve.programs import (ProgramStore, check_cells,
                                        precompile_grid)
from repro_torch.serve.scheduler import Request

ARCHS = ("olmoe_1b_7b", "deepseek_v2_236b")
WIDE = {
    "olmoe_1b_7b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                        head_dim=128, d_ff=1024),
    "deepseek_v2_236b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                             head_dim=128, v_head_dim=128, rope_head_dim=64,
                             q_lora_rank=512, kv_lora_rank=512, d_ff=1024),
}
TOL = 1e-4
REPO = Path(__file__).resolve().parents[1]


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


def configs(arch, wide=False, dtype="float32"):
    over = dict(WIDE[arch] if wide else {}, dtype=dtype)
    ref_cfg = ref_reduced_config(arch).reduced(**over)
    cfg = get_reduced_config(arch).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def reference(arch, wide=False):
    ref_cfg, cfg = configs(arch, wide)
    params, axes = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return ref_cfg, cfg, params, axes, tparams


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _slab_names(cfg):
    a, b = ("c", "kr") if cfg.use_mla else ("k", "v")
    return [a, b] + [f"dense{i}_{n}" for i in range(cfg.first_k_dense)
                     for n in (a, b)]


def _same_cache(tcache, cache, cfg):
    assert sorted(tcache) == sorted(cache)
    for name in _slab_names(cfg):
        _close(tcache[name], cache[name])
    for name in ("valid_from", "slot_pos", "pos"):
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(cache[name]))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch):
    ref_cfg, cfg, params, _, tparams = reference(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want, want_aux, _ = ref_lm.lm_forward(
        params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, aux, _ = lm.lm_forward(tparams, cfg,
                                {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_matches(arch):
    ref_cfg, cfg = configs(arch)
    want = ref_lm.init_cache(ref_cfg, 2, 24)
    got = lm.init_cache(cfg, 2, 24, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, packed):
    """A left-padded prefill and 4 decode steps; packed: the enlarged
    config's packed weights in both packages, the port under
    ``serving_ctx``."""
    ref_cfg, cfg, params, axes, tparams = reference(arch, wide=packed)
    if packed:
        params, ref_report = ref_pack_tree(params, axes, (1, 2))
        tparams, report = pack_tree_for_serving(tparams, axes, (1, 2))
        assert sorted(report) == sorted(ref_report) and report
        if cfg.use_mla:
            assert {"dense0/mlp/w_gate", "layers/attn/wkv_b",
                    "layers/attn/wq_b"} <= set(report)
        assert not any("experts" in p or p.endswith(("ws_gate", "router"))
                       for p in report)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    pad = np.array([0, 3])
    feed = rng.integers(0, cfg.vocab_size, (4, 2, 1))
    want, cache = ref_lm.lm_prefill(
        params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                          "pad": jnp.asarray(pad, jnp.int32)},
        ref_lm.init_cache(ref_cfg, 2, 24))
    with serving_ctx():
        got, tcache = lm.lm_prefill(tparams, cfg,
                                    {"tokens": torch.from_numpy(tokens),
                                     "pad": torch.from_numpy(pad)},
                                    lm.init_cache(cfg, 2, 24, "cpu"))
        _close(got, want)
        for t in feed:
            want, cache = ref_lm.lm_decode_step(params, ref_cfg, cache,
                                                jnp.asarray(t, jnp.int32))
            got, tcache = lm.lm_decode_step(tparams, cfg, tcache,
                                            torch.from_numpy(t))
            _close(got, want)
    _same_cache(tcache, cache, cfg)
    assert int(tcache["pos"]) == 16


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_row_matches(arch, packed):
    """Ragged admission of one left-padded request into row 1 of a live
    cache at [2, 10), with 0-d tensor arguments (the captured cell's)."""
    ref_cfg, cfg, params, axes, tparams = reference(arch, wide=packed)
    if packed:
        params, _ = ref_pack_tree(params, axes, (1, 2))
        tparams, _ = pack_tree_for_serving(tparams, axes, (1, 2))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 8))
    pad = np.array([2])
    want, cache = ref_lm.lm_prefill_row(
        params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                          "pad": jnp.asarray(pad, jnp.int32)},
        ref_lm.init_cache(ref_cfg, 2, 24), 1, 10)
    i32 = torch.int32
    with serving_ctx():
        got, tcache = lm.lm_prefill_row(
            tparams, cfg, {"tokens": torch.from_numpy(tokens),
                           "pad": torch.from_numpy(pad).to(i32)},
            lm.init_cache(cfg, 2, 24, "cpu"), torch.tensor(1, dtype=i32),
            torch.tensor(10, dtype=i32))
    _close(got, want)
    _same_cache(tcache, cache, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for ref_cfg, cfg in ((ref_get_config(arch), get_config(arch)),
                         configs(arch)):
        model, ref_model = build_model(cfg), ref_build_model(ref_cfg)
        assert param_count(model) == ref_param_count(ref_model)
        assert active_param_count(model) == ref_active_param_count(ref_model)
        assert active_param_count(model) < param_count(model)


def test_counts_allocate_nothing():
    params, _ = build_model(get_config("deepseek_v2_236b")).init(
        MetaGenerator())
    assert params["layers"]["mlp"]["w_gate"].device.type == "meta"
    assert params["layers"]["mlp"]["w_gate"].shape == (59, 160, 5120, 1536)


# ---------------------------------------------------------------------------
# the install stage's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("arch", ["qwen1_5_4b", "glm4_9b", *ARCHS])
def test_serving_shapes_cover_every_packable_leaf(arch, wide):
    """Every leaf ``iter_packable`` yields has its (k, n) among
    ``serving_shapes``, so an install sweep plans every packed leaf."""
    cfg = get_reduced_config(arch)
    if wide:
        cfg = cfg.reduced(**WIDE.get(arch, WIDE["olmoe_1b_7b"]))
    params, axes = build_model(cfg).init(MetaGenerator())
    leaves = list(iter_packable(params, axes))
    shapes = install.serving_shapes(cfg)
    assert bool(leaves) == wide
    for path, leaf, _ in leaves:
        assert tuple(leaf.shape[-2:]) in shapes, path


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_shapes_keep_every_reference_shape(arch):
    """The reference's shapes stay (their plan keys do not move);
    DeepSeek-V2 adds MLA's wq_b, wkv_a and wo, which the reference's copy
    leaves out."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    got, want = install.serving_shapes(cfg), ref_install.serving_shapes(ref_cfg)
    assert want <= got
    extra = {(1536, 128 * 192), (5120, 512 + 64), (128 * 128, 5120)}
    assert got - want == (extra - want if cfg.use_mla else set())
    buckets, lengths = buckets_for(4), length_buckets_for(256)
    ref_keys = {p.key() for p in ref_install.serving_problems(
        ref_cfg, buckets, lengths)}
    keys = {p.key() for p in install.serving_problems(cfg, buckets, lengths)}
    assert ref_keys <= keys


def test_install_then_serve_deepseek_makes_no_miss():
    """install -> serve on the enlarged DeepSeek-V2: the engine's load,
    prefill and decode are registry lookups only.  ``wkv_a`` (512, 576)
    has no conforming pack layout and stays unpacked, so every decode
    step looks its problem up: a shape the reference's sweep misses."""
    _, cfg = configs("deepseek_v2_236b", wide=True)
    registry.clear_memory()
    install.install_arch(cfg, (1, 2), (8, 16), device="cpu")
    registry.flush()
    registry.clear_memory()
    registry.reset_stats()
    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, axes, max_len=40, max_batch=2, max_prompt=16,
                 device="cpu")
    assert {"layers/attn/wq_b", "layers/attn/wo", "dense0/attn/wq_b"} <= set(
        eng.pack_report)
    assert "layers/attn/wkv_a" not in eng.pack_report
    assert (512, 576) not in ref_install.serving_shapes(
        ref_reduced_config("deepseek_v2_236b").reduced(
            **WIDE["deepseek_v2_236b"]))
    eng.generate({"tokens": torch.arange(32).reshape(2, 16) % 512}, steps=2)
    stats = registry.stats()
    assert stats["misses"] == 0 and stats["hits"] > 0


# ---------------------------------------------------------------------------
# the engine, the store and the queue
# ---------------------------------------------------------------------------


def _engine(arch, *, max_len=64, max_batch=2, wide=False):
    _, cfg, _, axes, tparams = reference(arch, wide=wide)
    return Engine(build_model(cfg), tparams, axes, max_len=max_len,
                  max_batch=max_batch, max_prompt=32, device="cpu")


def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


SPEC = [(5, 4), (12, 2), (20, 6), (9, 3), (3, 5)]


def test_olmoe_generate_and_queue_equal_solo_generate():
    """Reduced OLMoE (drop-free): a group of 3 through ``generate`` and a
    ragged queue from 2 slots through ``serve_queue`` serve every stream
    the tokens of its solo ``generate``, on the eager store."""
    eng = _engine("olmoe_1b_7b", max_len=128, max_batch=4)
    prompts = np.stack([_prompt(12, s) for s in range(3)])
    group = eng.generate({"tokens": torch.from_numpy(prompts)}, steps=4)
    for i in range(3):
        solo = eng.generate({"tokens": torch.from_numpy(prompts[i:i + 1])},
                            steps=4)
        np.testing.assert_array_equal(group.tokens[i].numpy(),
                                      solo.tokens[0].numpy())
    reqs = [Request(tokens=_prompt(n, n), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(SPEC)]
    results, stats = eng.serve_queue(reqs, slots=2)
    assert stats.admitted == stats.completed == len(SPEC)
    assert max(r.admitted_at for r in results) > min(r.admitted_at
                                                     for r in results)
    for r, (n, m) in zip(results, SPEC):
        solo = eng.generate({"tokens": torch.from_numpy(_prompt(n, n)[None])},
                            steps=m)
        np.testing.assert_array_equal(r.tokens, solo.tokens[0].numpy())


def test_check_cells_over_an_mla_engine():
    """Every cell of a DeepSeek-V2 (MLA, dense0) grid checks equal to its
    eager run, ``prefill_row``'s written c / kr / dense0 rows included."""
    eng = _engine("deepseek_v2_236b", max_len=48)
    store = ProgramStore(eng.model, device="cpu")
    rows = precompile_grid(eng.model, eng.params, buckets=(1, 2),
                           lengths=(8,), max_len=48, store=store)
    assert len(rows) == 2 * (1 + 3)
    checks = check_cells(store)
    assert len(checks) == len(rows) and all(c["equal"] for c in checks)


@pytest.mark.parametrize("skipped", ["c", "dense0_kr"])
def test_check_cells_catches_an_mla_cell_that_skips_a_write(skipped):
    """A ``prefill_row`` program that writes every cache entry but one
    MLA slab's rows fails ``check_cells``."""
    eng = _engine("deepseek_v2_236b", max_len=48)
    store = ProgramStore(eng.model, device="cpu")
    precompile_grid(eng.model, eng.params, buckets=(2,), lengths=(8,),
                    max_len=48, store=store)
    prog = next(p for p in store.programs() if p.kind == "prefill_row")
    fn = store._fns["prefill_row"]

    def skips_one(params, batch, cache, row, t_end):
        keep = cache[skipped].clone()
        out = fn(params, batch, cache, row, t_end)
        cache[skipped].copy_(keep)
        return out

    prog.fn = skips_one
    by_kind = {c["kind"]: c["equal"] for c in check_cells(store)}
    assert by_kind == {"decode": True, "prefill": True, "prefill_row": False}


@pytest.mark.parametrize("argv", [
    ["--arch", "olmoe_1b_7b", "--trace", "1,3"],
    ["--arch", "deepseek_v2_236b", "--trace", "1,2"],
    ["--arch", "olmoe_1b_7b", "--trace", "2:9,1:5", "--queue",
     "--max-batch", "2"],
])
def test_launcher_serves_the_moe_family_on_the_cpu(tmp_path, argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans.json"),
               REPRO_TORCH_MEASURE_CACHE=str(tmp_path / "meas.json"),
               REPRO_TORCH_MISS_LOG=str(tmp_path / "misses.json"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--reduced", "--device", "cpu", "--steps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "param_count=" in out.stdout and "active_param_count=" in out.stdout
    assert ("-- scheduler telemetry --" in out.stdout) == ("--queue" in argv)


def test_override_without_reduced_keeps_the_published_widths():
    from repro_torch.launch.serve import config_for
    cfg = config_for("deepseek_v2_236b", reduced=False,
                     override="num_layers=3")
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts) == (3, 5120, 160)
    small = config_for("olmoe_1b_7b", reduced=True, override="d_model=512")
    assert (small.d_model, small.num_experts) == (512, 8)
