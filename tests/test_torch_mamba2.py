"""The port's Mamba2 block and the SSM LM (Mamba2-780m) against the
reference, on the CPU.

Both packages get the reference's parameters through numpy; inputs are
made from a numpy seed.  The reduced config (2 layers, d_model 128, SSD
state 16, head dim 16, chunk 32) runs in float32; ``WIDE`` enlarges it
so ``w_in`` (2144 wide: no multiple of 128 divides it), ``w_out`` and the
tied head reach 512 and pack.  Tolerances: float32 outputs, states and
logits within rtol = atol = 1e-4 (fp32 sums in another order: the
chunked scan's einsums, the projections); the port's own versions of the
reference's chunked-vs-sequential checks at its 2e-4.
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
from repro.models import lm as ref_lm
from repro.models import mamba2 as RM
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import param_count as ref_param_count
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import install, registry
from repro_torch.core.linear import serving_ctx
from repro_torch.core.packing import PackedTensor
from repro_torch.models import lm
from repro_torch.models import mamba2 as M
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import (active_param_count, build_model,
                                         param_count)
from repro_torch.serve.engine import Engine, iter_packable
from repro_torch.serve.programs import check_cells
from repro_torch.serve.scheduler import ContinuousScheduler

ARCH = "mamba2_780m"
WIDE = dict(d_model=512, num_heads=0, num_kv_heads=0, d_ff=0)
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


def configs(wide=False, **over):
    over = dict(WIDE if wide else {}, dtype="float32", **over)
    ref_cfg = ref_reduced_config(ARCH).reduced(**over)
    cfg = get_reduced_config(ARCH).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def block(seed=0, **over):
    """One Mamba2 block's params in both packages (the reference's init)."""
    ref_cfg, cfg = configs(**over)
    p, _ = RM.init_mamba2(jax.random.PRNGKey(seed), ref_cfg)
    p = jax.tree.map(lambda v: v.astype(jnp.float32), p)
    return ref_cfg, cfg, p, params_from_numpy(jax.tree.map(np.asarray, p),
                                              "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def model(wide=False):
    ref_cfg, cfg = configs(wide)
    params, axes = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return ref_cfg, cfg, params, axes, tparams


# ---------------------------------------------------------------------------
# the block against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, 24, 64])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(chunk, groups):
    """The chunked scan with a carried h0, grouped B/C and the
    largest-divisor chunk (24 -> 16 at S = 48)."""
    b, s, h, p_, n = 2, 48, 4, 8, 16
    x, bm, cm = (_x(sh, i) for i, sh in enumerate(
        [(b, s, h, p_), (b, s, groups, n), (b, s, groups, n)]))
    dt = np.log1p(np.exp(_x((b, s, h), 3)))
    a_neg = -np.exp(_x((h,), 4))
    h0 = _x((b, h, p_, n), 5)
    want_y, want_h = RM._ssd_chunked(*(jnp.asarray(a) for a in
                                       (x, dt, a_neg, bm, cm, h0)), chunk)
    got_y, got_h = M._ssd_chunked(*(_t(a) for a in (x, dt, a_neg, bm, cm,
                                                    h0)), chunk)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_forward_matches_reference():
    ref_cfg, cfg, p, tp = block()
    x = _x((2, 64, cfg.d_model), 1)
    want, (wh, wtail) = RM.mamba2_forward(p, ref_cfg, jnp.asarray(x))
    got, (gh, gtail) = M.mamba2_forward(tp, cfg, _t(x))
    _close(got, want)
    _close(gh, wh)
    _close(gtail, wtail)


def test_state_handoff_matches_reference():
    """forward(first half) -> (h0, conv_init) -> forward(second half), in
    both packages."""
    ref_cfg, cfg, p, tp = block()
    x = _x((1, 64, cfg.d_model), 3)
    _, (wh, wtail) = RM.mamba2_forward(p, ref_cfg, jnp.asarray(x[:, :32]))
    want, (wh2, _) = RM.mamba2_forward(p, ref_cfg, jnp.asarray(x[:, 32:]),
                                       h0=wh, conv_init=wtail)
    _, (gh, gtail) = M.mamba2_forward(tp, cfg, _t(x[:, :32]))
    got, (gh2, _) = M.mamba2_forward(tp, cfg, _t(x[:, 32:]), h0=gh,
                                     conv_init=gtail)
    _close(got, want)
    _close(gh2, wh2)


def test_decode_matches_reference():
    ref_cfg, cfg, p, tp = block()
    x = _x((2, 17, cfg.d_model), 4)
    _, (wh, wtail) = RM.mamba2_forward(p, ref_cfg, jnp.asarray(x[:, :16]))
    want, wssm, wconv = RM.mamba2_decode(p, ref_cfg, jnp.asarray(x[:, 16:]),
                                         wh, wtail, 16)
    _, (gh, gtail) = M.mamba2_forward(tp, cfg, _t(x[:, :16]))
    got, gssm, gconv = M.mamba2_decode(tp, cfg, _t(x[:, 16:]), gh, gtail)
    _close(got, want)
    _close(gssm, wssm)
    _close(gconv, wconv)


def test_ref_scan_matches_reference():
    ref_cfg, cfg, p, tp = block()
    x = _x((2, 12, cfg.d_model), 6)
    _close(M.mamba2_ref_scan(tp, cfg, _t(x)),
           RM.mamba2_ref_scan(p, ref_cfg, jnp.asarray(x)))


def test_short_prompt_conv_tail_is_zero_padded():
    """A prompt shorter than the conv window hands the decode step the
    zero history the reference's decode would start from."""
    _, cfg, _, tp = block()
    x = _t(_x((1, 2, cfg.d_model), 8))
    _, (h, tail) = M.mamba2_forward(tp, cfg, x)
    assert tail.shape[1] == cfg.ssm_conv - 1
    assert torch.equal(tail[:, 0], torch.zeros_like(tail[:, 0]))
    full = M.mamba2_ref_scan(tp, cfg, torch.cat([x, x[:, :1]], dim=1))
    step, _, _ = M.mamba2_decode(tp, cfg, x[:, :1], h, tail)
    _close(step[:, 0], full[:, -1])


# ---------------------------------------------------------------------------
# the port's own versions of tests/test_mamba2.py
# ---------------------------------------------------------------------------


def test_chunked_equals_sequential():
    _, cfg, _, tp = block()
    x = _t(_x((2, 64, cfg.d_model), 1))
    y, _ = M.mamba2_forward(tp, cfg, x)
    _close(y, M.mamba2_ref_scan(tp, cfg, x).numpy(), 2e-4)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunk_size_invariance(chunk):
    _, cfg, _, tp = block()
    x = _t(_x((1, 64, cfg.d_model), 2))
    y, _ = M.mamba2_forward(tp, dataclasses.replace(cfg, ssm_chunk=chunk), x)
    y32, _ = M.mamba2_forward(tp, cfg, x)
    _close(y, y32.numpy(), 2e-4)


def test_state_handoff_matches_full():
    _, cfg, _, tp = block()
    x = _t(_x((1, 64, cfg.d_model), 3))
    y_full, _ = M.mamba2_forward(tp, cfg, x)
    y1, (h1, tail1) = M.mamba2_forward(tp, cfg, x[:, :32])
    y2, _ = M.mamba2_forward(tp, cfg, x[:, 32:], h0=h1, conv_init=tail1)
    _close(torch.cat([y1, y2], dim=1), y_full.numpy(), 2e-4)


def test_decode_continues_forward():
    _, cfg, _, tp = block()
    s = 33
    x = _t(_x((2, s, cfg.d_model), 4))
    y_full, _ = M.mamba2_forward(tp, cfg, x)
    _, (h, tail) = M.mamba2_forward(tp, cfg, x[:, :s - 1])
    y_step, _, _ = M.mamba2_decode(tp, cfg, x[:, -1:], h, tail)
    _close(y_step[:, 0], y_full[:, -1].numpy(), 2e-4)


# ---------------------------------------------------------------------------
# the SSM LM against the reference
# ---------------------------------------------------------------------------


def test_lm_forward_matches_reference():
    ref_cfg, cfg, params, _, tparams = model()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want, want_aux, _ = ref_lm.lm_forward(
        params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, aux, _ = lm.lm_forward(tparams, cfg,
                                {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


def test_init_cache_layout_matches():
    ref_cfg, cfg = configs()
    want = ref_lm.init_cache(ref_cfg, 2, 24)
    got = lm.init_cache(cfg, 2, 24, "cpu")
    assert sorted(got) == sorted(want) == ["conv", "pos", "ssm"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def test_prefill_and_three_decode_steps_match_reference():
    """Prefill, then 3 greedy steps: logits, the ``ssm`` / ``conv`` state
    and ``pos`` against the reference; the port writes the state into the
    cache's own tensors."""
    ref_cfg, cfg, params, _, tparams = model()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    cache = ref_lm.init_cache(ref_cfg, 2, 24)
    tcache = lm.init_cache(cfg, 2, 24, "cpu")
    slabs = {k: tcache[k] for k in ("ssm", "conv")}
    want, cache = ref_lm.lm_prefill(params, ref_cfg,
                                    {"tokens": jnp.asarray(tokens, jnp.int32)},
                                    cache)
    got, tcache = lm.lm_prefill(tparams, cfg,
                                {"tokens": torch.from_numpy(tokens)}, tcache)
    _close(got, want)
    for _ in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, cache = ref_lm.lm_decode_step(params, ref_cfg, cache,
                                            jnp.asarray(tok))
        got, tcache = lm.lm_decode_step(tparams, cfg, tcache,
                                        torch.from_numpy(tok))
        _close(got, want)
        for k in ("ssm", "conv"):
            _close(tcache[k], cache[k])
            assert tcache[k] is slabs[k]
        assert int(tcache["pos"]) == int(cache["pos"])


def test_param_counts_match_reference():
    """The published Mamba2-780m, counted on the meta device."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    want = ref_param_count(ref_build_model(ref_cfg))
    m = build_model(cfg)
    assert param_count(m) == active_param_count(m) == want


# ---------------------------------------------------------------------------
# ragged refusal, the install stage, the engine and the store
# ---------------------------------------------------------------------------


def test_prefill_row_refuses_ssm_state():
    _, cfg, _, _, tparams = model()
    assert build_model(cfg).prefill_row is None
    with pytest.raises(NotImplementedError, match="SSM state is "
                       "order-dependent and cannot mask left-padding"):
        lm.lm_prefill_row(tparams, cfg, {"tokens": torch.zeros((1, 8),
                                                               dtype=torch.int32)},
                          lm.init_cache(cfg, 2, 24, "cpu"), 0, 8)


def _engine(wide=False, **kw):
    _, cfg, _, axes, tparams = model(wide)
    return Engine(build_model(cfg), tparams, axes, max_len=48, max_batch=2,
                  max_prompt=16, device="cpu", **kw), cfg


def test_serve_and_the_scheduler_refuse_ragged_prompts():
    eng, cfg = _engine()
    assert not eng.ragged_supported()
    reqs = [{"tokens": torch.arange(n, dtype=torch.int32)} for n in (5, 9)]
    with pytest.raises(ValueError, match=r"ragged prompt lengths \[5, 9\] "
                       r"need an attention-cache LM \(family=ssm\)"):
        eng.serve(reqs, steps=2)
    with pytest.raises(ValueError, match="continuous batching needs an "
                       "attention-cache LM"):
        ContinuousScheduler(eng)
    out = eng.serve([{"tokens": torch.arange(8, dtype=torch.int32)}] * 2, 2)
    assert [tuple(r.tokens.shape) for r in out] == [(1, 2), (1, 2)]


@pytest.mark.parametrize("wide", [False, True])
def test_serving_shapes_cover_every_packable_leaf(wide):
    _, cfg = configs(wide)
    params, axes = build_model(cfg).init(MetaGenerator())
    leaves = list(iter_packable(params, axes))
    assert bool(leaves) == wide
    for path, leaf, _ in leaves:
        assert tuple(leaf.shape[-2:]) in install.serving_shapes(cfg), path
    # the tied head the engine packs
    assert (cfg.d_model, cfg.vocab_size) in install.serving_shapes(cfg)


def test_serving_shapes_equal_the_reference():
    assert install.serving_shapes(get_config(ARCH)) == \
        ref_install.serving_shapes(ref_get_config(ARCH))


def test_every_mamba_leaf_and_the_tied_head_pack_at_load():
    """w_in (2144 wide) is packed zero-padded to whole blocks, the tied
    head as a packed copy of the table's transpose; the engine's logits
    equal an unpacked engine's."""
    eng, cfg = _engine(wide=True)
    assert sorted(eng.pack_report) == ["embed/head", "layers/mamba/w_in",
                                       "layers/mamba/w_out"]
    mamba = eng.params["layers"]["mamba"]
    assert all(isinstance(mamba[k], PackedTensor) for k in ("w_in", "w_out"))
    assert mamba["w_in"].shape[-1] == 2144
    assert mamba["w_in"].blocks.shape[-3] * mamba["w_in"].blocks.shape[-1] \
        > 2144
    assert isinstance(eng.params["embed"]["head"], PackedTensor)
    plain, _ = _engine(wide=True, prepack=False)
    assert plain.pack_report == {} and "head" not in plain.params["embed"]
    batch = {"tokens": torch.arange(32).reshape(2, 16) % cfg.vocab_size}
    got, want = eng.generate(batch, 3), plain.generate(batch, 3)
    _close(got.logits_last, want.logits_last.numpy())


def test_install_then_serve_makes_no_miss():
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


def test_check_cells_restores_the_recurrent_state():
    """The grid holds prefill and decode cells only; ``check_cells`` runs
    each decode cell twice from one state (the CPU's cells are eager), so
    only a restored ``ssm`` / ``conv`` makes the two runs equal."""
    eng, _ = _engine()
    rows = eng.precompile()
    assert {r["kind"] for r in rows} == {"prefill", "decode"}
    assert len(rows) == len(eng.buckets) * (1 + len(eng.grid.length))
    cache = eng.programs.static_cache(2, eng.max_len)
    with torch.inference_mode():
        cache["ssm"].normal_()
    out = check_cells(eng.programs)
    assert len(out) == len(rows) and all(c["equal"] for c in out)


def test_decode_step_depends_on_the_state():
    """The property ``check_cells`` relies on: two decode steps from two
    states differ."""
    _, cfg, _, _, tparams = model()
    c1 = lm.init_cache(cfg, 1, 8, "cpu")
    c2 = lm.init_cache(cfg, 1, 8, "cpu")
    c2["ssm"].normal_()
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with serving_ctx():
        a, _ = lm.lm_decode_step(tparams, cfg, c1, tok)
        b, _ = lm.lm_decode_step(tparams, cfg, c2, tok)
    assert not torch.equal(a, b)
