"""The port's continuous-batching path against the reference, on the CPU.

The clock seam (``serve/clock.py``), the one-row admission
``lm_prefill_row`` with 0-d device-tensor arguments, the store's
``prefill_row`` cells, and ``Engine.serve_queue`` through
``ContinuousScheduler``.  The float32 config is the reduced qwen1.5-4b
enlarged so every projection and the head pack (``WIDE``, as in
``tests/test_torch_engine.py``); both packages get the reference's
params through numpy.  Tolerances: tokens, admission clocks, queue waits
and every scheduler counter are compared exactly; so is virtual-clock
telemetry (both sides add the same ``StepCost`` charges in the same
order); logits and cache k/v within 2e-4 (fp32 sums in another order
through 2 layers); ``valid_from`` and ``slot_pos`` exactly.
"""

import asyncio
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

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import registry as ref_registry
from repro.models import lm as ref_lm
from repro.models.registry import build_model as ref_build_model
from repro.serve.clock import StepCost as RefStepCost
from repro.serve.clock import VirtualClock as RefVirtualClock
from repro.serve.engine import Engine as RefEngine
from repro.serve.scheduler import Request as RefRequest
from repro_torch.configs.base import get_reduced_config
from repro_torch.core import registry
from repro_torch.models import lm
from repro_torch.models.param import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.clock import (Clock, RealClock, StepCost, VirtualClock,
                                     ensure_clock)
from repro_torch.serve.engine import Engine
from repro_torch.serve.programs import (ProgramStore, check_cells,
                                        precompile_grid)
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         SchedulerStats)

WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
REPO = Path(__file__).resolve().parents[1]
TOL = 2e-4
SPEC = [(5, 4), (12, 2), (20, 6), (9, 3), (3, 5)]
COUNTERS = ("steps", "admitted", "completed", "unserved", "rejected",
            "cancelled", "expired", "prompt_tokens", "prompt_pad_tokens",
            "generated_tokens", "slot_steps_active", "queue_steps_total")


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


@pytest.fixture(scope="module")
def wide():
    """The reference's params of the wide fp32 config, and both configs."""
    ref_cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE)
    ref_model = ref_build_model(ref_cfg)
    params, axes = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, params, axes, cfg


def _engine(wide, *, max_len=128, max_batch=2, clock=None, **kw):
    _, params, axes, cfg = wide
    return Engine(build_model(cfg), params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), axes, max_len=max_len,
        max_batch=max_batch, max_prompt=32, device="cpu", clock=clock, **kw)


def _ref_engine(wide, *, max_len=128, max_batch=2, clock=None):
    ref_model, params, axes, _ = wide
    return RefEngine(ref_model, params, axes, max_len=max_len,
                     max_batch=max_batch, max_prompt=32, program_cache=False,
                     clock=clock)


def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _queue(cls, spec=SPEC, seed0=0):
    return [cls(tokens=_prompt(n, seed0 + n), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(spec)]


# ---------------------------------------------------------------------------
# the clock seam
# ---------------------------------------------------------------------------


def test_clock_protocol():
    vc = VirtualClock(start=2.0)
    assert vc.virtual and isinstance(vc, Clock)
    assert vc.now() == 2.0
    assert vc.advance(0.5) == 2.5
    assert vc.advance_to(2.25) == 2.5          # never rewinds
    with pytest.raises(ValueError):
        vc.advance(-1.0)
    rc = RealClock()
    assert not rc.virtual and isinstance(rc, Clock)
    assert rc.now() <= rc.now()
    with pytest.raises(TypeError):
        rc.advance(1.0)
    assert ensure_clock(None).virtual is False
    assert ensure_clock(vc) is vc

    async def go():
        await vc.sleep(1.5)
        return vc.now()

    assert asyncio.run(go()) == 4.0             # sleeps advance, never block


def test_step_cost_defaults_match_the_reference():
    assert dataclasses.asdict(StepCost()) == dataclasses.asdict(RefStepCost())
    c = StepCost(decode_step_s=2e-3, prefill_token_s=1e-5)
    assert c.prefill_s(100) == RefStepCost(prefill_token_s=1e-5).prefill_s(100)


# ---------------------------------------------------------------------------
# lm_prefill_row with device offsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row,t_end,pad", [(1, 10, 2), (0, 8, 0), (1, 23, 7)])
def test_prefill_row_tensor_args_match_reference(wide, row, t_end, pad):
    """0-d int32 row / t_end / pad (what a captured cell passes) against
    the reference's int arguments: logits and every cache field."""
    _, params, _, cfg = wide
    ref_cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(row + t_end).integers(0, cfg.vocab_size,
                                                         (1, 8))
    want, rcache = ref_lm.lm_prefill_row(
        params, ref_cfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                          "pad": jnp.asarray([pad], jnp.int32)},
        ref_lm.init_cache(ref_cfg, 2, 24), row, t_end)
    cache = lm.init_cache(cfg, 2, 24, "cpu")
    cache["pos"].fill_(5)
    got, tcache = lm.lm_prefill_row(
        tparams, cfg, {"tokens": torch.from_numpy(tokens).to(torch.int32),
                       "pad": torch.tensor([pad], dtype=torch.int32)},
        cache, torch.tensor(row, dtype=torch.int32),
        torch.tensor(t_end, dtype=torch.int32))
    assert got.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for f in ("slot_pos", "valid_from"):
        np.testing.assert_array_equal(tcache[f].numpy(), np.asarray(rcache[f]))
    for f in ("k", "v"):
        np.testing.assert_allclose(tcache[f].numpy(), np.asarray(rcache[f]),
                                   rtol=TOL, atol=TOL)
    assert int(tcache["pos"]) == 5                 # the caller's clock


def test_prefill_row_int_and_tensor_args_agree_bit_for_bit(wide):
    _, params, _, cfg = wide
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = {"tokens": torch.from_numpy(_prompt(16, 3)[None]),
             "pad": torch.tensor([5], dtype=torch.int32)}
    outs = []
    for row, t_end in ((1, 20), (torch.tensor(1, dtype=torch.int32),
                                 torch.tensor(20, dtype=torch.int32))):
        cache = lm.init_cache(cfg, 2, 32, "cpu")
        logits, cache = lm.lm_prefill_row(tparams, cfg, batch, cache, row,
                                          t_end)
        outs.append((logits, cache))
    (a, ca), (b, cb) = outs
    assert torch.equal(a, b)
    assert all(torch.equal(ca[k], cb[k]) for k in ca)
    # the other row and the slots outside [4, 20) are untouched
    assert not ca["k"][:, 0].any() and not ca["k"][:, 1, 20:].any()
    assert ca["valid_from"].tolist() == [0, 9]
    assert ca["slot_pos"][4:20].tolist() == list(range(4, 20))


# ---------------------------------------------------------------------------
# the store's prefill_row cells
# ---------------------------------------------------------------------------


def test_prefill_row_cells_in_an_eager_store(wide):
    """``precompile_grid`` acquires one ``prefill_row`` cell per (bucket x
    length) on that bucket's cache; ``check_cells`` replays each at a
    random row and clock and compares logits and the written row."""
    eng = _engine(wide, max_len=48, max_batch=4)
    store = ProgramStore(eng.model, device="cpu")
    rows = precompile_grid(eng.model, eng.params, buckets=(1, 2),
                           lengths=(8, 16), max_len=48, store=store)
    row_cells = [(r["bucket"], r["tokens"]) for r in rows
                 if r["kind"] == "prefill_row"]
    assert row_cells == [(1, 8), (1, 16), (2, 8), (2, 16)]
    checks = check_cells(store, seed=3)
    assert len(checks) == len(rows) == 2 * (1 + 3 * 2)
    assert all(c["equal"] for c in checks)
    assert sum(c["kind"] == "prefill_row" for c in checks) == 4
    # each (bucket, length) cell acquired once; a second grid is all held
    again = precompile_grid(eng.model, eng.params, buckets=(1, 2),
                            lengths=(8, 16), max_len=48, store=store)
    assert all(r["source"] == "memory" for r in again)


def test_check_cells_catches_a_cell_that_skips_the_cache_write(wide):
    """A ``prefill_row`` program that returns the logits but writes no
    cache row fails ``check_cells``: the written row is compared too."""
    eng = _engine(wide, max_len=48, max_batch=2)
    store = ProgramStore(eng.model, device="cpu")
    precompile_grid(eng.model, eng.params, buckets=(2,), lengths=(8,),
                    max_len=48, store=store)
    prog = next(p for p in store.programs() if p.kind == "prefill_row")
    fn = store._fns["prefill_row"]

    def logits_only(params, batch, cache, row, t_end):
        scratch = {k: v.clone() for k, v in cache.items()}
        return fn(params, batch, scratch, row, t_end)[0], cache

    prog.fn = logits_only
    by_kind = {c["kind"]: c["equal"] for c in check_cells(store)}
    assert by_kind == {"decode": True, "prefill": True, "prefill_row": False}


# ---------------------------------------------------------------------------
# serve_queue against the reference
# ---------------------------------------------------------------------------


def _assert_same_queue(got, want):
    (results, stats), (ref_results, ref_stats) = got, want
    assert len(results) == len(ref_results)
    for r, w in zip(results, ref_results):
        assert r.rid == w.rid
        np.testing.assert_array_equal(r.tokens, np.asarray(w.tokens))
        assert (r.prompt_len, r.length_bucket, r.admitted_at, r.finished_at,
                r.queue_steps, r.completed) == (
            w.prompt_len, w.length_bucket, w.admitted_at, w.finished_at,
            w.queue_steps, w.completed)
    for f in COUNTERS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.slots == ref_stats.slots


def test_serve_queue_matches_the_reference(wide):
    """The reference test's queue from 2 slots on the virtual clock: later
    requests join a running batch; tokens, admission clocks, queue waits,
    counters and the virtual wall / compile seconds equal the
    reference's, cold and then warm."""
    eng = _engine(wide, clock=VirtualClock())
    ref = _ref_engine(wide, clock=RefVirtualClock())
    for run in range(2):
        got = eng.serve_queue(_queue(Request))
        want = ref.serve_queue(_queue(RefRequest))
        _assert_same_queue(got, want)
        stats, ref_stats = got[1], want[1]
        assert stats.wall_s == ref_stats.wall_s
        assert stats.compile_s == ref_stats.compile_s
        assert stats.tokens_per_s == ref_stats.tokens_per_s
        assert stats.rows() == ref_stats.rows()
        # cold: one prefill_row cell per length bucket hit (8, 16, 32)
        # and the decode cell; warm: nothing
        assert stats.compile_s == (4 * StepCost().compile_s if run == 0
                                   else 0.0)
    assert max(r.admitted_at for r in got[0]) > min(r.admitted_at
                                                    for r in got[0])
    assert got[1].queue_steps_total > 0


def test_serve_queue_streams_equal_their_solo_generate(wide):
    eng = _engine(wide)
    results, stats = eng.serve_queue(_queue(Request))
    assert stats.admitted == stats.completed == len(SPEC)
    assert 0 < stats.occupancy <= 1
    assert stats.prompt_pad_tokens == sum(
        eng.grid.length_bucket(n) - n for n, _ in SPEC)
    for r, (n, m) in zip(results, SPEC):
        solo = eng.generate({"tokens": torch.from_numpy(_prompt(n, n)[None])},
                            steps=m)
        np.testing.assert_array_equal(r.tokens, solo.tokens[0].numpy())


def test_eos_stops_the_stream(wide):
    eng = _engine(wide, max_len=96)
    probe, _ = eng.serve_queue([Request(tokens=_prompt(9, 1),
                                        max_new_tokens=6)])
    toks = probe[0].tokens.tolist()
    k = next(i for i in range(1, len(toks)) if toks[i] not in toks[:i])
    res, _ = eng.serve_queue([Request(tokens=_prompt(9, 1), max_new_tokens=6,
                                      eos_id=toks[k])])
    assert res[0].tokens.tolist() == toks[:k + 1]


def test_capacity_truncation_matches_the_reference(wide):
    """The clock hits max_len: live streams are truncated and queued ones
    unserved, as in the reference."""
    spec = [(9, 50), (9, 50)]
    got = _engine(wide, max_len=20, max_batch=1).serve_queue(
        _queue(Request, spec))
    want = _ref_engine(wide, max_len=20, max_batch=1).serve_queue(
        _queue(RefRequest, spec))
    _assert_same_queue(got, want)
    results, stats = got
    assert not results[0].completed and len(results[0].tokens) > 0
    assert stats.unserved == 1 and len(results[1].tokens) == 0


def test_unsupported_family_is_refused(wide):
    eng = _engine(wide)
    eng.model = dataclasses.replace(eng.model, prefill_row=None)
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousScheduler(eng)


def test_no_new_cells_once_warm(wide):
    """Other prompt lengths reuse the (slots x length bucket) cells."""
    eng = _engine(wide)
    eng.serve_queue([Request(tokens=_prompt(n, n), max_new_tokens=2)
                     for n in (3, 9, 14, 30)])        # buckets 8, 16, 32
    kinds = [p.kind for p in eng.programs.programs()]
    assert kinds.count("prefill_row") == 3 and kinds.count("decode") == 1
    eng.serve_queue([Request(tokens=_prompt(n, n + 50), max_new_tokens=3)
                     for n in (5, 11, 25, 16, 2)])
    assert [p.kind for p in eng.programs.programs()] == kinds


def test_generate_on_the_pool_bucket_raises_while_open(wide):
    eng = _engine(wide)
    sched = ContinuousScheduler(eng, slots=2)
    sched.open(16)
    try:
        with pytest.raises(RuntimeError, match="slot pool"):
            eng.generate({"tokens": torch.zeros((2, 8), dtype=torch.int32)},
                         steps=1)
        with pytest.raises(RuntimeError, match="already"):
            ContinuousScheduler(eng, slots=2).open(16)
        # another bucket's cache is free
        eng.generate({"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                     steps=1)
    finally:
        sched.close()
    eng.generate({"tokens": torch.zeros((2, 8), dtype=torch.int32)}, steps=1)


def test_open_resets_the_pool_a_generate_left(wide):
    """The pool is the bucket's static cache: ``open`` puts back what a
    fresh cache holds (the clock, idle rows masked, no slot filled), so a
    queue after a generate serves what it serves on a fresh engine."""
    eng = _engine(wide)
    eng.generate({"tokens": torch.from_numpy(
        np.stack([_prompt(16, 7), _prompt(16, 8)]))}, steps=5)
    sched = ContinuousScheduler(eng, slots=2)
    sched.open(16)
    cache = sched.cache
    assert int(cache["pos"]) == 16
    assert cache["valid_from"].tolist() == [128, 128]
    assert (cache["slot_pos"] == -1).all()
    sched.close()
    got = eng.serve_queue(_queue(Request))
    want = _engine(wide).serve_queue(_queue(Request))
    _assert_same_queue(got, want)


def test_request_json_roundtrip_and_old_records():
    r = Request(tokens=torch.tensor([3, 1, 4]), max_new_tokens=7, eos_id=2,
                rid="abc", arrival_time=1.25, priority=2, tenant="acme",
                deadline=3.5)
    back = Request.from_json(r.to_json())
    assert back.to_json() == r.to_json()
    assert list(back.tokens) == [3, 1, 4]
    assert r.to_json() == RefRequest(**{**dataclasses.asdict(r),
                                        "tokens": np.asarray([3, 1, 4])}
                                     ).to_json()
    r2 = Request.from_json({"tokens": [5, 6], "max_new_tokens": 3,
                            "eos_id": None, "rid": 0})
    assert (r2.arrival_time, r2.priority, r2.tenant, r2.deadline) == (
        0.0, 0, "default", None)


def test_tier_stats_are_bounded(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TIER_STATS_MAX", "3")
    stats = SchedulerStats(slots=2)
    for prio in range(5):
        stats.tier(prio).admitted += 1
    assert sorted(stats.tiers) == [2, 3, 4]


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------


def _launcher(tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans.json"),
               REPRO_TORCH_MEASURE_CACHE=str(tmp_path / "meas.json"),
               REPRO_TORCH_MISS_LOG=str(tmp_path / "misses.json"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1_5_4b", "--reduced", "--device", "cpu", "--trace",
         "2:9,3:30,1:5", "--max-batch", "4", "--steps", "4", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("mode", ["--queue", "--async"])
def test_launcher_queue_and_async_print_the_telemetry(tmp_path, mode):
    out = _launcher(tmp_path, mode, "--precompile", "--require-warm")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "-- scheduler telemetry --" in out.stdout
    for row in ("slot_occupancy", "padding_frac", "mean_queue_steps",
                "tokens_per_s", "compile_s"):
        assert f"  {row}" in out.stdout
    assert out.stdout.count("\nreq g") == 6
    assert "0 acquired cold by traffic" in out.stdout
    if mode == "--async":
        assert "ttft p50/p95/p99" in out.stdout


def test_launcher_require_warm_fails_when_the_queue_captures(tmp_path):
    out = _launcher(tmp_path, "--queue", "--require-warm")
    assert out.returncode != 0
    assert "--require-warm" in out.stderr


def test_continuous_batching_tool_on_the_cpu(tmp_path):
    from repro_torch.launch import continuous_batching as cb
    rows = cb.main(["--reduced", "--device", "cpu", "--requests", "4",
                    "--max-batch", "2", "--repeats", "1", "--json",
                    str(tmp_path / "cb.json")])
    by = {r["name"]: r["value"] for r in rows}
    assert by["ragged_tokens_per_s"] > 0 and by["aligned_tokens_per_s"] > 0
    assert by["prompt_pad_tokens_ragged"] < by["prompt_pad_tokens_aligned"]
    assert (tmp_path / "cb.json").exists()
