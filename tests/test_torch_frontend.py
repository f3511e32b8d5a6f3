"""The port's async front end (``serve/frontend.py``) on the CPU.

Everything runs on the virtual clock: arrivals, TTFT, queue delay and
wall-time telemetry are deterministic functions of (trace seed,
StepCost).  ``simulate`` is held to the reference's on the same trace
(the reduced fp32 qwen1.5-4b enlarged so every projection packs,
``WIDE``; the reference's params through numpy) with equal tokens,
token times, TTFTs and rejected / completed flags, compared exactly:
both sides add the same ``StepCost`` charges in the same order.  The
policies (backpressure, priority tiers, tenant round-robin, starvation
escalation, the prefill budget, deadlines, cancel, retry) and the
asyncio loop are tested on the port alone, with the reference's
invariants.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import registry as ref_registry
from repro.models.registry import build_model as ref_build_model
from repro.serve.clock import VirtualClock as RefVirtualClock
from repro.serve.engine import Engine as RefEngine
from repro.serve.frontend import AsyncEngine as RefAsyncEngine
from repro.serve.scheduler import Request as RefRequest
from repro_torch.configs.base import get_reduced_config
from repro_torch.core import registry
from repro_torch.models.param import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.clock import StepCost, VirtualClock
from repro_torch.serve.engine import Engine
from repro_torch.serve.frontend import AdmissionError, AsyncEngine
from repro_torch.serve.scheduler import Request

WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
VOCAB = 512
COST = StepCost()
SPEC = [(5, 4), (12, 2), (20, 6), (9, 3), (3, 5), (7, 1)]


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
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
    ref_cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE)
    ref_model = ref_build_model(ref_cfg)
    params, axes = ref_model.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return ref_model, params, axes, cfg, tparams


def make_engine(wide, *, max_len=256, max_batch=2):
    _, _, axes, cfg, tparams = wide
    return Engine(build_model(cfg), tparams, axes, max_len=max_len,
                  max_batch=max_batch, max_prompt=32, device="cpu",
                  clock=VirtualClock())


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def rand_trace(seed, n, cls=Request, *, mean_gap_s=0.002, tiers=3,
               tenants=("acme", "bolt", "crux"), max_prompt=24):
    """Seeded open-loop trace: random arrivals, prompt lengths, decode
    budgets (including the instant-finish max_new_tokens=1), priorities
    and tenants."""
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(mean_gap_s))
        p = int(rng.integers(2, max_prompt))
        reqs.append(cls(
            tokens=rng.integers(0, VOCAB, size=p).astype(np.int32),
            max_new_tokens=int(rng.integers(1, 6)), rid=i,
            arrival_time=t, priority=int(rng.integers(0, tiers)),
            tenant=str(tenants[int(rng.integers(0, len(tenants)))])))
    return reqs


def check_invariants(afe, streams, stats, n_submitted):
    """No slot leaks, every stream terminal, and the telemetry ties out."""
    assert not afe.sched.active
    assert sorted(afe.sched.free) == list(range(afe.sched.slots))
    assert len(streams) == n_submitted
    n_rej = sum(s.rejected for s in streams)
    n_adm = sum(s.result is not None for s in streams)
    n_dropped = n_submitted - n_rej - n_adm
    assert all(s.done for s in streams)
    assert stats.rejected == n_rej
    assert stats.unserved + stats.cancelled - sum(
        s.cancelled and s.result is not None for s in streams) == n_dropped
    assert stats.admitted == n_adm
    assert stats.completed == sum(s.completed for s in streams)
    assert stats.generated_tokens == sum(len(s.tokens) for s in streams)
    for s in streams:
        if s.result is not None:
            assert list(s.result.tokens) == s.tokens
            assert s.queue_delay is not None and s.queue_delay >= 0
            assert all(b >= a for a, b in zip(s.token_times,
                                              s.token_times[1:]))
        else:
            assert s.tokens == []
    assert sum(t.admitted for t in stats.tiers.values()) == n_adm
    assert sum(t.rejected for t in stats.tiers.values()) == n_rej


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,queue_limit,budget,max_len", [
    (7, 6, 16, 512),        # priorities, tenants, budget
    (1, 3, None, 512),      # tight queue: rejections
    (2, 32, 8, 96),         # tight capacity: truncation and unserved
])
def test_simulate_matches_the_reference(wide, seed, queue_limit, budget,
                                        max_len):
    ref_model, params, axes, _, _ = wide
    eng = make_engine(wide, max_len=max_len)
    ref = RefEngine(ref_model, params, axes, max_len=max_len, max_batch=2,
                    max_prompt=32, program_cache=False,
                    clock=RefVirtualClock())
    kw = dict(queue_limit=queue_limit, prefill_budget=budget,
              starvation_steps=16)
    streams, stats = AsyncEngine(eng, clock=VirtualClock(), **kw).simulate(
        rand_trace(seed, 12))
    want, ref_stats = RefAsyncEngine(ref, clock=RefVirtualClock(),
                                     **kw).simulate(
        rand_trace(seed, 12, RefRequest))
    assert len(streams) == len(want) == 12
    for s, w in zip(streams, want):
        assert s.rid == w.rid
        assert s.tokens == [int(t) for t in w.tokens]
        assert s.token_times == w.token_times
        assert s.ttft == w.ttft
        assert (s.rejected, s.completed, s.cancelled) == (
            w.rejected, w.completed, w.cancelled)
        assert s.queue_steps == w.queue_steps
    for f in ("steps", "admitted", "completed", "unserved", "rejected",
              "generated_tokens", "prompt_tokens", "prompt_pad_tokens",
              "queue_steps_total", "compile_s", "wall_s"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.rows() == ref_stats.rows()


def test_simulate_byte_identical_to_serve_queue(wide):
    """All arrivals at 0 and the default policy: the same tokens,
    admission clocks and waits as ``Engine.serve_queue``."""
    reqs = [Request(tokens=_prompt(n, n), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(SPEC)]
    eng = make_engine(wide, max_len=128)
    results, stats = eng.serve_queue(reqs)
    streams, astats = AsyncEngine(eng, clock=VirtualClock()).simulate(
        [dataclasses.replace(r) for r in reqs])
    for r, s in zip(results, streams):
        assert s.tokens == r.tokens.tolist()
        assert (s.result.admitted_at, s.result.finished_at,
                s.result.queue_steps, s.result.completed) == (
            r.admitted_at, r.finished_at, r.queue_steps, r.completed)
    assert (astats.steps, astats.admitted, astats.completed,
            astats.generated_tokens) == (stats.steps, stats.admitted,
                                         stats.completed,
                                         stats.generated_tokens)


def test_simulate_needs_a_virtual_clock(wide):
    from repro_torch.serve.clock import RealClock
    afe = AsyncEngine(make_engine(wide), clock=RealClock())
    with pytest.raises(TypeError, match="VirtualClock"):
        afe.simulate([Request(tokens=_prompt(5), max_new_tokens=2)])


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,queue_limit,budget,max_len", [
    (0, 32, None, 512),
    (3, 2, None, 96),       # capacity exhaustion: unserved drops
])
def test_no_slot_leak_random_interleavings(wide, seed, queue_limit, budget,
                                           max_len):
    afe = AsyncEngine(make_engine(wide, max_len=max_len),
                      queue_limit=queue_limit, prefill_budget=budget,
                      starvation_steps=16, clock=VirtualClock())
    trace = rand_trace(seed, 12)
    streams, stats = afe.simulate(trace)
    check_invariants(afe, streams, stats, len(trace))


def test_backpressure_bounded_queue(wide):
    trace = [Request(tokens=_prompt(6, i), max_new_tokens=8, rid=i)
             for i in range(8)]
    afe = AsyncEngine(make_engine(wide, max_batch=1), queue_limit=3,
                      clock=VirtualClock())
    streams, stats = afe.simulate(trace)
    check_invariants(afe, streams, stats, len(trace))
    assert stats.rejected == 5
    assert [s.rejected for s in streams] == [False] * 3 + [True] * 5
    assert all(s.completed for s in streams if not s.rejected)


def test_priority_tiers_admit_first(wide):
    trace = [Request(tokens=_prompt(5, i), max_new_tokens=2, rid=f"lo{i}",
                     priority=1) for i in range(3)]
    trace += [Request(tokens=_prompt(5, 10 + i), max_new_tokens=2,
                      rid=f"hi{i}", priority=0) for i in range(3)]
    afe = AsyncEngine(make_engine(wide, max_batch=1), starvation_steps=1000,
                      clock=VirtualClock())
    streams, _ = afe.simulate(trace)
    by_adm = sorted(streams, key=lambda s: s.result.admitted_at)
    assert [s.priority for s in by_adm] == [0, 0, 0, 1, 1, 1]


def test_tenant_fairness_round_robin(wide):
    trace = [Request(tokens=_prompt(5, i), max_new_tokens=2, rid=f"a{i}",
                     tenant="a") for i in range(3)]
    trace += [Request(tokens=_prompt(5, 10 + i), max_new_tokens=2,
                      rid=f"b{i}", tenant="b") for i in range(3)]
    afe = AsyncEngine(make_engine(wide, max_batch=1), clock=VirtualClock())
    streams, _ = afe.simulate(trace)
    order = sorted(streams, key=lambda s: (s.result.admitted_at,
                                           s.queue_steps))
    assert [s.tenant for s in order] == ["a", "b", "a", "b", "a", "b"]


def test_starvation_escalates_a_low_tier(wide):
    starve = 8
    trace = [Request(tokens=_prompt(6, 100 + i), max_new_tokens=4,
                     rid=f"hi{i}", arrival_time=i * 1e-4, priority=0,
                     tenant="flood") for i in range(12)]
    trace.append(Request(tokens=_prompt(6, 50), max_new_tokens=4, rid="lo",
                         arrival_time=1e-4, priority=2, tenant="patient"))
    afe = AsyncEngine(make_engine(wide, max_len=1024, max_batch=1),
                      starvation_steps=starve, clock=VirtualClock())
    streams, stats = afe.simulate(trace)
    check_invariants(afe, streams, stats, len(trace))
    lo = next(s for s in streams if s.rid == "lo")
    assert lo.completed and lo.queue_steps <= starve + 8
    assert lo.result.admitted_at < max(s.result.finished_at for s in streams
                                       if s.tenant == "flood")
    assert stats.tiers[2].completed == 1


def test_prefill_budget_chunks_admissions(wide):
    def run(budget):
        trace = [Request(tokens=_prompt(14, i), max_new_tokens=6, rid=i)
                 for i in range(4)]
        afe = AsyncEngine(make_engine(wide, max_len=1024, max_batch=4),
                          prefill_budget=budget, clock=VirtualClock())
        streams, stats = afe.simulate(trace)
        check_invariants(afe, streams, stats, len(trace))
        return sorted(s.result.admitted_at for s in streams)

    assert len(set(run(None))) == 1
    adm = run(16)           # length bucket 16: one admission a step
    assert [b - a for a, b in zip(adm, adm[1:])] == [0, 1, 1]


def test_deadline_expires_queued_and_reclaims_running(wide):
    deadline = COST.prefill_s(8) + 3.5 * COST.decode_step_s
    trace = [Request(tokens=_prompt(6, 0), max_new_tokens=50, rid=0,
                     deadline=deadline),
             Request(tokens=_prompt(6, 1), max_new_tokens=50, rid=1,
                     deadline=deadline),
             Request(tokens=_prompt(6, 2), max_new_tokens=3, rid=2),
             Request(tokens=_prompt(6, 3), max_new_tokens=3, rid="doomed",
                     deadline=1e-6)]
    afe = AsyncEngine(make_engine(wide), clock=VirtualClock())
    streams, stats = afe.simulate(trace)
    s0, s1, s2, doomed = streams
    assert s0.cancelled and s1.cancelled and 0 < len(s0.tokens) < 50
    assert s0.result is not None and not s0.result.completed
    assert s2.completed and len(s2.tokens) == 3
    assert doomed.cancelled and doomed.tokens == [] and doomed.result is None
    assert stats.expired == 3 and stats.cancelled == 3
    assert sorted(afe.sched.free) == list(range(afe.sched.slots))


def test_cancel_and_the_asyncio_loop(wide):
    """``run()`` on the virtual clock: concurrent producers ``await
    submit``, consume ``async for`` token streams; a cooperative cancel
    frees its row, and the other stream matches ``serve_queue``."""
    eng = make_engine(wide)
    afe = AsyncEngine(eng, clock=VirtualClock())
    reqs = [Request(tokens=_prompt(n, n), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate([(5, 40), (9, 3)])]

    async def scenario():
        s_long = await afe.submit(reqs[0])
        s_short = await afe.submit(reqs[1])
        got = []
        async for tok in s_long:
            got.append(tok)
            if len(got) == 2:
                s_long.cancel()
        short = [tok async for tok in s_short]
        afe.request_stop()
        return s_long, s_short, got, short

    async def main():
        afe.open(max(lb for _, lb in map(afe.sched.prepare, reqs)))
        loop = asyncio.create_task(afe.run())
        out = await scenario()
        await loop
        return out

    s_long, s_short, got, short = asyncio.run(main())
    assert s_long.cancelled and not s_long.completed
    assert 2 <= len(s_long.tokens) < 40 and got == s_long.tokens[:len(got)]
    assert s_short.completed and short == s_short.tokens
    assert s_short.ttft is not None and s_short.ttft > 0
    assert afe.stats.cancelled == 1
    ref, _ = eng.serve_queue([reqs[1]])
    assert short == ref[0].tokens.tolist()


def test_submit_rejected_raises_and_retry_backs_off(wide):
    afe = AsyncEngine(make_engine(wide), queue_limit=2, clock=VirtualClock())

    async def go():
        await afe.submit(Request(tokens=_prompt(5, 0), rid=0))
        await afe.submit(Request(tokens=_prompt(5, 1), rid=1))
        with pytest.raises(AdmissionError):
            await afe.submit(Request(tokens=_prompt(5, 2), rid=2))
        t0 = afe.clock.now()
        with pytest.raises(AdmissionError):
            await afe.submit_retry(Request(tokens=_prompt(5, 3), rid=3),
                                   retries=2, backoff_s=0.01)
        waited = afe.clock.now() - t0
        afe._drop_pending()
        afe.close()
        return waited

    waited = asyncio.run(go())
    assert waited == pytest.approx(0.01 + 0.02)      # two backoffs, doubled
    assert afe.stats.rejected == 4
