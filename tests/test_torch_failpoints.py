"""The port's failpoints and degradation bookkeeping
(``repro_torch/resilience``) against the reference's.

The unit tests of the reference's ``tests/test_resilience.py`` (failpoint
semantics, breaker, contextvar routing) run on the port, and the two
packages are held to each other: the same spec string gives the same
``report()``, the same seed and ``p`` fire on the same events, and each
package is armed by its own environment variables only.  Then the
durability seams the port shares with the reference (registry load and
flush, miss log, queue file, find-db) under their failpoints.
"""

import json

import pytest

from repro.resilience import failpoints as ref_fp
from repro_torch.resilience import degrade, failpoints
from repro_torch.resilience.failpoints import InjectedFault


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    ref_fp.reset()
    yield
    failpoints.reset()
    ref_fp.reset()


# ---------------------------------------------------------------------------
# failpoint registry semantics (the reference's unit tests, on the port)
# ---------------------------------------------------------------------------


def test_unarmed_is_noop():
    failpoints.fp("nothing.armed")
    assert failpoints.corrupt("nothing.armed", b"data") == b"data"
    assert failpoints.report() == {}


def test_raise_action_and_times_cap():
    failpoints.configure({"a.b": {"action": "raise", "times": 2}})
    fired = 0
    for _ in range(5):
        try:
            failpoints.fp("a.b")
        except InjectedFault:
            fired += 1
    assert fired == 2
    rep = failpoints.report()["a.b"]
    assert rep["fired"] == 2 and rep["hits"] == 5


def test_probability_is_seeded():
    def run(seed):
        failpoints.reset()
        failpoints.configure({"p.site": {"action": "raise", "p": 0.5}},
                             seed=seed)
        out = []
        for _ in range(64):
            try:
                failpoints.fp("p.site")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    a, b, c = run(7), run(7), run(8)
    assert a == b
    assert a != c
    assert 10 < sum(a) < 54


def test_compact_spec_and_json_spec():
    failpoints.configure("x=raise:times=1;y=delay:delay_s=0.25:p=0.5")
    rep = failpoints.report()
    assert rep["x"] == {"action": "raise", "p": 1.0, "times": 1,
                        "hits": 0, "fired": 0}
    assert rep["y"]["action"] == "delay" and rep["y"]["p"] == 0.5
    failpoints.reset()
    failpoints.configure('{"z": {"action": "corrupt", "times": 3}}')
    assert failpoints.report()["z"]["times"] == 3


def test_unknown_action_rejected():
    with pytest.raises(ValueError, match="unknown failpoint action"):
        failpoints.configure({"s": "explode"})
    with pytest.raises(ValueError, match="unknown keys"):
        failpoints.configure({"s": {"action": "raise", "bogus": 1}})


def test_delay_charges_virtual_clock():
    from repro_torch.serve.clock import VirtualClock
    clock = VirtualClock()
    failpoints.configure({"d": {"action": "delay", "delay_s": 0.5}})
    t0 = clock.now()
    failpoints.fp("d", clock=clock)
    assert clock.now() - t0 == pytest.approx(0.5)


def test_corrupt_tears_bytes_and_str():
    failpoints.configure({"c": "corrupt"})
    b = failpoints.corrupt("c", b"0123456789")
    s = failpoints.corrupt("c", "0123456789")
    assert b != b"0123456789" and b.startswith(b"01234")
    assert s != "0123456789" and s.startswith("01234")
    with pytest.raises(InjectedFault):
        failpoints.fp("c")              # corrupt on a control site: raise


def test_env_arming_and_tune_crash_alias(monkeypatch):
    monkeypatch.setenv(failpoints.ENV_CONFIG, "e.site=raise:times=2")
    monkeypatch.setenv(failpoints.ENV_TUNE_CRASH, "after-claim")
    failpoints.reset()
    rep = failpoints.report()
    assert rep["e.site"]["times"] == 2
    assert rep["worker.claim.after"]["action"] == "crash"
    monkeypatch.setenv(failpoints.ENV_TUNE_CRASH, "after-everything")
    failpoints.reset()
    assert "worker.claim.after" not in failpoints.report()


def test_bad_env_config_never_raises(monkeypatch):
    monkeypatch.setenv(failpoints.ENV_CONFIG, "{not json at all")
    failpoints.reset()
    failpoints.fp("anything")
    assert failpoints.report() == {}


# ---------------------------------------------------------------------------
# the two packages held to each other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "x=raise:times=1;y=delay:delay_s=0.25:p=0.5",
    '{"z": {"action": "corrupt", "times": 3}, "w": "crash"}',
    "kernels.lower.skinny=raise;kernels.xla.tall=raise:p=0.25:times=4",
    {"registry.load": "corrupt", "queue.load": {"action": "raise",
                                                "p": 0.75}},
])
def test_same_spec_same_report(spec):
    failpoints.configure(spec)
    ref_fp.configure(spec)
    assert failpoints.report() == ref_fp.report()


@pytest.mark.parametrize("seed,p,times", [(0, 0.5, -1), (7, 0.3, -1),
                                          (11, 0.9, 40)])
def test_same_seed_same_events(seed, p, times):
    """Over 200 checks the same (seed, p, times) fires on the same hits
    in both packages, and both reports agree."""
    site = {"s.site": {"action": "raise", "p": p, "times": times}}

    def events(fp_mod):
        fp_mod.configure(site, seed=seed)
        out = []
        for _ in range(200):
            try:
                fp_mod.fp("s.site")
                out.append(0)
            except fp_mod.InjectedFault:
                out.append(1)
        return out

    ours, theirs = events(failpoints), events(ref_fp)
    assert ours == theirs
    assert 0 < sum(ours) < 200
    assert failpoints.report() == ref_fp.report()


def test_each_package_reads_its_own_environment(monkeypatch):
    monkeypatch.setenv(ref_fp.ENV_CONFIG, "ref.only=raise")
    monkeypatch.setenv(failpoints.ENV_CONFIG, "port.only=raise")
    monkeypatch.setenv(ref_fp.ENV_SEED, "3")
    failpoints.reset()
    ref_fp.reset()
    assert set(failpoints.report()) == {"port.only"}
    assert set(ref_fp.report()) == {"ref.only"}
    assert failpoints.ENV_CONFIG == "REPRO_TORCH_FAILPOINTS"
    assert failpoints.ENV_SEED == "REPRO_TORCH_FAILPOINT_SEED"
    assert failpoints.ENV_TUNE_CRASH == "REPRO_TORCH_TUNE_CRASH"
    assert failpoints.TUNE_CRASH_ALIAS == ref_fp.TUNE_CRASH_ALIAS


# ---------------------------------------------------------------------------
# degradation bookkeeping
# ---------------------------------------------------------------------------


def test_circuit_breaker_opens_and_resets():
    br = degrade.CircuitBreaker(threshold=3)
    assert br.allow("k")
    assert not br.failure("k") and not br.failure("k")
    br.success("k")
    assert not br.failure("k") and not br.failure("k")
    assert br.failure("k")
    assert not br.allow("k")
    assert br.allow("other")
    assert br.report()["open"] == ["k"]


def test_degrade_stats_contextvar_routing():
    mine = degrade.DegradeStats()
    with degrade.use(mine):
        degrade.record("seam.a", key="k1", fallback="fb")
        degrade.record("seam.a")
    degrade.record("seam.b")
    assert mine.counts == {"seam.a": 2}
    rep = mine.report()
    assert rep["total"] == 2 and rep["events"][0]["fallback"] == "fb"
    assert degrade.GLOBAL.counts.get("seam.b", 0) >= 1


def test_capture_sink_counts_nothing_and_reads_the_breaker():
    """A graph capture's second pass over a cell: no counts, no breaker
    updates, the engine's open keys still open."""
    mine = degrade.DegradeStats(breaker_threshold=1)
    assert mine.breaker.failure("open.key")
    cap = mine.capture()
    with degrade.use(cap):
        degrade.record("kernel.variant", key="k")
        assert not degrade.current().breaker.allow("open.key")
        assert degrade.current().breaker.allow("other")
        assert not degrade.current().breaker.failure("other")
    assert mine.total == 0 and cap.total == 0
    assert mine.breaker.allow("other")
    assert mine.breaker.report()["failures"] == {"open.key": 1}


# ---------------------------------------------------------------------------
# durability seams: each degrades, never raises
# ---------------------------------------------------------------------------


def test_registry_load_survives_torn_file(tmp_path):
    from repro_torch.core import registry
    p = tmp_path / "plans.json"
    p.write_text('{"plans": {"x": {"truncated...')
    assert registry._read_json(p) is None
    p.write_text(json.dumps({"a": 1}))
    failpoints.configure({"registry.load": "corrupt"})
    assert registry._read_json(p) is None       # torn on read


def test_registry_flush_defers_on_write_failure(tmp_path):
    from repro_torch.core.autotuner import make_plan
    from repro_torch.core.plan import Problem
    from repro_torch.core.registry import Registry
    reg = Registry(plan_path=tmp_path / "plans.json",
                   measure_path=tmp_path / "measure.json")
    plan = make_plan(Problem(4096, 4096, 16), persist=False, device="cpu")
    failpoints.configure(
        {"registry.flush.before_replace": {"action": "raise"}})
    stats = degrade.DegradeStats()
    with degrade.use(stats):
        reg.put(plan, "cpu", persist=True)
    assert stats.counts.get("registry.flush", 0) >= 1
    assert not (tmp_path / "plans.json").exists()
    assert reg.get(plan.problem.key(), "cpu") is not None
    failpoints.reset()
    with degrade.use(stats):
        reg.flush()
    assert (tmp_path / "plans.json").exists()


def test_measurement_flush_defers_on_write_failure(tmp_path):
    from repro_torch.core.plan import Plan, Problem
    from repro_torch.core.registry import MeasureRecord, Registry
    reg = Registry(plan_path=tmp_path / "plans.json",
                   measure_path=tmp_path / "measure.json")
    plan = Plan(Problem(4096, 4096, 16, "float32"), "tall_a", bm=256, bk=512,
                bn=128)
    reg.record_measurement(MeasureRecord(plan, 1e-4, 3, 0.0), "cpu")
    failpoints.configure({"registry.measure.before_replace": "raise"})
    stats = degrade.DegradeStats()
    with degrade.use(stats):
        reg.flush()
    assert stats.counts == {"registry.flush": 1}
    assert (tmp_path / "plans.json").exists()
    assert not (tmp_path / "measure.json").exists()
    failpoints.reset()
    reg.flush()
    assert (tmp_path / "measure.json").exists()


def test_miss_log_restashes_on_write_failure(tmp_path):
    from repro_torch.core.registry import Registry
    reg = Registry(plan_path=tmp_path / "plans.json",
                   measure_path=tmp_path / "measure.json")
    miss = tmp_path / "misses.json"
    assert reg.get("m4096_k4096_n16_bfloat16_s1", "cpu") is None
    failpoints.configure(
        {"registry.misses.before_replace": {"action": "raise"}})
    stats = degrade.DegradeStats()
    with degrade.use(stats):
        assert reg.flush_misses(miss) == 0
    assert stats.counts.get("registry.misses") == 1
    assert not miss.exists()
    failpoints.reset()
    assert reg.flush_misses(miss) == 1           # nothing was lost
    raw = json.loads(miss.read_text())
    assert list(raw) == ["cpu/m4096_k4096_n16_bfloat16_s1"]
    assert raw["cpu/m4096_k4096_n16_bfloat16_s1"]["count"] == 1


def test_queue_load_quarantines_torn_file(tmp_path):
    from repro_torch.tuning.queue import JobQueue, TuneJob
    qp = tmp_path / "queue.json"
    qp.write_text('{"schema": 1, "jobs": {"a/b": {"problem_')
    q = JobQueue(qp)
    stats = degrade.DegradeStats()
    with degrade.use(stats):
        assert q.jobs() == {}
    assert stats.counts.get("queue.file") == 1
    assert (tmp_path / "queue.json.corrupt").exists()
    q.enqueue([TuneJob(problem_key="m4096_k4096_n16_bfloat16_s1",
                       platform="cpu")])
    assert q.status()["pending"] == 1
    qp.write_text(json.dumps([1, 2, 3]))
    assert q.jobs() == {}


def test_find_db_survives_torn_file(tmp_path):
    from repro_torch.tuning import find_db
    p = tmp_path / "find.json"
    p.write_text('{"schema": "find_db/1", "plans": {"trunc')
    stats = degrade.DegradeStats()
    with degrade.use(stats):
        assert find_db.read_find_db(p, platform="cpu", strict=False) == {}
    assert stats.counts.get("registry.find_db") == 1
    with pytest.raises(ValueError):
        find_db.read_find_db(p, platform="cpu", strict=True)
