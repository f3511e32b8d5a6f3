"""The port's fleet tuning service (``repro_torch/tuning``) against the
reference's, in one process: the miss log, ``harvest`` and the job
queue's claim/lease semantics, the builder and evaluator workers on the
CPU (the kernels' plain versions), the find-db artifact and its registry
overlay, and the kernel-library bundle.  The reference's
``tests/test_tuning_service.py`` cases, ported; a miss log written by the
reference's registry must give the port's ``harvest`` the same problem
keys and priorities as the reference's.  The subprocess fleet is in
``tests/test_torch_fleet_procs.py``.
"""

import dataclasses
import json
import os
import stat
import time

import pytest

from repro.core import registry as ref_registry
from repro.core.plan import Problem as RefProblem
from repro.tuning.queue import JobQueue as RefJobQueue
from repro.tuning.queue import harvest as ref_harvest
from repro_torch.core import registry
from repro_torch.core.plan import Plan, Problem
from repro_torch.kernels import cuda
from repro_torch.tuning.find_db import (export_find_db, export_program_bundle,
                                        read_find_db, verify_program_bundle)
from repro_torch.tuning.queue import JobQueue, TuneJob, harvest

# cheap TSMM problems (k >= 512, one dim <= 256, ratio >= 8)
P_SKINNY = Problem(2, 512, 512, "float32")
P_TALL = Problem(1024, 512, 128, "float32")
P_TALL2 = Problem(512, 512, 64, "float32")


@pytest.fixture
def fleet(tmp_path, monkeypatch):
    """One shared fleet directory: plan/measure caches, miss log, queue."""
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json"),
                      ("REPRO_TORCH_TUNE_QUEUE", "queue.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    monkeypatch.delenv("REPRO_TORCH_FIND_DB", raising=False)
    monkeypatch.delenv("REPRO_TORCH_TUNE_CRASH", raising=False)
    registry.clear_memory()
    yield tmp_path
    registry.clear_memory()


def _miss(problem: Problem, times: int = 1) -> None:
    for _ in range(times):
        registry.get(problem.key(), "cpu")


# -- deduped miss records ------------------------------------------------


def test_miss_records_dedupe_and_count(fleet):
    _miss(P_SKINNY, 3)
    _miss(P_TALL)
    recs = registry.miss_records()
    assert [r["key"] for r in recs] == [P_SKINNY.key(), P_TALL.key()]
    assert recs[0]["count"] == 3 and recs[1]["count"] == 1
    assert recs[0]["last_seen"] > 0
    assert len(registry.miss_records()) == 2
    assert len(registry.drain_miss_records()) == 2
    assert registry.drain_miss_records() == []
    assert registry.drain_misses() == []


def test_flush_misses_merges_counts_across_flushes(fleet):
    _miss(P_SKINNY, 2)
    assert registry.flush_misses() == 1
    _miss(P_SKINNY)
    _miss(P_TALL)
    registry.flush_misses()
    raw = json.loads((fleet / "misses.json").read_text())
    assert raw[f"cpu/{P_SKINNY.key()}"]["count"] == 3
    assert len(raw) == 2
    before = (fleet / "misses.json").stat().st_mtime_ns
    assert registry.flush_misses() == 0
    assert (fleet / "misses.json").stat().st_mtime_ns == before


# -- harvest + queue semantics -------------------------------------------


def test_harvest_dedupes_ranks_and_consumes(fleet):
    _miss(P_SKINNY, 5)
    _miss(P_TALL)
    registry.flush_misses()
    q = JobQueue()
    counts = harvest(q)
    assert counts["enqueued"] == 2 and counts["skipped"] == 0
    assert not (fleet / "misses.json").exists(), "harvest consumes the log"
    jobs = q.jobs()
    assert len(jobs) == 2
    hot = jobs[f"cpu/{P_SKINNY.key()}"]
    assert hot.priority == 5
    assert hot.candidates and hot.grammar_version
    first = q.claim("w0", device="cpu")
    assert first.problem_key == P_SKINNY.key()
    _miss(P_TALL, 4)
    registry.flush_misses()
    counts = harvest(q)
    assert counts["merged"] == 1
    assert q.jobs()[f"cpu/{P_TALL.key()}"].priority == 5


def test_harvest_skips_done_jobs(fleet):
    _miss(P_SKINNY)
    registry.flush_misses()
    q = JobQueue()
    harvest(q)
    j = q.claim("w0", device="cpu")
    assert q.complete(j.job_id, "w0", result="winner")
    _miss(P_SKINNY)
    registry.flush_misses()
    counts = harvest(q)
    assert counts["already_done"] == 1 and counts["enqueued"] == 0
    assert q.status()["done"] == 1 and q.status()["total"] == 1


def test_claims_are_exclusive_and_platform_filtered(fleet):
    h100 = "NVIDIA H100 80GB HBM3"
    q = JobQueue()
    q.enqueue([TuneJob(P_SKINNY.key(), "cpu"),
               TuneJob(P_TALL.key(), "cpu"),
               TuneJob(P_TALL2.key(), h100)])
    a = q.claim("wa", device="cpu")
    b = q.claim("wb", platform="cpu")
    assert a.job_id != b.job_id
    assert q.claim("wc", device="cpu") is None, "no third cpu job"
    assert q.claim("wt", platform=h100).problem_key == P_TALL2.key()


def test_lease_expiry_requeues_then_parks(fleet):
    now = [1000.0]
    q = JobQueue(clock=lambda: now[0], max_attempts=2)
    q.enqueue([TuneJob(P_SKINNY.key(), "cpu")])
    j1 = q.claim("crasher", lease_s=10, platform="cpu")
    assert j1.attempts == 1
    assert q.claim("w2", platform="cpu") is None
    now[0] += 11
    j2 = q.claim("w2", lease_s=10, platform="cpu")
    assert j2 is not None and j2.attempts == 2
    assert ("expire", "crasher") in {(e[0], e[1]) for e in j2.history}
    now[0] += 11
    assert q.claim("w3", platform="cpu") is None
    job = q.jobs()[j2.job_id]
    assert job.state == "failed" and "lease expired" in job.error
    q.enqueue([TuneJob(P_SKINNY.key(), "cpu", priority=2)])
    revived = q.claim("w3", platform="cpu")
    assert revived is not None and revived.attempts == 1


def test_complete_rejected_after_lease_reassignment(fleet):
    now = [0.0]
    q = JobQueue(clock=lambda: now[0])
    q.enqueue([TuneJob(P_SKINNY.key(), "cpu")])
    j = q.claim("slow", lease_s=5, platform="cpu")
    now[0] += 6
    j2 = q.claim("fast", lease_s=5, platform="cpu")
    assert j2.job_id == j.job_id
    assert not q.complete(j.job_id, "slow", result="stale")
    assert q.complete(j2.job_id, "fast", result="fresh")
    assert q.jobs()[j.job_id].result == "fresh"
    assert len([e for e in q.jobs()[j.job_id].history if e[0] == "done"]) == 1


def test_queue_fail_releases_for_retry(fleet):
    q = JobQueue()
    q.enqueue([TuneJob(P_SKINNY.key(), "cpu")])
    j = q.claim("w0", platform="cpu")
    assert q.fail(j.job_id, "w0", error="flaky measure")
    job = q.jobs()[j.job_id]
    assert job.state == "pending" and job.error == "flaky measure"
    assert q.claim("w1", platform="cpu").attempts == 2


def test_expire_stale_drops_only_quiet_pending(fleet):
    now = [1000.0]
    q = JobQueue(clock=lambda: now[0])
    q.enqueue([TuneJob(problem_key="m4096_k4096_n16_bfloat16_s1",
                       platform="cpu", last_seen=100.0),
               TuneJob(problem_key="m4096_k4096_n32_bfloat16_s1",
                       platform="cpu", last_seen=990.0)])
    leased = q.claim("w", lease_s=60.0, platform="cpu")
    assert leased is not None
    assert q.expire_stale(max_age_s=500.0) == (
        1 if leased.problem_key.endswith("n32_bfloat16_s1") else 0)
    assert any(j.state == "leased" for j in q.jobs().values())


def test_harvest_expire_after(fleet):
    now = [5000.0]
    q = JobQueue(fleet / "q.json", clock=lambda: now[0])
    q.enqueue([TuneJob(problem_key="m8192_k4096_n16_bfloat16_s1",
                       platform="cpu", last_seen=10.0)])
    miss = fleet / "m.json"
    miss.write_text(json.dumps({
        "cpu/m4096_k4096_n16_bfloat16_s1": {"count": 3,
                                            "last_seen": 4999.0}}))
    counts = harvest(q, miss_path=miss, top_candidates=2,
                     expire_after_s=600.0)
    assert counts["harvested"] == 1 and counts["expired"] == 1
    assert {j.problem_key for j in q.jobs().values()} == {
        "m4096_k4096_n16_bfloat16_s1"}


@pytest.mark.parametrize("counts", [(5, 1, 3), (1, 1, 1), (2, 7, 4)])
def test_reference_miss_log_harvests_alike(fleet, monkeypatch, counts):
    """A miss log written by the reference's registry gives the port's
    harvest the reference's problem keys and priorities."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(fleet / "ref_plans.json"))
    monkeypatch.setenv("REPRO_MISS_LOG", str(fleet / "ref_misses.json"))
    ref_registry.clear_memory()
    try:
        for p, n in zip((P_SKINNY, P_TALL, P_TALL2), counts):
            for _ in range(n):
                ref_registry.get(RefProblem(p.m, p.k, p.n, p.dtype).key())
        assert ref_registry.flush_misses() == 3
    finally:
        ref_registry.clear_memory()
    log = fleet / "ref_misses.json"
    copy = fleet / "copy.json"
    copy.write_text(log.read_text())
    ours = harvest(JobQueue(fleet / "ours.json"), miss_path=log)
    theirs = ref_harvest(RefJobQueue(fleet / "theirs.json"), miss_path=copy)
    assert ours["enqueued"] == theirs["enqueued"] == 3
    mine = {(j.platform, j.problem_key, j.priority)
            for j in JobQueue(fleet / "ours.json").jobs().values()}
    ref = {(j.platform, j.problem_key, j.priority)
           for j in RefJobQueue(fleet / "theirs.json").jobs().values()}
    assert mine == ref
    assert {p for p, _, _ in mine} == {"cpu"}


# -- file lock -------------------------------------------------------------


def test_stale_break_is_exclusive(tmp_path):
    from repro_torch.tuning.queue import _FileLock
    lock_dir = tmp_path / "q.lock"
    lock_dir.mkdir()
    old = time.time() - 3600
    os.utime(lock_dir, (old, old))
    a = _FileLock(lock_dir, timeout_s=1.0, stale_s=30.0)
    b = _FileLock(lock_dir, timeout_s=0.2, stale_s=30.0)
    a.__enter__()
    assert (lock_dir / "owner").read_text() == a.token
    with pytest.raises(TimeoutError):
        b.__enter__()
    a.__exit__(None, None, None)
    with b:
        assert (lock_dir / "owner").read_text() == b.token
    assert not lock_dir.exists()


def test_exit_does_not_remove_foreign_lock(tmp_path):
    from repro_torch.tuning.queue import _FileLock
    lock_dir = tmp_path / "q.lock"
    a = _FileLock(lock_dir, timeout_s=1.0)
    b = _FileLock(lock_dir, timeout_s=1.0)
    with a:
        b.__exit__(None, None, None)
        assert lock_dir.exists()
        assert (lock_dir / "owner").read_text() == a.token
    assert not lock_dir.exists()


# -- builder / evaluator workers -------------------------------------------


def test_builder_builds_payload_candidates(fleet):
    from repro_torch.tuning.worker import Builder
    _miss(P_SKINNY)
    registry.flush_misses()
    q = JobQueue()
    harvest(q)
    job = q.claim("w0", device="cpu")
    built = Builder(build_k=3, device="cpu").build(job)
    assert len(built) == 3
    ok = [b for b in built if b.ok]
    assert ok, "no candidate launched"
    payload = set(job.candidates)
    for b in ok:
        assert b.plan.tuning_key() in payload or b.plan.chosen_by == "model"
        assert b.build_s >= 0


def test_builder_prunes_a_refused_plan(fleet, monkeypatch):
    """A plan whose launch is refused is pruned by the builder, with its
    error, and the others survive."""
    from repro_torch.core import evaluator
    from repro_torch.kernels import tsmm as K
    from repro_torch.tuning.worker import Builder
    _miss(P_TALL)
    registry.flush_misses()
    q = JobQueue()
    harvest(q)
    job = q.claim("w0", device="cpu")
    builder = Builder(build_k=4, device="cpu")
    bad = builder.shortlist(job)[0].tuning_key()
    real = evaluator.build_callable

    def refusing(plan, device="cuda", **kw):
        if plan.tuning_key() == bad:
            raise K.LaunchRefused("tall plan: refused")
        return real(plan, device, **kw)

    monkeypatch.setattr(evaluator, "build_callable", refusing)
    built = builder.build(job)
    assert [b.ok for b in built] == [False] + [True] * (len(built) - 1)
    assert "LaunchRefused" in built[0].error


@pytest.mark.parametrize("error", [cuda.KernelBuildError,
                                   cuda.KernelLaunchError])
def test_builder_raises_the_cards_errors(fleet, monkeypatch, error):
    """A library that did not build, or an error after an enqueue, is no
    plan's failure: the builder raises it instead of pruning."""
    from repro_torch.core import evaluator
    from repro_torch.tuning.worker import Builder
    _miss(P_TALL)
    registry.flush_misses()
    q = JobQueue()
    harvest(q)
    job = q.claim("w0", device="cpu")

    def broken(plan, device="cuda", **kw):
        raise error("the card's error")

    monkeypatch.setattr(evaluator, "build_callable", broken)
    with pytest.raises(error, match="the card's error"):
        Builder(build_k=2, device="cpu").build(job)


def test_worker_releases_and_stops_on_a_cards_error(fleet, monkeypatch):
    """The worker releases the job it holds (back to pending, the attempt
    counted) and raises, claiming nothing more: the context may be
    poisoned, and failing every later job would spend the fleet's
    attempts."""
    from repro_torch.core import evaluator
    from repro_torch.tuning.worker import run_worker
    _miss(P_SKINNY)
    _miss(P_TALL2)
    registry.flush_misses()
    q = JobQueue()
    harvest(q)

    def broken(plan, device="cuda", **kw):
        raise cuda.KernelLaunchError("tsmm_tall_a: illegal address")

    monkeypatch.setattr(evaluator, "build_callable", broken)
    with pytest.raises(cuda.KernelLaunchError, match="illegal address"):
        run_worker(q, worker_id="w", device="cpu", iters=1, warmup=0,
                   build_k=2)
    assert q.status() == {"pending": 2, "leased": 0, "done": 0,
                          "failed": 0, "total": 2}
    jobs = list(q.jobs().values())
    assert sorted(j.attempts for j in jobs) == [0, 1]
    failed = [j for j in jobs if j.attempts][0]
    assert "KernelLaunchError" in failed.error
    assert [h[0] for h in failed.history][-1] == "fail"


def test_worker_in_process_drains_queue(fleet):
    from repro_torch.tuning.worker import run_worker
    _miss(P_SKINNY)
    _miss(P_TALL2)
    registry.flush_misses()
    q = JobQueue()
    harvest(q)
    rep = run_worker(q, device="cpu", iters=1, warmup=0, top_k=2, stable=1,
                     build_k=2)
    assert rep.done == 2 and rep.failed == 0
    assert q.status() == {"pending": 0, "leased": 0, "done": 2,
                          "failed": 0, "total": 2}
    for p in (P_SKINNY, P_TALL2):
        plan = registry.peek(p.key(), "cpu")
        assert plan is not None and plan.chosen_by == "measured"
    for j in q.jobs().values():
        assert j.result == registry.peek(j.problem_key, "cpu").tuning_key()
    # the winners and their records were flushed for the fleet
    registry.clear_memory()
    assert registry.peek(P_SKINNY.key(), "cpu").chosen_by == "measured"
    assert registry.measurements("cpu", P_SKINNY.key())


class _FlakyQueue:
    def __init__(self, failures):
        self.failures = failures
        self.claims = 0

    def claim(self, *a, **k):
        self.claims += 1
        if self.failures > 0:
            self.failures -= 1
            raise TimeoutError("injected lock timeout")
        return None


def test_worker_retries_transient_claim_failures():
    from repro_torch.tuning.worker import run_worker
    q = _FlakyQueue(failures=2)
    report = run_worker(q, worker_id="w", poll_s=0.0, device="cpu")
    assert q.claims == 3
    assert report.done == 0 and report.failed == 0


def test_worker_gives_up_after_retry_budget():
    from repro_torch.tuning.worker import CLAIM_RETRIES, run_worker
    q = _FlakyQueue(failures=99)
    report = run_worker(q, worker_id="w", poll_s=0.0, device="cpu")
    assert q.claims == CLAIM_RETRIES + 1
    assert report.done == 0 and report.failed == 0


def test_background_tuner_defers_fleet_owned_misses(fleet, monkeypatch):
    from repro_torch.core import autotuner
    from repro_torch.serve.engine import _BackgroundTuner

    q = JobQueue()
    q.enqueue([TuneJob(P_SKINNY.key(), "cpu")])
    tuned = []
    monkeypatch.setattr(autotuner, "make_plan",
                        lambda problem, *a, **kw: tuned.append(problem.key())
                        or Plan(problem, "tall_a", bm=8, bk=128, bn=128))
    tuner = _BackgroundTuner(queue=q, device="cpu")
    tuner.submit([P_SKINNY.key(), P_TALL.key()])
    tuner.join(timeout=60)
    assert not tuner.busy()
    assert tuned == [P_TALL.key()], \
        "a fleet-owned miss must not be measured by the engine's tuner"


# -- find-db artifact --------------------------------------------------------


def _measured_plan(problem: Problem) -> Plan:
    return dataclasses.replace(
        Plan(problem, "tall_a" if problem.skinny_dim == "n" else "skinny_a",
             bm=min(problem.m, 256), bk=512, bn=128),
        chosen_by="measured", score=1e-4)


def test_find_db_round_trips_and_is_read_only(fleet):
    registry.put(_measured_plan(P_TALL), "cpu")
    registry.put(_measured_plan(P_SKINNY), "cpu")
    out = fleet / "find_db.json"
    header = export_find_db(out)
    assert header["plan_count"] == 2
    assert header["grammar_version"]
    assert header["platforms"]["cpu"].startswith("cpu|cpu|torch=")
    assert not (out.stat().st_mode & stat.S_IWUSR), "artifact is read-only"
    plans = read_find_db(out, device="cpu")
    assert plans[P_TALL.key()] == registry.peek(P_TALL.key(), "cpu")
    assert plans[P_SKINNY.key()] == registry.peek(P_SKINNY.key(), "cpu")
    registry.put(Plan(P_TALL2, "tall_a", bm=256, bk=512, bn=128), "cpu")
    h2 = export_find_db(fleet / "fdb2.json", measured_only=True)
    assert h2["plan_count"] == 2
    export_find_db(out)                  # re-export over a read-only file


def test_find_db_rejects_stale_grammar(fleet):
    registry.put(_measured_plan(P_TALL), "cpu")
    out = fleet / "find_db.json"
    export_find_db(out)
    blob = json.loads(out.read_text())
    blob["header"]["grammar_version"] = "gen-0-ancient"
    out.chmod(0o644)
    out.write_text(json.dumps(blob))
    assert read_find_db(out, device="cpu") == {}
    with pytest.raises(ValueError, match="grammar"):
        read_find_db(out, device="cpu", strict=True)
    from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION
    blob["header"]["grammar_version"] = GRAMMAR_VERSION
    out.write_text(json.dumps(blob))
    h100 = "NVIDIA H100 80GB HBM3"
    assert read_find_db(out, platform=h100) == {}
    with pytest.raises(ValueError, match="platform"):
        read_find_db(out, platform=h100, strict=True)


def test_registry_overlays_find_db_with_local_precedence(fleet,
                                                         monkeypatch):
    registry.put(_measured_plan(P_TALL), "cpu")
    registry.put(_measured_plan(P_SKINNY), "cpu")
    out = fleet / "find_db.json"
    export_find_db(out)
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE",
                       str(fleet / "host2_plans.json"))
    monkeypatch.setenv("REPRO_TORCH_FIND_DB", str(out))
    registry.clear_memory()
    assert registry.get(P_TALL.key(), "cpu") is not None
    assert registry.get(P_SKINNY.key(), "cpu") is not None
    assert registry.stats() == {"hits": 2, "misses": 0}
    assert registry.miss_records() == []
    local = dataclasses.replace(_measured_plan(P_TALL), bk=128)
    registry.put(local, "cpu")
    registry.clear_memory()
    assert registry.get(P_TALL.key(), "cpu").bk == 128, \
        "the find-db must not displace a newer local plan"


def test_find_db_is_read_with_the_plan_file_or_attached(fleet,
                                                       monkeypatch):
    """The registry reads ``REPRO_TORCH_FIND_DB`` once, with the plan
    file (not on every lookup); ``find_db.attach`` overlays an artifact
    from the next lookup on."""
    from repro_torch.tuning import find_db
    registry.put(_measured_plan(P_TALL), "cpu")
    out = fleet / "find_db.json"
    export_find_db(out)
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE",
                       str(fleet / "host2_plans.json"))
    registry.clear_memory()
    assert registry.get(P_SKINNY.key(), "cpu") is None   # the file is read
    monkeypatch.setenv("REPRO_TORCH_FIND_DB", str(out))
    assert registry.get(P_TALL.key(), "cpu") is None, \
        "the environment is read once, with the plan file"
    registry.clear_memory()
    assert registry.get(P_TALL.key(), "cpu") is not None
    monkeypatch.setenv("REPRO_TORCH_FIND_DB", "")
    registry.clear_memory()
    assert registry.get(P_TALL.key(), "cpu") is None
    find_db.attach(out)
    assert os.environ["REPRO_TORCH_FIND_DB"] == str(out)
    assert registry.get(P_TALL.key(), "cpu") is not None


def test_kernel_bundle_manifest_round_trip(fleet):
    src = fleet / cuda._build_dir().name
    src.mkdir()
    (src / "libtsmm_skinny.so").write_bytes(b"x" * 64)
    (src / "libtsmm_tall.so").write_bytes(b"y" * 64)
    (src / ".libpack_blocks.123.so").write_bytes(b"a build in progress")
    (src / "ignored.txt").write_text("not a library")
    bundle = fleet / "bundle"
    manifest = export_program_bundle(bundle, src_dir=src)
    assert sorted(manifest["files"]) == ["libtsmm_skinny.so",
                                         "libtsmm_tall.so"]
    assert manifest["build_dir"] == cuda._build_dir().name
    res = verify_program_bundle(bundle)
    assert res["ok"] and res["checked"] == 2
    (bundle / "libtsmm_tall.so").write_bytes(b"tampered")
    res = verify_program_bundle(bundle)
    assert not res["ok"]
    assert any("digest mismatch" in p for p in res["problems"])
    other = fleet / "kernels-0000000000000000"
    other.mkdir()
    (other / "libtsmm_tall.so").write_bytes(b"z")
    export_program_bundle(fleet / "b2", src_dir=other)
    res = verify_program_bundle(fleet / "b2")
    assert not res["ok"] and "other sources" in res["problems"][0]
