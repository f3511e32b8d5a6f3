"""The port's tuning fleet as processes: ``launch/tune_service.py``
workers started as fresh interpreters claim through the real
cross-process lock, a worker killed after its claim (``os._exit``) has
its lease requeued, and a host restarted on an empty plan cache with the
exported find-db serves by lookups only.  The reference's subprocess
cases of ``tests/test_tuning_service.py`` and its lock hammer, ported;
every subprocess runs on the CPU (the kernels' plain versions) under
its own timeout.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.core import registry
from repro_torch.core.plan import Problem
from repro_torch.tuning.queue import JobQueue, harvest

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
P_SKINNY = Problem(2, 512, 512, "float32")
P_TALL = Problem(1024, 512, 128, "float32")
P_TALL2 = Problem(512, 512, 64, "float32")
WORK = ["--device", "cpu", "--iters", "1", "--warmup", "0", "--top-k", "2",
        "--stable", "1", "--build-k", "2"]


@pytest.fixture
def fleet(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json"),
                      ("REPRO_TORCH_TUNE_QUEUE", "queue.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    for var in ("REPRO_TORCH_FIND_DB", "REPRO_TORCH_TUNE_CRASH",
                "REPRO_TORCH_FAILPOINTS"):
        monkeypatch.delenv(var, raising=False)
    registry.clear_memory()
    yield tmp_path
    registry.clear_memory()


def _env(extra=None):
    return {**os.environ, "PYTHONPATH": SRC, **(extra or {})}


def _seed_jobs(problems) -> JobQueue:
    for p in problems:
        registry.get(p.key(), "cpu")
    registry.flush_misses()
    q = JobQueue()
    harvest(q)
    return q


def _workers(n, *, lease_s=600, extra_env=None, timeout=300):
    """``n`` one-worker processes of the CLI; returns (exit codes, their
    ``worker:`` reports)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.tune_service", "work",
           "--workers", "1", "--lease-s", str(lease_s), *WORK]
    procs = [subprocess.Popen(cmd, env=_env(extra_env), cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reps = [json.loads(line[len("worker: "):]) for out in outs
            for line in out.splitlines() if line.startswith("worker: ")]
    return [p.returncode for p in procs], reps


def test_three_workers_resolve_each_job_exactly_once(fleet):
    q = _seed_jobs([P_SKINNY, P_TALL, P_TALL2])
    assert q.status()["pending"] == 3
    rcs, reps = _workers(3)
    assert rcs == [0, 0, 0]
    assert q.status() == {"pending": 0, "leased": 0, "done": 3,
                          "failed": 0, "total": 3}
    jobs = q.jobs()
    for j in jobs.values():
        assert [e[0] for e in j.history].count("done") == 1
    claimed = [r[0] for rep in reps for r in rep["results"]]
    assert sorted(claimed) == sorted(jobs)
    registry.clear_memory()
    for p in (P_SKINNY, P_TALL, P_TALL2):
        plan = registry.peek(p.key(), "cpu")
        assert plan is not None and plan.chosen_by == "measured", p.key()


def test_crashed_worker_lease_is_requeued_and_completed(fleet):
    q = _seed_jobs([P_SKINNY])
    rcs, _ = _workers(1, lease_s=3,
                      extra_env={"REPRO_TORCH_TUNE_CRASH": "after-claim"})
    assert rcs == [17]
    job = next(iter(q.jobs().values()))
    assert job.state == "leased", "the crash left the lease held"
    time.sleep(3.5)                      # let the lease lapse
    rcs, _ = _workers(1)
    assert rcs == [0]
    job = next(iter(q.jobs().values()))
    assert job.state == "done" and job.attempts == 2
    events = [e[0] for e in job.history]
    assert "expire" in events and events.count("done") == 1
    registry.clear_memory()
    assert registry.peek(P_SKINNY.key(), "cpu").chosen_by == "measured"


def test_reference_crash_hook_does_not_arm_the_port(fleet):
    """``REPRO_TUNE_CRASH`` is the reference's: a port worker ignores
    it and completes."""
    q = _seed_jobs([P_TALL2])
    rcs, reps = _workers(1, extra_env={"REPRO_TUNE_CRASH": "after-claim",
                                       "REPRO_FAILPOINTS":
                                       "worker.claim.after=crash"})
    assert rcs == [0] and reps[0]["done"] == 1
    assert q.status()["done"] == 1


O = ["--reduced", "--override",
     "d_model=512,d_ff=1024,num_heads=4,num_kv_heads=4,head_dim=128"]


def _cli(args, env, timeout=300):
    out = subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_fleet_end_to_end_restart_is_lookup_only(fleet):
    """A host without install serves and flushes its misses; harvest,
    ``work --workers 2`` (the CLI starting two interpreters), export; a
    fresh host on an empty plan cache with the find-db serves with 0
    misses and captures nothing on traffic."""
    env = _env()
    serve = ["repro_torch.launch.serve", "--arch", "qwen1_5_4b", *O,
             "--device", "cpu", "--trace", "1,2", "--steps", "2",
             "--prompt-len", "16", "--max-batch", "2"]
    out = _cli(serve, env)
    assert "0 misses" not in out
    misses = json.loads((fleet / "misses.json").read_text())
    assert misses and all(k.startswith("cpu/") for k in misses)
    cli = ["repro_torch.launch.tune_service"]
    out = _cli(cli + ["harvest"], env)
    n = json.loads(out.split("harvest: ", 1)[1].splitlines()[0])["enqueued"]
    assert n == len(misses)
    out = _cli(cli + ["work", "--workers", "2", *WORK], env)
    fleet_line = json.loads(out.split("fleet: ", 1)[1].splitlines()[0])
    assert fleet_line["exit_codes"] == [0, 0]
    assert fleet_line["done"] == n and fleet_line["total"] == n
    reps = [json.loads(line[len("worker: "):]) for line in out.splitlines()
            if line.startswith("worker: ")]
    assert sum(r["done"] for r in reps) == n
    fdb = fleet / "find_db.json"
    out = _cli(cli + ["export", "--out", str(fdb)], env)
    assert json.loads(out.split("find-db: ", 1)[1])["plan_count"] >= n
    out = _cli(cli + ["status"], env)
    assert f'"done": {n}' in out
    host2 = _env({"REPRO_TORCH_PLAN_CACHE": str(fleet / "h2" / "p.json")})
    out = _cli(serve + ["--find-db", str(fdb), "--precompile",
                        "--require-warm", "--health"], host2)
    assert " 0 misses" in out
    assert "0 acquired cold by traffic" in out


_HAMMER = r"""
import sys, time
from pathlib import Path
from repro_torch.tuning.queue import _FileLock
lock_path, counter, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
for _ in range(n):
    with _FileLock(Path(lock_path), timeout_s=30.0, stale_s=0.4):
        v = int(Path(counter).read_text())
        time.sleep(0.002)                 # widen the race window
        Path(counter).write_text(str(v + 1))
print("ok")
"""


def test_two_process_lock_hammer_with_stale_breaks(tmp_path):
    """Two processes increment a counter under the lock while the stale
    threshold (0.4 s) lets breaks really happen: a lost increment would
    mean two holders at once."""
    lock_dir = tmp_path / "c.lock"
    counter = tmp_path / "counter"
    counter.write_text("0")
    lock_dir.mkdir()                     # a crashed holder's stale lock
    old = time.time() - 3600
    os.utime(lock_dir, (old, old))
    n = 25
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HAMMER, str(lock_dir), str(counter), str(n)],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert int(counter.read_text()) == 2 * n
