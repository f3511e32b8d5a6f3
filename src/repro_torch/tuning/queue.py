"""Miss-fed tuning job queue — the fleet service's work ledger
(DESIGN.md §15), the port of the reference package's ``tuning/queue.py``.

A :class:`TuneJob` is one (platform, problem, grammar-candidate-set)
record: the unit of fleet tuning work.  Jobs are derived from the
engines' persisted registry miss logs by :func:`harvest` — one job per
DISTINCT problem, prioritized by miss count, so the hottest misses are
measured first — and carry the model-ranked grammar candidate tuning
keys as payload (the TVM-generator framing: the synthesis grammar's
points ARE the job, arxiv 2310.20347).

The :class:`JobQueue` is a single JSON file with the registry's
load-merge-replace discipline plus one addition the registry does not
need: **claims must be mutually exclusive across processes**, so every
read-modify-write runs under a ``mkdir``-based lock (atomic on POSIX,
stale locks from crashed holders are broken after ``stale_lock_s``).
Lease semantics make a crashed worker harmless: a claim holds the job
for ``lease_s`` seconds; an expired lease is requeued (``attempts`` + 1)
on the next claim/requeue pass, and a job over ``max_attempts`` parks as
``failed`` instead of looping forever.  A late ``complete`` from a
worker whose lease was reassigned is rejected — the lease holder of
record is the only writer of a job's terminal state.

A job's platform is the registry's (``core/registry.py::platform``): the
card's name, e.g. ``NVIDIA H100 80GB HBM3``, or ``cpu``.  A worker claims
only its own device's jobs, so a CPU worker never takes a card's job.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import socket
import tempfile
import time
import uuid
from pathlib import Path
from typing import Callable, Iterable, Optional

from repro_torch.resilience import degrade, failpoints

log = logging.getLogger(__name__)

QUEUE_SCHEMA = 1
DEFAULT_LEASE_S = 120.0
DEFAULT_MAX_ATTEMPTS = 3
# candidate tuning keys stored per job: enough for a builder short-list
# plus headroom, small enough that the queue file stays human-readable
DEFAULT_TOP_CANDIDATES = 16


def queue_path() -> Path:
    """``REPRO_TORCH_TUNE_QUEUE`` or a sibling of the plan cache — the
    queue rides the same shared filesystem the registry already
    assumes."""
    p = os.environ.get("REPRO_TORCH_TUNE_QUEUE")
    if p:
        return Path(p)
    from repro_torch.core.registry import cache_path
    return cache_path().with_name("tune_queue.json")


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


def _default_platform(device) -> str:
    from repro_torch.core.registry import platform
    return platform(device)


@dataclasses.dataclass
class TuneJob:
    """One unit of fleet tuning work.

    ``candidates`` are the harvest-time model-ranked tuning keys of the
    grammar points worth building (payload, not contract: a builder
    whose grammar version differs re-enumerates fresh).  ``priority`` is
    the summed miss count — hot misses claim first.  ``history`` is the
    append-only audit trail ((event, worker, time) tuples) the fleet
    tests assert exactly-once semantics on."""

    problem_key: str
    platform: str
    candidates: tuple = ()
    grammar_version: str = ""
    priority: int = 1
    last_seen: float = 0.0
    state: str = "pending"      # pending | leased | done | failed
    attempts: int = 0
    worker: str = ""            # current lease holder
    lease_expiry: float = 0.0
    result: str = ""            # winning tuning_key once done
    error: str = ""
    history: tuple = ()

    @property
    def job_id(self) -> str:
        return f"{self.platform}/{self.problem_key}"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidates"] = list(self.candidates)
        d["history"] = [list(h) for h in self.history]
        return d

    @staticmethod
    def from_json(d: dict) -> "TuneJob":
        d = dict(d)
        d["candidates"] = tuple(d.get("candidates", ()))
        d["history"] = tuple(tuple(h) for h in d.get("history", ()))
        return TuneJob(**d)


class _FileLock:
    """Cross-process mutex via atomic ``mkdir`` (the portable primitive
    that works on the same NFS-ish filesystems the registry's atomic
    replace assumes).  A lock directory older than ``stale_s`` belongs
    to a crashed holder and is broken — claims must never deadlock on a
    worker that died mid-mutation.

    Ownership is a unique token file inside the lock directory.  The old
    break path (unlink owner + rmdir) let TWO breakers both "succeed":
    breaker A removes the stale dir and re-creates it as its own lock,
    then breaker B — still acting on its stale read — removes A's FRESH
    lock, and a third process walks into A's critical section.  Two
    rules close the race:

    * a stale lock is broken by ``rename`` to a unique trash name —
      rename is atomic, so exactly one breaker wins and the losers see
      FileNotFoundError and go back to the mkdir race;
    * after ``mkdir`` succeeds the holder writes its token and RE-READS
      it; release (and any future break) only removes a directory whose
      token file still matches — a holder whose lock was stolen retries
      instead of deleting the thief's lock."""

    def __init__(self, path: Path, *, timeout_s: float = 10.0,
                 stale_s: float = 30.0):
        self.path = path
        self.timeout_s = timeout_s
        self.stale_s = stale_s
        self.token = (f"{socket.gethostname()}:{os.getpid()}:"
                      f"{uuid.uuid4().hex}")

    def _owner(self) -> Optional[str]:
        try:
            return (self.path / "owner").read_text()
        except OSError:
            return None

    def __enter__(self):
        deadline = time.monotonic() + self.timeout_s
        while True:
            failpoints.fp("queue.lock.acquire")
            try:
                os.mkdir(self.path)
            except FileExistsError:
                try:
                    age = time.time() - self.path.stat().st_mtime
                except OSError:
                    continue            # released between check and stat
                if age > self.stale_s:
                    self._break_stale(age)
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"queue lock {self.path} held for > "
                        f"{self.timeout_s}s (stale_s={self.stale_s})")
                time.sleep(0.005)
            else:
                try:
                    (self.path / "owner").write_text(self.token)
                except OSError:
                    pass
                # re-verify: a racing breaker with a stale view may have
                # renamed our fresh dir away between mkdir and the token
                # write — if the token on disk is not ours, we hold
                # nothing and must retry, never proceed
                if self._owner() == self.token:
                    return self
                time.sleep(0.001)

    def _break_stale(self, age: float) -> None:
        trash = self.path.with_name(
            self.path.name + f".stale.{os.getpid()}.{uuid.uuid4().hex}")
        try:
            os.rename(self.path, trash)  # atomic: one breaker wins
        except OSError:
            return                       # lost the race (or released)
        # re-verify on the instance we actually captured: our pre-rename
        # stat may have been a stale view of a lock that was broken and
        # re-created fresh in the meantime — give a misfired steal back
        try:
            fresh = time.time() - trash.stat().st_mtime <= self.stale_s
        except OSError:
            fresh = False
        if fresh:
            try:
                os.rename(trash, self.path)
                return
            except OSError:
                pass                     # name re-taken: trash it below
        else:
            log.warning("broke stale queue lock %s (%.0fs old)",
                        self.path, age)
        shutil.rmtree(trash, ignore_errors=True)

    def __exit__(self, *exc):
        if self._owner() != self.token:
            return                       # stolen while we slept: not ours
        try:
            (self.path / "owner").unlink()
        except OSError:
            pass
        try:
            os.rmdir(self.path)
        except OSError:
            pass


class JobQueue:
    """File-backed tuning job queue with atomic claim/lease/requeue.

    Every operation is one locked load -> mutate -> atomic-replace round
    trip: the queue file is the single source of truth and two processes
    can never interleave a claim.  ``clock`` is injectable so lease
    expiry is testable without sleeping."""

    def __init__(self, path=None, *, clock: Callable[[], float] = time.time,
                 lock_timeout_s: float = 10.0, stale_lock_s: float = 30.0,
                 max_attempts: int = DEFAULT_MAX_ATTEMPTS):
        self._path = Path(path) if path else None
        self.clock = clock
        self.lock_timeout_s = lock_timeout_s
        self.stale_lock_s = stale_lock_s
        self.max_attempts = max_attempts

    def path(self) -> Path:
        return self._path if self._path is not None else queue_path()

    # -- file plumbing ---------------------------------------------------

    def _lock(self) -> _FileLock:
        p = self.path()
        return _FileLock(p.with_name(p.name + ".lock"),
                         timeout_s=self.lock_timeout_s,
                         stale_s=self.stale_lock_s)

    def _quarantine(self, path: Path, why) -> None:
        """A torn/corrupt queue file never raises into callers and never
        gets silently clobbered either: it is renamed aside (forensics)
        with a warning, and the queue restarts empty — jobs are re-derived
        from the next harvest, so the loss is re-measured work, not
        correctness (DESIGN.md §16)."""
        side = path.with_name(path.name + ".corrupt")
        try:
            os.replace(path, side)
        except OSError:
            side = None
        log.warning("queue: unreadable %s (%s); %s", path, why,
                    f"quarantined to {side}" if side else "starting empty")
        degrade.record("queue.file", key=str(path), fallback="reset",
                       error=str(why))

    def _load(self) -> dict:
        path = self.path()
        if not path.exists():
            return {}
        try:
            failpoints.fp("queue.load")
            raw = json.loads(failpoints.corrupt("queue.load",
                                                path.read_text()))
        except (OSError, json.JSONDecodeError,
                failpoints.InjectedFault) as e:
            self._quarantine(path, e)
            return {}
        if not isinstance(raw, dict) or raw.get("schema") != QUEUE_SCHEMA:
            got = raw.get("schema") if isinstance(raw, dict) \
                else type(raw).__name__
            self._quarantine(path, f"schema {got!r} != {QUEUE_SCHEMA}")
            return {}
        jobs = {}
        for k, v in raw.get("jobs", {}).items():
            try:
                jobs[k] = TuneJob.from_json(v)
            except (TypeError, KeyError):
                continue                # corrupt entry never poisons a load
        return jobs

    def _write(self, jobs: dict) -> None:
        path = self.path()
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = {"schema": QUEUE_SCHEMA,
                "jobs": {k: j.to_json() for k, j in jobs.items()}}
        failpoints.fp("queue.replace.before")
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _mutate(self, fn):
        """The one concurrency primitive: fn(jobs) mutates in place under
        the cross-process lock; the whole map is rewritten atomically."""
        with self._lock():
            jobs = self._load()
            out = fn(jobs)
            self._write(jobs)
            return out

    # -- lifecycle -------------------------------------------------------

    def enqueue(self, new_jobs: Iterable[TuneJob]) -> dict:
        """Insert-or-merge jobs.  Per job_id: a missing job is added; a
        ``done`` job is skipped (the fleet already measured it); a live
        job absorbs the fresh misses (priorities sum — each harvest
        carries only misses since the last flush, so summation is the
        true total); a ``failed`` job is revived by fresh demand."""
        new_jobs = list(new_jobs)

        def fn(jobs: dict) -> dict:
            now = self.clock()
            counts = {"enqueued": 0, "merged": 0, "already_done": 0,
                      "revived": 0}
            for nj in new_jobs:
                cur = jobs.get(nj.job_id)
                if cur is None:
                    jobs[nj.job_id] = dataclasses.replace(
                        nj, state="pending",
                        history=nj.history + (("enqueue", "", now),))
                    counts["enqueued"] += 1
                elif cur.state == "done":
                    counts["already_done"] += 1
                else:
                    revived = cur.state == "failed"
                    cands, gv = cur.candidates, cur.grammar_version
                    if nj.grammar_version and nj.grammar_version != gv:
                        cands, gv = nj.candidates, nj.grammar_version
                    jobs[nj.job_id] = dataclasses.replace(
                        cur,
                        state="pending" if revived else cur.state,
                        attempts=0 if revived else cur.attempts,
                        error="" if revived else cur.error,
                        candidates=cands, grammar_version=gv,
                        priority=cur.priority + nj.priority,
                        last_seen=max(cur.last_seen, nj.last_seen),
                        history=cur.history + (
                            ("revive" if revived else "merge", "", now),))
                    counts["revived" if revived else "merged"] += 1
            return counts

        return self._mutate(fn)

    def _expire_locked(self, jobs: dict, now: float) -> int:
        n = 0
        for k, j in jobs.items():
            if j.state == "leased" and j.lease_expiry < now:
                state = ("failed" if j.attempts >= self.max_attempts
                         else "pending")
                jobs[k] = dataclasses.replace(
                    j, state=state, worker="", lease_expiry=0.0,
                    error=(f"lease expired after {j.attempts} attempts"
                           if state == "failed" else j.error),
                    history=j.history + (("expire", j.worker, now),))
                n += 1
        return n

    def requeue_expired(self) -> int:
        """Requeue every expired lease (crashed workers); over
        ``max_attempts`` a job parks as failed.  ``claim`` runs this
        implicitly, so a fleet never needs a separate janitor."""
        return self._mutate(lambda jobs: self._expire_locked(jobs,
                                                             self.clock()))

    def claim(self, worker: Optional[str] = None, *,
              lease_s: float = DEFAULT_LEASE_S,
              platform: Optional[str] = None,
              device="cuda") -> Optional[TuneJob]:
        """Atomically claim the hottest pending job for ``platform``
        (defaults to ``device``'s — a cpu worker never claims a card's
        job).  Returns None when nothing is claimable."""
        worker = worker or default_worker_id()
        platform = platform or _default_platform(device)

        def fn(jobs: dict) -> Optional[TuneJob]:
            now = self.clock()
            self._expire_locked(jobs, now)
            cands = [j for j in jobs.values()
                     if j.state == "pending" and j.platform == platform]
            if not cands:
                return None
            cands.sort(key=lambda j: (-j.priority, -j.last_seen, j.job_id))
            j = cands[0]
            claimed = dataclasses.replace(
                j, state="leased", worker=worker,
                lease_expiry=now + lease_s, attempts=j.attempts + 1,
                history=j.history + (("claim", worker, now),))
            jobs[j.job_id] = claimed
            return claimed

        return self._mutate(fn)

    def complete(self, job_id: str, worker: str, result: str = "") -> bool:
        """Terminal commit by the lease holder of record.  A worker whose
        lease expired and was reassigned gets False — its measurement
        may have happened, but the ledger credits exactly one worker."""
        def fn(jobs: dict) -> bool:
            j = jobs.get(job_id)
            now = self.clock()
            if j is None or j.state != "leased" or j.worker != worker:
                log.warning("stale complete for %s by %s rejected "
                            "(state=%s holder=%s)", job_id, worker,
                            j.state if j else "absent",
                            j.worker if j else "-")
                return False
            jobs[job_id] = dataclasses.replace(
                j, state="done", result=result, worker="", lease_expiry=0.0,
                history=j.history + (("done", worker, now),))
            return True

        return self._mutate(fn)

    def fail(self, job_id: str, worker: str, error: str = "") -> bool:
        """Release a job after a build/measure failure: back to pending
        (the lease's attempt already counted) or failed over the cap."""
        def fn(jobs: dict) -> bool:
            j = jobs.get(job_id)
            now = self.clock()
            if j is None or j.state != "leased" or j.worker != worker:
                return False
            state = "failed" if j.attempts >= self.max_attempts else "pending"
            jobs[job_id] = dataclasses.replace(
                j, state=state, worker="", lease_expiry=0.0, error=error,
                history=j.history + (("fail", worker, now),))
            return True

        return self._mutate(fn)

    def expire_stale(self, max_age_s: float) -> int:
        """Drop PENDING jobs whose demand went quiet: no engine has
        missed on the shape for ``max_age_s`` seconds (``last_seen`` is
        maxed on every harvest merge, so live demand keeps refreshing
        it).  Leased jobs are in flight and ``done``/``failed`` jobs are
        the ledger — only queued-but-unwanted work is dropped.  Returns
        the number of jobs removed (each leaves a tombstone warning)."""
        def fn(jobs: dict) -> int:
            cutoff = self.clock() - max_age_s
            victims = [k for k, j in jobs.items()
                       if j.state == "pending" and j.last_seen < cutoff]
            for k in victims:
                log.warning("queue: expiring %s (no miss for > %.0fs)",
                            k, max_age_s)
                del jobs[k]
            return len(victims)

        return self._mutate(fn)

    # -- views -----------------------------------------------------------

    def jobs(self) -> dict:
        """Snapshot of the whole queue (read-only copy)."""
        return self._load()

    def status(self) -> dict:
        jobs = self._load()
        out = {"pending": 0, "leased": 0, "done": 0, "failed": 0,
               "total": len(jobs)}
        for j in jobs.values():
            out[j.state] = out.get(j.state, 0) + 1
        return out

    def active_keys(self, platform: Optional[str] = None,
                    device="cuda") -> set:
        """Problem keys the fleet already owns (pending, leased or done)
        for ``platform`` (default ``device``'s) — the set an engine's
        background tuner consults so a miss is measured exactly once
        fleet-wide (DESIGN.md §15)."""
        platform = platform or _default_platform(device)
        return {j.problem_key for j in self._load().values()
                if j.platform == platform
                and j.state in ("pending", "leased", "done")}


# ---------------------------------------------------------------------------
# harvest: persisted miss logs -> deduped jobs
# ---------------------------------------------------------------------------


def _consume_miss_file(path: Path) -> dict:
    """Atomically claim the miss-log file via rename, then read it.  Two
    concurrent harvesters race on the rename; the loser reads nothing.
    An engine flushing between a racer's read and a hypothetical delete
    can never be lost: rename is atomic, so a later flush simply starts
    a fresh file for the next harvest."""
    if not path.exists():
        return {}
    tmp = path.with_name(path.name + f".harvest.{os.getpid()}")
    try:
        os.replace(path, tmp)
    except FileNotFoundError:
        return {}
    try:
        raw = json.loads(tmp.read_text())
    except (OSError, json.JSONDecodeError):
        raw = {}
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return raw if isinstance(raw, dict) else {}


def candidate_tuning_keys(problem, hw=None,
                          cap: int = DEFAULT_TOP_CANDIDATES) -> tuple:
    """The model-ranked head of the grammar candidate space for one
    problem — the job payload builders start from — ranked by ``hw``
    (default the H100 spec, ``core/hw.py``)."""
    from repro_torch.core.autotuner import candidate_blocks
    from repro_torch.core.hw import H100
    return tuple(p.tuning_key()
                 for p in candidate_blocks(problem, hw or H100)[:cap])


def harvest(queue: Optional[JobQueue] = None, *, miss_path=None,
            top_candidates: int = DEFAULT_TOP_CANDIDATES, hw=None,
            expire_after_s: Optional[float] = None) -> dict:
    """Consume the persisted miss log into deduped tuning jobs.

    One job per distinct (platform, problem); ``priority`` is the miss
    count so hot misses rank first; the payload is the model-ranked head
    of the grammar candidate space.  Unparseable keys are skipped (a
    miss log may carry keys written by a newer problem schema).
    ``expire_after_s`` additionally drops pending jobs no engine has
    missed on within that window (``harvest --expire-after``) — the
    demand-driven garbage collection pass; this run's fresh misses
    refresh ``last_seen`` first, so they always survive."""
    from repro_torch.core import registry
    from repro_torch.core.plan import Problem
    from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION

    queue = queue or JobQueue()
    path = Path(miss_path) if miss_path else registry.miss_log_path()
    records = _consume_miss_file(path)
    jobs, skipped = [], 0
    for full_key, rec in records.items():
        platform, _, problem_key = full_key.partition("/")
        if not problem_key or not isinstance(rec, dict):
            skipped += 1
            continue
        try:
            problem = Problem.from_key(problem_key)
        except ValueError:
            skipped += 1
            continue
        jobs.append(TuneJob(
            problem_key=problem_key, platform=platform,
            candidates=candidate_tuning_keys(problem, hw,
                                             cap=top_candidates),
            grammar_version=GRAMMAR_VERSION,
            priority=max(int(rec.get("count", 1)), 1),
            last_seen=float(rec.get("last_seen", 0.0))))
    counts = queue.enqueue(jobs)
    counts["harvested"] = len(jobs)
    counts["skipped"] = skipped
    if expire_after_s is not None:
        counts["expired"] = queue.expire_stale(expire_after_s)
    log.info("harvest: %d miss records -> %s (queue %s)", len(records),
             counts, queue.path())
    return counts
