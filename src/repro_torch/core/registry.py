"""Persistent plan + measurement registry — the install-time artifact.

A port of the reference package's ``core/registry.py``.  A
:class:`Registry` keeps two JSON files with atomic writes, so that
launchers sharing a cache never lose each other's entries:

* **plans** — keyed ``platform/problem.key()``, one winning Plan each.
  On key conflicts a *measured* plan beats a model-ranked one
  (provenance guard): a calibrated re-rank never overwrites a timed
  winner with a model-ranked loser.
* **measurements** — keyed ``platform/problem.key()/plan.tuning_key()``,
  one :class:`MeasureRecord` (min-of-iters seconds, iteration count,
  dispersion, provenance) per timed candidate: the evaluator's cache,
  reused by repeated ``--measure`` sweeps and regressed over by the
  calibration fit.

The platform part of a key comes from the torch device the plan serves:
``"cpu"`` or the CUDA device's name, where the reference uses
``jax.default_backend()``.  Both maps merge the on-disk state before
every flush (last writer wins per key, not per file).  The port's files
live under ``~/.cache/repro_torch/`` unless ``REPRO_TORCH_PLAN_CACHE``,
``REPRO_TORCH_MEASURE_CACHE`` and ``REPRO_TORCH_MISS_LOG`` say otherwise;
it never reads or writes the reference's cache.

The miss log counts lookups that found no plan, for the serving
engine's background tuner (``drain_misses``) or for a persisted miss
file (``flush_misses``), which the fleet's ``harvest`` turns into tuning
jobs (``tuning/queue.py``).  With a find-db artifact attached
(``REPRO_TORCH_FIND_DB``, read once with the plan file, or
``tuning/find_db.py::attach``) the first lookup for a device folds that
device's platform section into memory under the local plans, which
win.  Module-level ``get/put/flush/stats/...``
delegate to one default Registry.

Durability follows the resilience plane (DESIGN.md §16): memory is
authoritative and disk is best-effort.  A torn or unreadable file reads
as empty, a failed plan or measurement flush is deferred to the next
one, a failed miss-log flush re-stashes its records; each is counted on
the ambient ``resilience.degrade`` sink, and the reference's failpoint
sites (``registry.load``, ``registry.flush.before_replace``,
``registry.measure.before_replace``, ``registry.misses.before_replace``)
inject them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch.core.plan import Plan
from repro_torch.resilience import degrade, failpoints

log = logging.getLogger(__name__)


def cache_path() -> Path:
    p = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if p:
        return Path(p)
    return (Path(os.environ.get("HOME", "/tmp")) / ".cache" / "repro_torch"
            / "plans.json")


def measure_cache_path() -> Path:
    p = os.environ.get("REPRO_TORCH_MEASURE_CACHE")
    if p:
        return Path(p)
    return cache_path().with_name("measurements.json")


def miss_log_path() -> Path:
    """The persisted miss log (``REPRO_TORCH_MISS_LOG`` or a sibling of the
    plan cache), written by ``flush_misses``."""
    p = os.environ.get("REPRO_TORCH_MISS_LOG")
    if p:
        return Path(p)
    return cache_path().with_name("misses.json")


# Ceiling on persisted measurement records: eviction only removes records
# whose tuning key ``candidate_blocks`` no longer produces, oldest first;
# records the search can still propose are never dropped, even over it.
MEASURE_CACHE_MAX_DEFAULT = 4096


def measure_cache_max() -> int:
    raw = os.environ.get("REPRO_TORCH_MEASURE_CACHE_MAX", "")
    return int(raw) if raw else MEASURE_CACHE_MAX_DEFAULT


# Bound on the pending miss log; the oldest keys evict first.
MISS_LOG_MAX_DEFAULT = 1024


def miss_log_max() -> int:
    raw = os.environ.get("REPRO_TORCH_MISS_LOG_MAX", "")
    return int(raw) if raw else MISS_LOG_MAX_DEFAULT


def platform(device) -> str:
    """The registry's platform key for a torch device."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _key(problem_key: str, device) -> str:
    return f"{platform(device)}/{problem_key}"


@dataclasses.dataclass(frozen=True)
class MeasureRecord:
    """One timing of one candidate plan.

    ``seconds`` is the fastest of ``iters`` timed calls (noise is
    additive, so the min estimates the kernel's own cost); ``dispersion``
    the interquartile range over that minimum.  ``impl`` is ``"cuda"``
    (the hand-written kernels, CUDA-event timed) or ``"torch"`` (the plain
    versions on the CPU); ``source`` records provenance (install sweep,
    background tuner, benchmark); ``wall_time`` (epoch seconds) orders
    eviction."""

    plan: Plan
    seconds: float
    iters: int
    dispersion: float
    impl: str = "cuda"
    source: str = "evaluator"
    wall_time: float = 0.0

    def key(self) -> str:
        return f"{self.plan.problem.key()}/{self.plan.tuning_key()}"

    def to_json(self) -> dict:
        return {"plan": self.plan.to_json(), "seconds": self.seconds,
                "iters": self.iters, "dispersion": self.dispersion,
                "impl": self.impl, "source": self.source,
                "wall_time": self.wall_time}

    @staticmethod
    def from_json(d: dict) -> "MeasureRecord":
        d = dict(d)
        d["plan"] = Plan.from_json(d["plan"])
        return MeasureRecord(**d)


def _atomic_write_json(path: Path, blob: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_json(path: Path) -> Optional[dict]:
    if not path.exists():
        return None
    try:
        failpoints.fp("registry.load")
        with open(path) as f:
            return json.loads(failpoints.corrupt("registry.load", f.read()))
    except (OSError, json.JSONDecodeError, TypeError,
            failpoints.InjectedFault) as e:
        # torn or unreadable: nothing mergeable; memory (and the next
        # clean flush) stays authoritative
        log.warning("registry: unreadable %s (%s); treating as empty",
                    path, e)
        return None


def _fold_missing(path: Path, dest: dict, from_json) -> None:
    """Fold the on-disk map into ``dest`` for keys we do not hold;
    entries that do not decode are skipped."""
    raw = _read_json(path)
    if not raw:
        return
    for k, v in raw.items():
        if k not in dest:
            try:
                dest[k] = from_json(v)
            except (TypeError, KeyError):
                continue


class Registry:
    """One plan + measurement cache with instance-local state, guarded by
    ``self._lock``.  Paths default to the environment (re-read per
    access, so tests can monkeypatch and then ``clear_memory()``)."""

    def __init__(self, plan_path: Optional[Path] = None,
                 measure_path: Optional[Path] = None):
        self._lock = threading.Lock()
        self._plan_path = Path(plan_path) if plan_path else None
        self._measure_path = Path(measure_path) if measure_path else None
        self._mem: dict[str, Plan] = {}
        self._meas: dict[str, MeasureRecord] = {}
        self._loaded_from: Optional[Path] = None
        self._meas_loaded_from: Optional[Path] = None
        # a miss means the caller had to tune fresh; after the install
        # sweep an Engine start is all hits
        self._stats = {"hits": 0, "misses": 0}
        # problem key -> {"count", "last_seen", "platform"}, in miss order
        self._missed: dict = {}
        # problem key -> frozenset of candidate tuning keys (or None),
        # memoized across prune passes
        self._valid_tuning_keys: dict = {}
        # the find-db artifact (``REPRO_TORCH_FIND_DB``), read when the plan
        # file is folded in, and the platforms whose section is folded
        self._find_db: Optional[str] = None
        self._find_db_folded: set = set()

    # -- paths ----------------------------------------------------------

    def plan_path(self) -> Path:
        return self._plan_path if self._plan_path is not None else cache_path()

    def measure_path(self) -> Path:
        return (self._measure_path if self._measure_path is not None
                else measure_cache_path())

    # -- plans ----------------------------------------------------------

    def _load_file(self, device=None) -> None:
        """(lock held) Fold the on-disk plan map into memory once, and read
        which find-db is attached; then, with one attached, overlay
        ``device``'s platform section once for keys still missing: local
        plans always win over the artifact."""
        if self._loaded_from is None:
            _fold_missing(self.plan_path(), self._mem, Plan.from_json)
            self._loaded_from = self.plan_path()
            self._find_db = os.environ.get("REPRO_TORCH_FIND_DB", "") or None
        if device is None or self._find_db is None:
            return
        plat = platform(device)
        if plat in self._find_db_folded:
            return
        self._find_db_folded.add(plat)
        from repro_torch.tuning.find_db import read_find_db  # lazy: a cycle
        folded = 0
        for problem_key, plan in read_find_db(self._find_db,
                                              platform=plat).items():
            if self._mem.setdefault(f"{plat}/{problem_key}", plan) is plan:
                folded += 1
        if folded:
            log.info("registry: %d plans folded from find-db", folded)

    def _merge_disk(self, protect: frozenset = frozenset()) -> None:
        """(lock held) Fold plans other processes flushed into memory.  Per
        key our plan wins, except that a measured plan on disk beats a
        model-ranked one in memory (``protect`` keys are exempt: a
        force-put stands)."""
        raw = _read_json(self.plan_path())
        if not raw:
            return
        for k, v in raw.items():
            try:
                theirs = Plan.from_json(v)
            except (TypeError, KeyError):
                continue
            ours = self._mem.get(k)
            if ours is None or (k not in protect
                                and theirs.chosen_by == "measured"
                                and ours.chosen_by != "measured"):
                self._mem[k] = theirs

    def _write_file(self, protect: frozenset = frozenset()) -> bool:
        """(lock held) One atomic merge-then-write of the plan map.  A
        failed write (full disk, injected fault) is a degradation, not an
        error: the plans stay in memory and the next flush retries.
        Returns True when the write landed."""
        try:
            self._merge_disk(protect)
            failpoints.fp("registry.flush.before_replace")
            _atomic_write_json(self.plan_path(),
                               {k: p.to_json() for k, p in self._mem.items()})
            return True
        except (OSError, failpoints.InjectedFault) as e:
            log.warning("registry: plan flush -> %s failed (%s); plans stay "
                        "in memory until the next flush", self.plan_path(), e)
            degrade.record("registry.flush", key=str(self.plan_path()),
                           fallback="deferred", error=str(e))
            return False

    def get(self, problem_key: str, device) -> Optional[Plan]:
        with self._lock:
            self._load_file(device)
            plan = self._mem.get(_key(problem_key, device))
            if plan is not None:
                self._stats["hits"] += 1
            else:
                self._stats["misses"] += 1
                rec = self._missed.get(problem_key)
                if rec is not None:
                    rec["count"] += 1
                    rec["last_seen"] = time.time()
                else:
                    while len(self._missed) >= miss_log_max():
                        self._missed.pop(next(iter(self._missed)))
                    self._missed[problem_key] = {
                        "count": 1, "last_seen": time.time(),
                        "platform": platform(device)}
            return plan

    def peek(self, problem_key: str, device) -> Optional[Plan]:
        """Lookup without touching the hit/miss counters or the miss log."""
        with self._lock:
            self._load_file(device)
            return self._mem.get(_key(problem_key, device))

    def put(self, plan: Plan, device, persist: bool = True,
            force: bool = False) -> Plan:
        """Insert ``plan``; returns the plan that stands afterwards.  An
        existing measured winner is never replaced by a model-ranked plan
        unless ``force``."""
        with self._lock:
            self._load_file(device)
            key = _key(plan.problem.key(), device)
            cur = self._mem.get(key)
            if (not force and cur is not None
                    and cur.chosen_by == "measured"
                    and plan.chosen_by != "measured"):
                log.debug("registry: keeping measured winner for %s", key)
            else:
                self._mem[key] = plan
            if persist:
                self._write_file(frozenset((key,)) if force else frozenset())
            # the flush may have merged a measured winner over our entry
            return self._mem.get(key, plan)

    def flush(self) -> None:
        """Persist plans and measurements, one atomic write each — the
        bulk path for the install sweep and the engine's pre-pack."""
        with self._lock:
            self._load_file()
            self._write_file()
            if self._meas:
                try:
                    self._write_measure_file()
                except (OSError, failpoints.InjectedFault) as e:
                    log.warning("registry: measurement flush -> %s failed "
                                "(%s); records stay in memory",
                                self.measure_path(), e)
                    degrade.record("registry.flush",
                                   key=str(self.measure_path()),
                                   fallback="deferred", error=str(e))

    # -- measurements ---------------------------------------------------

    def _load_measure_file(self) -> None:
        _fold_missing(self.measure_path(), self._meas,
                      MeasureRecord.from_json)
        self._meas_loaded_from = self.measure_path()

    def _write_measure_file(self) -> None:
        """(lock held) Merge-then-write; over the cap, stale records are
        evicted oldest first."""
        _fold_missing(self.measure_path(), self._meas,
                      MeasureRecord.from_json)
        self._prune_measurements_locked(measure_cache_max())
        failpoints.fp("registry.measure.before_replace")
        _atomic_write_json(self.measure_path(),
                           {k: r.to_json() for k, r in self._meas.items()})

    def _prune_measurements_locked(self, cap: int) -> int:
        """(lock held) Evict the oldest STALE records (tuning keys that
        ``candidate_blocks`` no longer produces for their problem) until
        the map fits ``cap``; live records are never evicted.  Returns
        the number evicted."""
        if cap <= 0 or len(self._meas) <= cap:
            return 0
        from repro_torch.core.autotuner import candidate_blocks, default_hw
        valid = self._valid_tuning_keys

        def stale(rec: MeasureRecord) -> bool:
            pk = rec.plan.problem.key()
            if pk not in valid:
                try:
                    valid[pk] = frozenset(
                        p.tuning_key() for p in candidate_blocks(
                            rec.plan.problem, default_hw("cpu")))
                except (ValueError, TypeError, KeyError):
                    valid[pk] = None
            keys = valid[pk]
            return keys is not None and rec.plan.tuning_key() not in keys

        victims = sorted((k for k, r in self._meas.items() if stale(r)),
                         key=lambda k: self._meas[k].wall_time)
        dropped = 0
        for k in victims:
            if len(self._meas) <= cap:
                break
            del self._meas[k]
            dropped += 1
        if dropped:
            log.info("measurement cache: evicted %d stale records (cap %d)",
                     dropped, cap)
        return dropped

    def prune_measurements(self, cap: Optional[int] = None) -> int:
        with self._lock:
            if self._meas_loaded_from is None:
                self._load_measure_file()
            return self._prune_measurements_locked(
                measure_cache_max() if cap is None else cap)

    def record_measurement(self, rec: MeasureRecord, device,
                           persist: bool = False) -> None:
        with self._lock:
            if self._meas_loaded_from is None:
                self._load_measure_file()
            self._meas[f"{platform(device)}/{rec.key()}"] = rec
            if persist:
                self._write_measure_file()

    def lookup_measurement(self, plan: Plan,
                           device) -> Optional[MeasureRecord]:
        with self._lock:
            if self._meas_loaded_from is None:
                self._load_measure_file()
            return self._meas.get(f"{platform(device)}/"
                                  f"{plan.problem.key()}/{plan.tuning_key()}")

    def measurements(self, device,
                     problem_key: Optional[str] = None) -> list:
        """All cached records for ``device``'s platform (optionally of one
        problem)."""
        with self._lock:
            if self._meas_loaded_from is None:
                self._load_measure_file()
            pre = f"{platform(device)}/"
            out = [r for k, r in self._meas.items() if k.startswith(pre)]
        if problem_key is not None:
            out = [r for r in out if r.plan.problem.key() == problem_key]
        return out

    # -- telemetry ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def reset_stats(self) -> None:
        with self._lock:
            self._stats["hits"] = self._stats["misses"] = 0

    def drain_misses(self) -> list:
        """Return-and-clear the problem keys that missed since the last
        drain, in miss order — the background tuner's work queue."""
        return [r["key"] for r in self.drain_miss_records()]

    def miss_records(self) -> list:
        """Snapshot of the pending miss log: ``{"key", "count",
        "last_seen", "platform"}`` per distinct problem key."""
        with self._lock:
            return [{"key": k, **r} for k, r in self._missed.items()]

    def drain_miss_records(self) -> list:
        with self._lock:
            out = [{"key": k, **r} for k, r in self._missed.items()]
            self._missed = {}
            return out

    def flush_misses(self, path: Optional[Path] = None) -> int:
        """Drain the miss log into the persisted miss file, merged per
        ``platform/problem`` key (counts sum, ``last_seen`` maxes) under an
        atomic read-merge-replace.  Returns the number of records drained
        (0: no write at all)."""
        drained = self.drain_miss_records()
        if not drained:
            return 0
        path = Path(path) if path is not None else miss_log_path()
        raw = _read_json(path) or {}
        for r in drained:
            k = f"{r['platform']}/{r['key']}"
            cur = raw.get(k)
            if isinstance(cur, dict):
                raw[k] = {"count": int(cur.get("count", 0)) + r["count"],
                          "last_seen": max(float(cur.get("last_seen", 0.0)),
                                           r["last_seen"])}
            else:
                raw[k] = {"count": r["count"], "last_seen": r["last_seen"]}
        try:
            failpoints.fp("registry.misses.before_replace")
            _atomic_write_json(path, raw)
        except (OSError, failpoints.InjectedFault) as e:
            # re-stash so the drained counts are not lost
            with self._lock:
                for r in drained:
                    rec = self._missed.setdefault(
                        r["key"], {"count": 0, "last_seen": 0.0,
                                   "platform": r["platform"]})
                    rec["count"] += r["count"]
                    rec["last_seen"] = max(rec["last_seen"], r["last_seen"])
            log.warning("registry: miss-log flush -> %s failed (%s); %d "
                        "records re-stashed", path, e, len(drained))
            degrade.record("registry.misses", key=str(path),
                           fallback="re-stashed", error=str(e))
            return 0
        log.info("registry: flushed %d miss records -> %s", len(drained),
                 path)
        return len(drained)

    # -- snapshot / preload ---------------------------------------------

    def snapshot_plans(self) -> dict:
        """The merged plan map (memory + disk, per-key provenance rules),
        as a copy."""
        with self._lock:
            self._load_file()
            self._merge_disk()
            return dict(self._mem)

    def preload_plans(self, plans: dict) -> int:
        """Seed memory with ``{full_key: Plan}`` for keys not already
        held; returns how many were added."""
        with self._lock:
            self._load_file()
            n = 0
            for k, p in plans.items():
                if k not in self._mem:
                    self._mem[k] = p
                    n += 1
            return n

    def attach_find_db(self, path) -> None:
        """Overlay the find-db artifact at ``path`` (None: none) from the
        next lookup on, under the plans already held."""
        with self._lock:
            self._find_db = str(path) if path else None
            self._find_db_folded = set()

    def clear_memory(self) -> None:
        """Drop the in-memory caches, counters and miss log (files
        untouched); the next access reloads from the current paths."""
        with self._lock:
            self._mem.clear()
            self._meas.clear()
            self._loaded_from = None
            self._meas_loaded_from = None
            self._stats["hits"] = self._stats["misses"] = 0
            self._missed = {}
            self._valid_tuning_keys = {}
            self._find_db = None
            self._find_db_folded = set()


# ---------------------------------------------------------------------------
# Module-level API: delegates to one default Registry.
# ---------------------------------------------------------------------------

_DEFAULT = Registry()


def default() -> Registry:
    return _DEFAULT


def get(problem_key: str, device) -> Optional[Plan]:
    return _DEFAULT.get(problem_key, device)


def peek(problem_key: str, device) -> Optional[Plan]:
    return _DEFAULT.peek(problem_key, device)


def put(plan: Plan, device, persist: bool = True, force: bool = False) -> Plan:
    return _DEFAULT.put(plan, device, persist=persist, force=force)


def flush() -> None:
    _DEFAULT.flush()


def record_measurement(rec: MeasureRecord, device,
                       persist: bool = False) -> None:
    _DEFAULT.record_measurement(rec, device, persist=persist)


def lookup_measurement(plan: Plan, device) -> Optional[MeasureRecord]:
    return _DEFAULT.lookup_measurement(plan, device)


def measurements(device, problem_key: Optional[str] = None) -> list:
    return _DEFAULT.measurements(device, problem_key)


def stats() -> dict:
    return _DEFAULT.stats()


def reset_stats() -> None:
    _DEFAULT.reset_stats()


def drain_misses() -> list:
    return _DEFAULT.drain_misses()


def miss_records() -> list:
    return _DEFAULT.miss_records()


def drain_miss_records() -> list:
    return _DEFAULT.drain_miss_records()


def flush_misses(path: Optional[Path] = None) -> int:
    return _DEFAULT.flush_misses(path)


def snapshot_plans() -> dict:
    return _DEFAULT.snapshot_plans()


def preload_plans(plans: dict) -> int:
    return _DEFAULT.preload_plans(plans)


def clear_memory() -> None:
    _DEFAULT.clear_memory()
