"""Degradation-ladder bookkeeping (DESIGN.md §16), the port of the
reference package's ``resilience/degrade.py``.

Every seam in the stack has a defined fallback instead of an unhandled
exception; this module is where the demotions are *counted* so an
operator can tell a healthy engine from one quietly limping:

====================  =========================================  ==============
seam                  healthy                                    degraded to
====================  =========================================  ==============
``kernel.variant``    planned hand-written CUDA kernel           its plain
                                                                 PyTorch version
``kernel.xla``        the plain PyTorch version                  unplanned
                                                                 ``torch.matmul``
``kernel.pinned``     (breaker open: planned not retried)        pinned fallback
``registry.flush``    plan/measurement map flushed to disk       deferred (memory
                                                                 stays authoritative)
``registry.misses``   miss log persisted                         re-stashed in memory
``registry.find_db``  read-only find-db overlay                  local plans only
``queue.file``        queue JSON loaded                          quarantined + reset
====================  =========================================  ==============

The seam names are the reference's (``kernel.xla`` keeps its name for
the blocked plain rung).  The reference's program-store seams
(``program.disk``, ``program.persist``) have no counterpart: the port
persists no programs (``serve/programs.py``).

:class:`DegradeStats` is the per-engine sink (``Engine.health_report()``
surfaces it); a contextvar makes the active engine's sink reachable from
module-level code (``tsmm_dot``, the registry) without threading a
handle through every call.  Code that runs outside any engine (install
sweeps, CLIs) records into a process-global sink.

The :class:`CircuitBreaker` stops retrying a persistently-failing
kernel key after ``threshold`` consecutive failures and pins its
fallback: a plan whose launch is refused deterministically would
otherwise pay the failed attempt on every call.

A CUDA graph capture runs its cell twice (a warm-up, then the capture),
where the reference traces once: :meth:`DegradeStats.capture` is the
sink of the second pass, which counts nothing and leaves the breaker
as the warm-up left it, so a demotion is counted once per capture.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Dict, List

BREAKER_THRESHOLD_DEFAULT = 3
MAX_EVENTS = 128                         # bounded event ring for reports


class CircuitBreaker:
    """Per-key consecutive-failure counter; opens at ``threshold``."""

    def __init__(self, threshold: int = BREAKER_THRESHOLD_DEFAULT):
        self.threshold = int(threshold)
        self._lock = threading.Lock()
        self._failures: Dict[str, int] = {}
        self._open: set = set()

    def allow(self, key: str) -> bool:
        """False once the key's breaker is open (fallback pinned)."""
        return key not in self._open

    def idle(self) -> bool:
        """No key open and none with a failure to reset."""
        return not self._open and not self._failures

    def failure(self, key: str) -> bool:
        """Record one failure; returns True when this opens the breaker."""
        with self._lock:
            n = self._failures.get(key, 0) + 1
            self._failures[key] = n
            if n >= self.threshold and key not in self._open:
                self._open.add(key)
                return True
        return False

    def success(self, key: str) -> None:
        """A clean pass resets the consecutive-failure count (a key with
        none takes no lock: every planned call passes here)."""
        if key not in self._failures:
            return
        with self._lock:
            self._failures.pop(key, None)

    def report(self) -> dict:
        with self._lock:
            return {"threshold": self.threshold,
                    "open": sorted(self._open),
                    "failures": dict(self._failures)}


class _ReadOnlyBreaker:
    """A breaker's view that answers ``allow`` and records nothing."""

    def __init__(self, breaker: CircuitBreaker):
        self._breaker = breaker

    def allow(self, key: str) -> bool:
        return self._breaker.allow(key)

    def idle(self) -> bool:
        return self._breaker.idle()

    def failure(self, key: str) -> bool:
        return False

    def success(self, key: str) -> None:
        pass


@dataclasses.dataclass
class DegradeEvent:
    seam: str
    key: str = ""
    fallback: str = ""
    error: str = ""


class DegradeStats:
    """Counts every ladder demotion; one per Engine (plus one global)."""

    def __init__(self, *, breaker_threshold: int = BREAKER_THRESHOLD_DEFAULT):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.events: List[DegradeEvent] = []
        self.breaker = CircuitBreaker(breaker_threshold)

    def record(self, seam: str, *, key: str = "", fallback: str = "",
               error: str = "") -> None:
        with self._lock:
            self.counts[seam] = self.counts.get(seam, 0) + 1
            if len(self.events) < MAX_EVENTS:
                self.events.append(DegradeEvent(seam, key, fallback,
                                                str(error)[:200]))

    def capture(self) -> "DegradeStats":
        """The sink of a graph capture's second pass over a cell: the same
        breaker's open keys, no counts, no breaker updates."""
        return _CaptureStats(self)

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def report(self) -> dict:
        with self._lock:
            return {
                "total": sum(self.counts.values()),
                "by_seam": dict(self.counts),
                "breaker": self.breaker.report(),
                "events": [dataclasses.asdict(e)
                           for e in self.events[-16:]],
            }


class _CaptureStats(DegradeStats):
    def __init__(self, of: DegradeStats):
        super().__init__()
        self.breaker = _ReadOnlyBreaker(of.breaker)

    def record(self, seam: str, **kw) -> None:
        pass


# -- ambient sink --------------------------------------------------------

GLOBAL = DegradeStats()
_CTX: contextvars.ContextVar = contextvars.ContextVar("degrade_stats",
                                                      default=None)


def current() -> DegradeStats:
    """The active engine's sink, or the process-global one."""
    return _CTX.get() or GLOBAL


@contextlib.contextmanager
def use(stats: DegradeStats):
    """Route module-level ``record()`` calls to ``stats``.  Reset is
    token-tolerant: the front end may enter in one asyncio task and
    close in another."""
    token = _CTX.set(stats)
    try:
        yield stats
    finally:
        try:
            _CTX.reset(token)
        except ValueError:               # crossed an asyncio task boundary
            _CTX.set(None)


def record(seam: str, *, key: str = "", fallback: str = "",
           error: str = "") -> None:
    current().record(seam, key=key, fallback=fallback, error=error)
