"""Named failpoint registry (DESIGN.md §16), the port of the reference
package's ``resilience/failpoints.py``.

Every durability / launch seam in the stack calls ``fp("<site>")`` (or
routes bytes through ``corrupt("<site>", data)``).  With no
configuration armed these are dictionary misses — the production hot
path pays one dict lookup per seam *event* (file write, program load,
lock acquire), never per token.

Arming a site attaches a :class:`FailAction`:

``raise``
    ``fp(site)`` raises :class:`InjectedFault` — the seam's defined
    degradation (warn + fall back) must absorb it.
``corrupt``
    ``corrupt(site, data)`` returns a torn copy of ``data`` (truncated
    to half, plus trailing garbage) — models a half-written file.
``delay``
    ``fp(site, clock=...)`` sleeps ``delay_s`` — on a §12
    ``VirtualClock`` the delay is charged virtually (deterministic), on
    a real clock it really sleeps.
``crash``
    ``os._exit(17)`` — the hard kill the §15 lease-expiry tests need
    (no atexit handlers, no flushes: a worker that died mid-lease).

Each action composes with ``p`` (fire probability, drawn from a seeded
RNG so chaos schedules replay exactly) and ``times`` (fire at most N
times, -1 = unlimited).

Configuration:

* env ``REPRO_TORCH_FAILPOINTS`` — either a JSON object
  ``{"site": "raise", "site2": {"action": "delay", "delay_s": 0.1,
  "p": 0.5, "times": 2}}`` or the compact form
  ``site=raise;site2=delay:delay_s=0.1:p=0.5:times=2``;
* env ``REPRO_TORCH_FAILPOINT_SEED`` — RNG seed for ``p`` draws (default 0);
* env ``REPRO_TORCH_TUNE_CRASH`` — the worker crash hook:
  ``after-claim`` / ``after-build`` arm a ``crash`` action on
  ``worker.claim.after`` / ``worker.build.after``;
* programmatic: ``configure({...}, seed=...)`` / ``reset()`` in tests.

The env is re-read lazily on first use (and after ``reset()``), so
subprocess-based tests arm children purely through the environment.
The variables carry the port's prefix, as its plan cache and miss log
do: arming the reference arms nothing here, and the reverse.  The site
names are the reference's (``kernels.lower.skinny``, ``registry.load``,
...), so one chaos schedule means the same in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)

ENV_CONFIG = "REPRO_TORCH_FAILPOINTS"
ENV_SEED = "REPRO_TORCH_FAILPOINT_SEED"
ENV_TUNE_CRASH = "REPRO_TORCH_TUNE_CRASH"
CRASH_EXIT_CODE = 17                     # pinned by the §15 lease tests

_ACTIONS = ("raise", "corrupt", "delay", "crash")

# REPRO_TORCH_TUNE_CRASH value -> failpoint site
TUNE_CRASH_ALIAS = {
    "after-claim": "worker.claim.after",
    "after-build": "worker.build.after",
}


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` failpoint.  Seams treat it exactly
    like the real fault it models (OSError, lowering error, ...)."""


@dataclasses.dataclass
class FailAction:
    """One armed site: what to do and how often."""
    action: str = "raise"
    p: float = 1.0                       # fire probability per hit
    times: int = -1                      # max fires (-1 = unlimited)
    delay_s: float = 0.05                # for action == "delay"
    fired: int = 0                       # bookkeeping
    hits: int = 0

    def spent(self) -> bool:
        return 0 <= self.times <= self.fired


class FailpointRegistry:
    """Site -> :class:`FailAction` map with a seeded RNG for ``p``."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._sites: Dict[str, FailAction] = {}
        self._rng = random.Random(seed)
        self._seed = seed

    # -- configuration ---------------------------------------------------

    def set(self, site: str, action: str = "raise", *, p: float = 1.0,
            times: int = -1, delay_s: float = 0.05) -> FailAction:
        if action not in _ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r} "
                             f"(one of {_ACTIONS})")
        fa = FailAction(action=action, p=float(p), times=int(times),
                        delay_s=float(delay_s))
        with self._lock:
            self._sites[site] = fa
        return fa

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def configure(self, spec, *, seed: Optional[int] = None) -> None:
        """Arm sites from a dict (``{"site": "raise" | {...}}``) or the
        compact string form.  Re-seeds the ``p`` RNG when asked, so a
        chaos schedule is a pure function of (spec, seed)."""
        if seed is not None:
            with self._lock:
                self._rng = random.Random(seed)
                self._seed = seed
        for site, val in _parse_spec(spec).items():
            self.set(site, **val)

    # -- the hot-path check ----------------------------------------------

    def check(self, site: str) -> Optional[FailAction]:
        """One hit on ``site``: returns the action to apply, or None.
        Consumes a ``times`` charge and a ``p`` draw when armed."""
        fa = self._sites.get(site)
        if fa is None:
            return None
        with self._lock:
            fa.hits += 1
            if fa.spent():
                return None
            if fa.p < 1.0 and self._rng.random() >= fa.p:
                return None
            fa.fired += 1
        return fa

    def report(self) -> dict:
        """Armed sites with hit/fire counts (for ``--health``)."""
        with self._lock:
            return {site: {"action": fa.action, "p": fa.p,
                           "times": fa.times, "hits": fa.hits,
                           "fired": fa.fired}
                    for site, fa in self._sites.items()}

    def armed(self) -> bool:
        return bool(self._sites)


def _parse_spec(spec) -> dict:
    """dict / JSON string / compact string -> {site: set()-kwargs}."""
    if isinstance(spec, str):
        spec = spec.strip()
        if not spec:
            return {}
        if spec.startswith("{"):
            spec = json.loads(spec)
        else:
            # site=action[:k=v[:k=v...]];site2=...
            parsed = {}
            for part in spec.split(";"):
                part = part.strip()
                if not part:
                    continue
                site, _, rhs = part.partition("=")
                toks = rhs.split(":")
                parsed[site.strip()] = {"action": toks[0].strip(),
                                        **dict(t.split("=", 1)
                                               for t in toks[1:] if t)}
            spec = parsed
    out = {}
    for site, val in dict(spec).items():
        if isinstance(val, str):
            val = {"action": val}
        val = dict(val)
        kw = {"action": str(val.pop("action", "raise"))}
        if "p" in val:
            kw["p"] = float(val.pop("p"))
        if "times" in val:
            kw["times"] = int(val.pop("times"))
        if "delay_s" in val:
            kw["delay_s"] = float(val.pop("delay_s"))
        if val:
            raise ValueError(f"failpoint {site!r}: unknown keys "
                             f"{sorted(val)}")
        out[site] = kw
    return out


# -- module-level singleton (env-armed lazily) ---------------------------

_REGISTRY: Optional[FailpointRegistry] = None
_REG_LOCK = threading.Lock()


def _from_env() -> FailpointRegistry:
    try:
        seed = int(os.environ.get(ENV_SEED, "0"))
    except ValueError:
        seed = 0
    reg = FailpointRegistry(seed=seed)
    raw = os.environ.get(ENV_CONFIG, "")
    if raw:
        try:
            reg.configure(raw)
        except Exception as e:              # bad config must not crash serve
            log.warning("ignoring unparseable %s=%r: %s",
                        ENV_CONFIG, raw, e)
    # the worker crash hook, an alias onto the plane
    crash = os.environ.get(ENV_TUNE_CRASH, "")
    if crash:
        site = TUNE_CRASH_ALIAS.get(crash)
        if site is None:
            log.warning("ignoring unknown %s=%r (known: %s)",
                        ENV_TUNE_CRASH, crash,
                        sorted(TUNE_CRASH_ALIAS))
        else:
            reg.set(site, "crash")
    return reg


def registry() -> FailpointRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _REG_LOCK:
            if _REGISTRY is None:
                _REGISTRY = _from_env()
    return _REGISTRY


def configure(spec, *, seed: Optional[int] = None) -> None:
    registry().configure(spec, seed=seed)


def reset() -> None:
    """Drop all armed sites and counters; the next use re-reads the
    environment.  Tests call this in teardown."""
    global _REGISTRY
    with _REG_LOCK:
        _REGISTRY = None


def report() -> dict:
    return registry().report()


def _apply(site: str, fa: FailAction, clock=None) -> None:
    if fa.action == "crash":
        log.warning("failpoint %s: crashing process (exit %d)",
                    site, CRASH_EXIT_CODE)
        os._exit(CRASH_EXIT_CODE)
    if fa.action == "delay":
        if clock is not None and getattr(clock, "virtual", False):
            clock.advance(fa.delay_s)
        else:
            time.sleep(fa.delay_s)
        return
    # "corrupt" armed on a control site degenerates to "raise": the seam
    # has no byte stream to tear, but must still exercise its fallback
    raise InjectedFault(f"failpoint {site!r} fired "
                        f"({fa.fired}/{fa.times if fa.times >= 0 else '∞'})")


def armed() -> bool:
    """Whether any site is armed (one check for a hot path's seams)."""
    return (_REGISTRY or registry()).armed()


def fp(site: str, clock=None) -> None:
    """Hit the named site.  No-op unless armed; may raise
    :class:`InjectedFault`, sleep, or kill the process."""
    reg = _REGISTRY or registry()
    if not reg.armed():
        return
    fa = reg.check(site)
    if fa is not None:
        _apply(site, fa, clock)


def corrupt(site: str, data):
    """Route a payload through the named site: a ``corrupt`` action
    returns a torn copy (truncate to half + trailing garbage); any other
    armed action behaves like :func:`fp`.  Returns ``data`` unchanged
    when unarmed."""
    reg = _REGISTRY or registry()
    if not reg.armed():
        return data
    fa = reg.check(site)
    if fa is None:
        return data
    if fa.action != "corrupt":
        _apply(site, fa)
        return data
    if isinstance(data, bytes):
        return data[: len(data) // 2] + b"\x00\xffTORN"
    if isinstance(data, str):
        return data[: len(data) // 2] + "\x00TORN"
    raise InjectedFault(f"failpoint {site!r}: cannot corrupt "
                        f"{type(data).__name__}")
