"""Clock seam for the serving stack.

The port of the reference's ``serve/clock.py`` (DESIGN.md §12), copied:
the port imports nothing of the reference.

Everything in ``serve/`` that reads time does it through a :class:`Clock`
so the SAME scheduler / front-end code runs in two modes:

* :class:`RealClock` — ``time.perf_counter``; telemetry measures real
  wall time (the default, what production serving uses);
* :class:`VirtualClock` — a manually-advanced counter.  Nothing sleeps:
  the component that *performs* a timed operation (a prefill, a lockstep
  decode step, a cold cell's capture) advances the clock by that operation's
  *modeled* cost from a :class:`StepCost`, so an open-loop arrival
  process, TTFT percentiles and queue-delay telemetry are all
  deterministic functions of (trace seed, cost model) — reproducible
  bit-for-bit in CI, on a laptop, anywhere.

The split of responsibilities is deliberate: the clock only *stores*
time, the cost model only *prices* operations, and the scheduler decides
when to charge.  Real mode ignores the cost model entirely.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """What the serving stack needs from a time source."""

    virtual: bool

    def now(self) -> float:                              # seconds
        ...

    def advance(self, dt: float) -> float:               # virtual only
        ...

    async def sleep(self, dt: float) -> None:
        ...


class RealClock:
    """``time.perf_counter`` behind the :class:`Clock` protocol."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: float) -> float:
        raise TypeError("RealClock cannot be advanced; time passes on its own")

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(dt)


class VirtualClock:
    """Deterministic simulated time: advances only when told to.

    ``sleep`` advances immediately and yields control once (so an
    asyncio loop stays cooperative) — a simulated run never blocks on
    the wall clock.
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot rewind (dt={dt})")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        return self.advance(max(t - self._now, 0.0))

    async def sleep(self, dt: float) -> None:
        self.advance(max(dt, 0.0))
        await asyncio.sleep(0)                           # cooperative yield


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Deterministic cost model the scheduler charges a virtual clock.

    The absolute values are placeholders for a machine; what matters for
    the SLO harness is the *structure* (prefill cost scales with prompt
    tokens, decode with steps, cold programs pay a one-off), which makes
    queueing behavior — admission delay, TTFT percentiles vs offered
    load — realistic and exactly reproducible.  Real-clock runs never
    consult this.
    """

    decode_step_s: float = 1e-3       # one lockstep decode over the pool
    prefill_token_s: float = 2e-5     # per prompt token (incl. bucket pad)
    compile_s: float = 0.05           # first invocation of a program

    def prefill_s(self, tokens: int) -> float:
        return tokens * self.prefill_token_s


def ensure_clock(clock) -> Clock:
    return clock if clock is not None else RealClock()
