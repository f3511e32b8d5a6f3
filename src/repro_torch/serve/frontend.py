"""Async SLO-aware serving front end.

The port of the reference's ``serve/frontend.py`` (DESIGN.md §12).
``Engine.serve_queue`` is closed-loop: a static request list is drained
as fast as the hardware goes.  Production traffic is OPEN-loop — an
arrival process the server does not control — and the quantities that
matter are time-to-first-token percentiles and queue delay under an
offered load, not just throughput.  :class:`AsyncEngine` is that front
end, built on the step-driven :class:`~repro_torch.serve.scheduler
.ContinuousScheduler` core:

* **admission control / backpressure** — at most ``queue_limit``
  requests may wait; a submit beyond that is REJECTED immediately
  (bounded queues are what keep p99 finite when offered load exceeds
  capacity);
* **priority tiers + tenant fairness** — lower ``Request.priority``
  admits first; within a tier, tenants are served round-robin; a
  request waiting longer than ``starvation_steps`` decode steps is
  escalated ahead of every tier (no starvation, pinned by property
  test);
* **chunk-budgeted prefill** — each decode step earns
  ``prefill_budget`` prompt tokens of admission credit; an admission
  spends its length bucket.  Prefill work interleaves with decode in
  bounded slices instead of stalling the live batch behind a deep
  queue's worth of back-to-back prefills (the lockstep-cache adaptation
  of chunked prefill: admissions are chunked across steps, each
  admission itself is atomic because the prompt must be contiguous
  under the global position clock);
* **per-request token streaming** — every generated token is pushed to
  the request's :class:`TokenStream` with a clock timestamp
  (``async for tok in stream`` in asyncio mode);
* **deadlines + cooperative cancellation** — a request carrying
  ``Request.deadline`` (absolute clock seconds) is cancelled at the
  first tick past it: dropped from the queue, or reclaimed MID-decode
  so its slot admits the next request immediately.  ``stream.cancel()``
  does the same on demand.  ``submit_retry`` wraps ``submit`` in
  bounded exponential backoff for transient admission failures.

The reference's ``frontend.admit`` failpoint (its resilience plane) is
not ported yet: it comes with the failpoints themselves (ROADMAP.md
Queue 1 item 6).

Two loops share the exact same admission/step methods:
``simulate(trace)`` runs an open-loop trace on a
:class:`~repro_torch.serve.clock.VirtualClock` — fully deterministic,
no sleeping, the harness of the front end's tests — and ``run()`` is
the asyncio loop (``await submit(...)``, real or virtual clock).
Because both drive ``ContinuousScheduler.admit`` / ``step``, a front
end with default policy produces byte-identical tokens to
``Engine.serve_queue`` on the same request set.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
from collections import deque
from typing import List, Optional

from repro_torch.resilience import failpoints
from repro_torch.serve.clock import StepCost
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         StreamResult)

log = logging.getLogger(__name__)

_END = object()                          # stream-queue sentinel


class AdmissionError(RuntimeError):
    """Raised by ``await submit(...)`` when admission control rejects."""


@dataclasses.dataclass
class TokenStream:
    """Handle for one in-flight request: tokens as they are generated,
    with clock timestamps, plus final SLO accounting."""

    rid: object
    tenant: str
    priority: int
    arrival_time: float
    prompt_len: int
    length_bucket: int
    tokens: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)
    rejected: bool = False               # bounced by admission control
    completed: bool = False              # reached EOS / max_new_tokens
    admitted_time: float = math.nan      # clock seconds at admission
    finish_time: float = math.nan
    queue_steps: int = 0                 # decode steps waited
    result: Optional[StreamResult] = None
    deadline: Optional[float] = None     # absolute clock seconds
    cancel_requested: bool = False       # set by cancel(); acted on at tick
    cancelled: bool = False              # reaped before finishing
    _q: object = None                    # asyncio.Queue, made lazily

    @property
    def ttft(self) -> Optional[float]:
        """Arrival -> first generated token, in clock seconds."""
        return (self.token_times[0] - self.arrival_time
                if self.token_times else None)

    @property
    def queue_delay(self) -> Optional[float]:
        """Arrival -> admission (prefill start), in clock seconds."""
        if math.isnan(self.admitted_time):
            return None
        return self.admitted_time - self.arrival_time

    @property
    def done(self) -> bool:
        """Terminal: finished, truncated, rejected, or dropped."""
        return not math.isnan(self.finish_time)

    def cancel(self) -> None:
        """Cooperative cancel: takes effect at the next scheduler tick —
        queued streams are dropped, running streams reclaimed (tokens
        emitted so far stay on the stream, ``completed`` is False)."""
        self.cancel_requested = True

    def _queue(self):
        if self._q is None:
            self._q = asyncio.Queue()
        return self._q

    def _push(self, tok: int, t: float) -> None:
        self.tokens.append(tok)
        self.token_times.append(t)
        self._queue().put_nowait(tok)

    def _finish(self, result, t: float, completed: bool) -> None:
        self.result = result
        self.finish_time = t
        self.completed = completed
        self._queue().put_nowait(_END)

    async def __aiter__(self):
        """Stream tokens as they are generated (the asyncio loop)."""
        q = self._queue()
        while True:
            item = await q.get()
            if item is _END:
                return
            yield item


class AsyncEngine:
    """Open-loop serving front end over a step-driven scheduler core."""

    def __init__(self, engine, *, slots: Optional[int] = None,
                 queue_limit: int = 64,
                 prefill_budget: Optional[int] = None,
                 starvation_steps: int = 64,
                 clock=None, step_cost: Optional[StepCost] = None):
        self.engine = engine
        self.sched = ContinuousScheduler(engine, slots=slots, clock=clock,
                                         step_cost=step_cost)
        self.clock = self.sched.clock
        self.queue_limit = queue_limit
        self.prefill_budget = prefill_budget
        self.starvation_steps = starvation_steps
        # admission credit (prompt tokens); capped so a prompt longer
        # than one step's budget still accumulates enough to admit
        self._credit = float(prefill_budget or 0)
        self._credit_cap = max(prefill_budget or 0,
                               engine.grid.length[-1])
        # pending queues: priority -> tenant -> deque of entries, plus a
        # per-tier tenant round-robin pointer (first-seen tenant order)
        self._tiers: dict = {}
        self._order: dict = {}
        self._rri: dict = {}
        self._pending = 0
        self._seq = 0                    # total submission order
        self._running = False
        self.stats = None

    # -- lifecycle ------------------------------------------------------

    def open(self, base_clock: Optional[int] = None) -> None:
        """Allocate scheduler state.  ``base_clock`` defaults to the
        grid's largest length bucket so ANY admissible prompt can arrive
        later (an open-loop server cannot peek at future arrivals)."""
        self.sched.open(self.engine.grid.length[-1]
                        if base_clock is None else base_clock)
        self.stats = self.sched.stats

    def close(self):
        stats = self.sched.close()
        self.stats = stats
        return stats

    # -- submission / admission control ---------------------------------

    def submit_nowait(self, req: Request, _pre=None) -> TokenStream:
        """Enqueue one request.  Admission control: if ``queue_limit``
        requests already wait, the stream comes back ``rejected`` and
        carries no tokens (the caller sheds load instead of growing an
        unbounded queue)."""
        if self.stats is None:
            self.open()
        toks, lb = _pre if _pre is not None else self.sched.prepare(req)
        stream = TokenStream(
            rid=req.rid if req.rid is not None else self._seq,
            tenant=req.tenant, priority=req.priority,
            arrival_time=req.arrival_time, prompt_len=int(toks.shape[0]),
            length_bucket=lb, deadline=req.deadline)
        if self._pending >= self.queue_limit:
            stream.rejected = True
            self.stats.rejected += 1
            self.stats.tier(req.priority).rejected += 1
            stream._finish(None, self.clock.now(), False)
            return stream
        entry = {"stream": stream, "req": req, "toks": toks, "lb": lb,
                 "enq_step": self.stats.steps, "seq": self._seq}
        self._seq += 1
        tier = self._tiers.setdefault(req.priority, {})
        if req.tenant not in tier:
            tier[req.tenant] = deque()
            self._order.setdefault(req.priority, []).append(req.tenant)
        tier[req.tenant].append(entry)
        self._pending += 1
        return stream

    async def submit(self, req: Request) -> TokenStream:
        try:
            failpoints.fp("frontend.admit", clock=self.clock)
        except failpoints.InjectedFault as e:
            raise AdmissionError(f"transient admission failure: {e}")
        stream = self.submit_nowait(req)
        if stream.rejected:
            raise AdmissionError(
                f"queue full ({self.queue_limit} pending); request "
                f"{stream.rid!r} rejected")
        return stream

    async def submit_retry(self, req: Request, *, retries: int = 3,
                           backoff_s: float = 0.01,
                           factor: float = 2.0) -> TokenStream:
        """``submit`` with bounded exponential backoff for transient
        admission failures (queue momentarily full, injected
        ``frontend.admit`` fault).  Backoff sleeps on the engine clock, so
        virtual-clock tests stay deterministic.  Re-raises the last
        :class:`AdmissionError` after ``retries`` re-attempts."""
        delay = backoff_s
        last: Optional[AdmissionError] = None
        for attempt in range(retries + 1):
            try:
                return await self.submit(req)
            except AdmissionError as e:
                last = e
                if attempt == retries:
                    break
                await self.clock.sleep(delay)
                delay *= factor
        raise last

    # -- scheduling policy ----------------------------------------------

    def _select(self, commit: bool):
        """Pick the next request to admit.  Anti-starvation first: any
        entry older than ``starvation_steps`` decode steps is served
        oldest-first regardless of tier.  Otherwise: highest-priority
        non-empty tier, round-robin over its tenants."""
        step = self.stats.steps
        aged = None
        for prio, tenants in self._tiers.items():
            for tn, dq in tenants.items():
                if dq and step - dq[0]["enq_step"] >= self.starvation_steps:
                    key = (dq[0]["enq_step"], dq[0]["seq"])
                    if aged is None or key < aged[0]:
                        aged = (key, prio, tn)
        if aged is not None:
            _, prio, tn = aged
            return (self._tiers[prio][tn].popleft() if commit
                    else self._tiers[prio][tn][0])
        for prio in sorted(self._tiers):
            tenants = self._tiers[prio]
            order = self._order[prio]
            i0, n = self._rri.get(prio, 0), len(order)
            for k in range(n):
                tn = order[(i0 + k) % n]
                dq = tenants.get(tn)
                if dq:
                    if not commit:
                        return dq[0]
                    self._rri[prio] = (i0 + k + 1) % n
                    return dq.popleft()
        return None

    def _admit_phase(self) -> None:
        """Admit as many pending requests as slots and the prefill
        budget allow.  With a live batch, admission stops once the next
        candidate's bucket exceeds the accumulated credit — decode is
        never stalled by more than ``prefill_budget`` prompt tokens of
        prefill per step.  An idle batch bypasses the budget (there is
        nothing to stall)."""
        while self._pending and self.sched.can_admit():
            head = self._select(commit=False)
            budgeted = self.prefill_budget and self.sched.active
            if budgeted and self._credit < head["lb"]:
                break
            e = self._select(commit=True)
            if budgeted:
                self._credit -= e["lb"]
            self._pending -= 1
            stream = e["stream"]
            stream.admitted_time = self.clock.now()
            emitted, finished = self.sched.admit(
                e["req"], e["toks"], e["lb"], tag=stream,
                arrival=stream.arrival_time)
            stream.queue_steps = emitted[0][0]["queue_steps"]
            self._deliver(emitted, finished)

    def _step_phase(self) -> None:
        emitted, finished = self.sched.step()
        if self.prefill_budget:
            self._credit = min(self._credit + self.prefill_budget,
                               self._credit_cap)
        self._deliver(emitted, finished)

    def _deliver(self, emitted, finished) -> None:
        for st, tok, t in emitted:
            if st["tag"] is not None:
                st["tag"]._push(tok, t)
        for tag, res in finished:
            if tag is not None:
                tag._finish(res, self.clock.now(), res.completed)

    def _reap(self) -> None:
        """Cancellation / deadline pass, run at the top of every
        tick: doomed QUEUED entries are dropped in place (deque order of
        the survivors preserved — policy untouched when nothing is
        doomed), doomed RUNNING streams are reclaimed mid-decode via
        ``ContinuousScheduler.cancel`` so their slot admits the next
        request this same tick."""
        now = self.clock.now()

        def doomed(s: TokenStream):
            if s.cancel_requested:
                return "cancel"
            if s.deadline is not None and now >= s.deadline:
                return "deadline"
            return None

        for tenants in self._tiers.values():
            for dq in tenants.values():
                for _ in range(len(dq)):
                    e = dq.popleft()
                    why = doomed(e["stream"])
                    if why is None:
                        dq.append(e)
                        continue
                    self._pending -= 1
                    self.stats.cancelled += 1
                    if why == "deadline":
                        self.stats.expired += 1
                    s = e["stream"]
                    s.cancelled = True
                    s._finish(None, now, False)
        # running rows: st["tag"] is the TokenStream handle the admit
        # phase passed (None under callers that do not stream)
        for st in list(self.sched.active.values()):
            s = st["tag"]
            if s is None:
                continue
            why = doomed(s)
            if why is None:
                continue
            tag, res = self.sched.cancel(st)  # counts stats.cancelled
            if why == "deadline":
                self.stats.expired += 1
            s.cancelled = True
            self._deliver([], [(tag, res)])

    def _drop_pending(self) -> None:
        """Cache capacity is spent: nothing queued can ever start."""
        while self._pending:
            e = self._select(commit=True)
            self._pending -= 1
            self.stats.unserved += 1
            e["stream"]._finish(None, self.clock.now(), False)

    def _tick(self) -> None:
        """One scheduler iteration: budgeted admission, then — if a
        batch is live — either one lockstep decode step or, when the
        cache clock is spent, truncation of every live stream."""
        self._reap()
        self._admit_phase()
        if self.sched.active:
            if self.sched.exhausted():
                self._deliver([], self.sched.truncate())
            else:
                self._step_phase()
        elif self._pending and not self.sched.can_admit():
            self._drop_pending()

    # -- deterministic open-loop runner ---------------------------------

    def simulate(self, trace: List[Request]):
        """Run an open-loop arrival trace to completion on the virtual
        clock — deterministic: no sleeping, every latency a function of
        (trace, StepCost).  Requests arrive at ``Request.arrival_time``
        (clock seconds); the loop jumps idle time.  Returns
        ``(streams, stats)`` with streams in arrival order."""
        if not self.clock.virtual:
            raise TypeError("simulate() needs a VirtualClock "
                            "(real time cannot be replayed)")
        trace = sorted(trace, key=lambda r: r.arrival_time)  # stable
        pre = [self.sched.prepare(r) for r in trace]  # validate up front
        if self.stats is None:
            # closed-trace base clock: the largest bucket the trace
            # needs, matching ``serve_queue`` (byte-identity contract)
            self.open(max((lb for _, lb in pre),
                          default=self.engine.grid.length[0]))
        clock = self.clock
        streams: list = []
        i, n = 0, len(trace)
        try:
            while True:
                if (i < n and not self.sched.active and not self._pending
                        and trace[i].arrival_time > clock.now()):
                    clock.advance_to(trace[i].arrival_time)  # idle: jump
                while i < n and trace[i].arrival_time <= clock.now():
                    streams.append(self.submit_nowait(trace[i], pre[i]))
                    i += 1
                self._tick()
                if (i >= n and not self._pending
                        and not self.sched.active):
                    break
        finally:
            self.close()
        return streams, self.stats

    # -- asyncio loop ----------------------------------------------------

    async def run(self, *, idle_s: float = 1e-3) -> None:
        """Serve until :meth:`request_stop` AND the queue drains.
        Producers ``await submit(...)`` concurrently; each decode step
        yields control so streams are consumed live.  Works on either
        clock: real time for production, virtual for deterministic
        tests (idle waits advance the virtual clock instead of
        sleeping)."""
        if self.stats is None:
            self.open()
        self._running = True
        try:
            while self._running or self._pending or self.sched.active:
                self._tick()
                if self.sched.active or self._pending:
                    await self.clock.sleep(0)
                else:
                    await self.clock.sleep(idle_s)
        finally:
            self.close()

    def request_stop(self) -> None:
        self._running = False
