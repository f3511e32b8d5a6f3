"""Continuous-batching scheduler: an in-flight slot pool.

The port of the reference's ``serve/scheduler.py`` (DESIGN.md §8, §12),
single device.  The bucketed Engine serves one aligned group at a time:
a stream that finishes early holds its slot until the whole group
drains, and a queued request waits for a full drain.  This module adds
the in-flight slot pool:

* a fixed decode batch of ``slots`` rows shares ONE cache and ONE decode
  cell (the slot count is snapped to a batch bucket, so the pool is the
  store's ``static_cache(slots, max_len)`` and every step replays the
  engine's captured ``decode`` cell for that bucket);
* every row carries per-slot stop state (EOS / max-new-tokens); a
  finished stream frees its row immediately;
* a queued request joins the RUNNING batch through the store's
  ``prefill_row`` cell of its length bucket: its prompt is left-padded to
  the bucket and prefilled into the freed row at the scheduler's clock.

Positions use a single global clock ``T``: a request admitted at clock T
occupies absolute positions ``[T - lb, T)``.  RoPE attention is
relative, so the shift leaves the stream's logits identical (up to float
re-association) to serving it alone at position 0; ``valid_from[row]``
masks the left-pad region and whatever a previous stream left in the
recycled slot.  The clock never rewinds, so the cache capacity
``max_len`` bounds prompt bucket + total decode steps.  The host's ``T``
mirrors the cache's device ``pos``, which the decode cell advances.

The scheduler is a step-driven core: ``open()`` resets the pool,
``admit()`` prefills one request into a free row, ``step()`` runs one
lockstep decode, ``close()`` finalizes telemetry.  ``run()`` (the
closed-loop drain ``Engine.serve_queue`` uses) and the open-loop
:class:`repro_torch.serve.frontend.AsyncEngine` drive the SAME methods,
so the front end's output is byte-identical to ``serve_queue``.  All
time reads go through the engine's :class:`~repro_torch.serve.clock.Clock`;
on a virtual clock each operation charges its
:class:`~repro_torch.serve.clock.StepCost` instead.

Each admission and each step reads the host once: the new tokens, for
the stop checks (the reference makes the same reads).

On a tensor-parallel engine the scheduler runs inside the mesh's
sharding context (``sharding_ctx(eng.mesh, eng.opts)``), as the
reference's does, on every rank with the same host logic.  Every rank
runs every admission (a sharded cell's collectives, FSDP's gathers and
2D tensor parallelism's sums, need the whole group), with the pool's
row: the cell writes the cache row on the rank whose piece holds it
(``models/lm.py::lm_prefill_row``), and every rank reads the request's
first token from its own logits.  Where the data axes split the pool's
compute rows (``Engine.rows_of``; not under 2D tensor parallelism,
where every rank computes every row), a data line feeds its own rows
and each step's tokens are gathered over the data group, so every rank
sees every row's tokens.  While a
scheduler is open its pool's bucket is claimed: ``Engine.generate`` on
that bucket would overwrite the pool's buffers, so it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.linear import serving_ctx
from repro_torch.resilience import degrade
from repro_torch.serve.clock import StepCost, ensure_clock
from repro_torch.serve.programs import row_args
from repro_torch.sharding import comm
from repro_torch.sharding.context import sharding_ctx

log = logging.getLogger(__name__)

# Telemetry-growth bound for per-priority tier stats; override with
# REPRO_TORCH_TIER_STATS_MAX.
TIER_STATS_MAX_DEFAULT = 64


def tier_stats_max() -> int:
    try:
        return int(os.environ.get("REPRO_TORCH_TIER_STATS_MAX",
                                  TIER_STATS_MAX_DEFAULT))
    except ValueError:
        return TIER_STATS_MAX_DEFAULT


def _prompt(tokens) -> np.ndarray:
    """A request's prompt as a 1D int32 host array."""
    if torch.is_tensor(tokens):
        tokens = tokens.detach().cpu().numpy()
    return np.asarray(tokens, np.int32).reshape(-1)


@dataclasses.dataclass
class Request:
    """One queued generation request (ragged: any prompt length).

    ``arrival_time`` / ``priority`` / ``tenant`` exist for the open-loop
    front end and default to values that reproduce the closed-loop
    behaviour; ``deadline`` (absolute clock seconds) expires the stream:
    cancelled in queue, or reclaimed mid-decode."""
    tokens: object                      # 1D int prompt
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    rid: Optional[object] = None
    arrival_time: float = 0.0           # clock seconds (open-loop traces)
    priority: int = 0                   # 0 = most urgent tier
    tenant: str = "default"             # fairness domain within a tier
    deadline: Optional[float] = None

    def to_json(self) -> dict:
        return {
            "tokens": [int(t) for t in _prompt(self.tokens)],
            "max_new_tokens": self.max_new_tokens,
            "eos_id": self.eos_id,
            "rid": self.rid,
            "arrival_time": self.arrival_time,
            "priority": self.priority,
            "tenant": self.tenant,
            "deadline": self.deadline,
        }

    @staticmethod
    def from_json(d: dict) -> "Request":
        """Load a serialized request; records without the open-loop
        fields (arrival / priority / tenant / deadline) get the
        defaults."""
        return Request(
            tokens=np.asarray(d["tokens"], np.int32),
            max_new_tokens=int(d.get("max_new_tokens", 16)),
            eos_id=d.get("eos_id"),
            rid=d.get("rid"),
            arrival_time=float(d.get("arrival_time", 0.0)),
            priority=int(d.get("priority", 0)),
            tenant=str(d.get("tenant", "default")),
            deadline=(None if d.get("deadline") is None
                      else float(d["deadline"])),
        )


@dataclasses.dataclass
class StreamResult:
    rid: object
    tokens: np.ndarray                  # (n_generated,) int32
    prompt_len: int
    length_bucket: int
    admitted_at: int                    # clock position at admission
    finished_at: int
    queue_steps: int                    # decode steps spent waiting
    completed: bool = True


@dataclasses.dataclass
class TierStats:
    """Per-priority-tier serving telemetry."""
    admitted: int = 0
    completed: int = 0
    rejected: int = 0                   # bounced by admission control
    generated_tokens: int = 0
    queue_steps_total: int = 0
    ttft_total_s: float = 0.0           # arrival -> first token (stamped
    ttft_max_s: float = 0.0             # only by the open-loop front end)
    ttft_count: int = 0

    @property
    def mean_queue_steps(self) -> float:
        return self.queue_steps_total / max(self.admitted, 1)

    @property
    def mean_ttft_s(self) -> float:
        return self.ttft_total_s / max(self.ttft_count, 1)

    def note_ttft(self, ttft_s: float) -> None:
        self.ttft_total_s += ttft_s
        self.ttft_max_s = max(self.ttft_max_s, ttft_s)
        self.ttft_count += 1


@dataclasses.dataclass
class SchedulerStats:
    """Telemetry for one ``run`` (printed by ``launch/serve.py --queue``)."""
    slots: int
    steps: int = 0                      # lockstep decode steps executed
    admitted: int = 0
    completed: int = 0
    unserved: int = 0                   # ran out of cache capacity
    rejected: int = 0                   # admission control (queue bound)
    cancelled: int = 0                  # cooperative cancel
    expired: int = 0                    # deadline passed (subset counter)
    prompt_tokens: int = 0              # real prompt tokens prefilled
    prompt_pad_tokens: int = 0          # left-pad tokens prefilled
    generated_tokens: int = 0
    slot_steps_active: int = 0          # sum over steps of live rows
    queue_steps_total: int = 0
    wall_s: float = 0.0
    # acquire time of the cells cold for this run (a capture, or on an
    # eager store the first call), split out of the throughput telemetry
    compile_s: float = 0.0
    # per-priority-tier telemetry, bounded: a client minting a fresh
    # priority per request must not grow it forever (oldest evicts first)
    tiers: dict = dataclasses.field(default_factory=dict)

    def tier(self, priority: int) -> TierStats:
        ts = self.tiers.get(priority)
        if ts is None:
            while len(self.tiers) >= tier_stats_max():
                self.tiers.pop(next(iter(self.tiers)))
            ts = self.tiers[priority] = TierStats()
        return ts

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots decoding a live stream."""
        return self.slot_steps_active / max(self.steps * self.slots, 1)

    @property
    def padding_frac(self) -> float:
        """Fraction of prefilled prompt tokens that were padding."""
        total = self.prompt_tokens + self.prompt_pad_tokens
        return self.prompt_pad_tokens / max(total, 1)

    @property
    def mean_queue_steps(self) -> float:
        """Mean decode steps a request waited before admission."""
        return self.queue_steps_total / max(self.admitted, 1)

    @property
    def tokens_per_s(self) -> float:
        """WARM generated-token throughput: the acquire time of cold
        cells (``compile_s``) is excluded, so a cold and a warm run of
        the same queue report the same serving rate."""
        return self.generated_tokens / max(self.wall_s - self.compile_s, 1e-9)

    @property
    def wall_tokens_per_s(self) -> float:
        """Raw throughput over the full wall clock, compile included."""
        return self.generated_tokens / max(self.wall_s, 1e-9)

    def rows(self) -> list:
        out = [
            ("slots", self.slots),
            ("decode_steps", self.steps),
            ("admitted", self.admitted),
            ("completed", self.completed),
            ("unserved", self.unserved),
            ("rejected", self.rejected),
            ("cancelled", self.cancelled),
            ("expired", self.expired),
            ("generated_tokens", self.generated_tokens),
            ("prompt_tokens", self.prompt_tokens),
            ("prompt_pad_tokens", self.prompt_pad_tokens),
            ("padding_frac", f"{self.padding_frac:.3f}"),
            ("slot_occupancy", f"{self.occupancy:.3f}"),
            ("mean_queue_steps", f"{self.mean_queue_steps:.2f}"),
            ("wall_s", f"{self.wall_s:.3f}"),
            ("compile_s", f"{self.compile_s:.3f}"),
            ("tokens_per_s", f"{self.tokens_per_s:.1f}"),
        ]
        for prio in sorted(self.tiers):
            t = self.tiers[prio]
            out.append((
                f"tier{prio}",
                f"adm={t.admitted} done={t.completed} rej={t.rejected} "
                f"wait={t.mean_queue_steps:.2f}steps "
                f"ttft_mean={t.mean_ttft_s * 1e3:.2f}ms "
                f"ttft_max={t.ttft_max_s * 1e3:.2f}ms"))
        return out


class ContinuousScheduler:
    """Slot-pool scheduler over a bucketed
    :class:`~repro_torch.serve.engine.Engine`.

    Step-driven API: ``open(base_clock)`` → interleave ``admit()`` /
    ``step()`` → ``close()``.  ``admit``/``step`` return ``(emitted,
    finished)`` event lists — ``emitted`` is ``(stream_state, token, t)``
    per generated token (``t`` = clock seconds, the front end's
    streaming/TTFT stamp), ``finished`` is ``(tag, StreamResult)`` where
    ``tag`` is whatever the caller passed to ``admit`` (the closed-loop
    ``run`` passes the request's queue index; the front end passes its
    TokenStream handle).
    """

    def __init__(self, engine, *, slots: Optional[int] = None,
                 clock=None, step_cost: Optional[StepCost] = None):
        if not engine.ragged_supported():
            raise ValueError(
                "continuous batching needs an attention-cache LM "
                f"(family={engine.model.cfg.family}, "
                f"sliding_window={engine.model.cfg.sliding_window})")
        self.engine = engine
        self.clock = ensure_clock(clock if clock is not None
                                  else getattr(engine, "clock", None))
        self.step_cost = (step_cost if step_cost is not None
                          else getattr(engine, "step_cost", None)) or StepCost()
        want = slots or engine.max_batch
        # snap to a batch bucket: the pool replays that bucket's decode
        # cell, planned by the install sweep, on its static cache
        self.slots = engine.bucket_of(min(want, engine.max_batch))
        # the rows this rank holds of the pool (all but on a data split)
        self.rows, self.row0, self.data = engine.rows_of(self.slots)
        self.stats: Optional[SchedulerStats] = None
        self.active: dict = {}
        self.free: list = []
        self._opened = False

    # -- request validation ---------------------------------------------

    def prepare(self, r: Request):
        """Validate one request: returns ``(tokens, length_bucket)`` or
        raises (prompt over the grid ceiling)."""
        toks = _prompt(r.tokens)
        lb = self.engine.grid.length_bucket(toks.shape[0])
        return toks, lb

    # -- lifecycle ------------------------------------------------------

    def open(self, base_clock: int) -> None:
        """Reset the pool's cache at clock position ``base_clock`` (every
        later admission's length bucket must fit below it) and claim its
        bucket."""
        eng = self.engine
        if base_clock >= eng.max_len:
            raise ValueError(
                f"length bucket {base_clock} leaves no decode room in "
                f"max_len={eng.max_len}; raise Engine(max_len=...)")
        if self._opened:
            raise RuntimeError("scheduler already open")
        B = self.slots
        store = eng.programs
        eng.claim_pool(B)
        self.stats = SchedulerStats(slots=B)
        self.T = base_clock
        self._t_open = self.clock.now()
        # what the reference gets from a fresh cache, in place: the clock,
        # idle rows attending to nothing, no slot holding a position
        self.cache = store.static_cache(B, eng.max_len)
        self.cache["pos"].fill_(self.T)
        self.cache["valid_from"].fill_(eng.max_len)
        self.cache["slot_pos"].fill_(-1)
        self.tok = store.static_tokens(self.rows)  # next token fed per row
        self.tok.zero_()
        # cells acquired this open(), per (kind, length bucket): acquire
        # once, charge compile once per store
        self._progs: dict = {}
        self.active = {}
        self.free = list(range(B))
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(serving_ctx())
        self._stack.enter_context(sharding_ctx(getattr(eng, "mesh", None),
                                               getattr(eng, "opts", None)))
        # ladder demotions on this serving path count on the engine's
        # DegradeStats (health_report)
        self._stack.enter_context(
            degrade.use(getattr(eng, "degrade", None) or degrade.GLOBAL))
        self._opened = True

    def close(self) -> SchedulerStats:
        """Exit the serving context, release the pool and finalize
        ``stats.wall_s``."""
        if self._opened:
            self._stack.close()
            self.engine.release_pool(self.slots)
            self.stats.wall_s = self.clock.now() - self._t_open
            self._opened = False
        return self.stats

    # -- state queries --------------------------------------------------

    def can_admit(self) -> bool:
        return bool(self.free) and self.T < self.engine.max_len

    def exhausted(self) -> bool:
        """Cache capacity spent: no decode (or admission) room left."""
        return self.T >= self.engine.max_len

    # -- internals ------------------------------------------------------

    def _finished(self, st) -> bool:
        r, em = st["req"], st["emitted"]
        return (len(em) >= r.max_new_tokens
                or (r.eos_id is not None and em and em[-1] == r.eos_id))

    def _retire(self, st, *, completed=True) -> StreamResult:
        row = st["row"]
        res = StreamResult(
            rid=st["req"].rid if st["req"].rid is not None else st["tag"],
            tokens=np.asarray(st["emitted"], np.int32),
            prompt_len=st["prompt_len"], length_bucket=st["lb"],
            admitted_at=st["admitted_at"], finished_at=self.T,
            queue_steps=st["queue_steps"], completed=completed)
        del self.active[row]
        self.free.append(row)
        self.stats.completed += int(completed)
        self.stats.tier(st["req"].priority).completed += int(completed)
        return res

    def _acquire(self, key, kind: str, args, tokens: int) -> tuple:
        """The held cell of ``key``, or acquire it: (program, cold)."""
        prog = self._progs.get(key)
        if prog is not None:
            return prog, False
        prog = self.engine.programs.program(kind, args, bucket=self.slots,
                                            tokens=tokens)
        self._progs[key] = prog
        return prog, prog.cold

    def _charge_cold(self, tc0: float) -> None:
        """A cold cell's acquire and first call: ``compile_s``."""
        self.engine._sync()
        if self.clock.virtual:
            self.clock.advance(self.step_cost.compile_s)
        self.stats.compile_s += self.clock.now() - tc0

    # -- the two scheduling operations ----------------------------------

    @torch.inference_mode()
    def admit(self, req: Request, toks=None, lb=None, *, tag=None,
              arrival: Optional[float] = None):
        """Prefill one request into a free row of the LIVE batch.

        Returns ``(emitted, finished)``: the first generated token (and,
        for max_new_tokens==1 / instant-EOS streams, the finished
        result).  ``arrival`` (clock seconds) stamps TTFT telemetry on
        the request's tier — the open-loop front end passes it, the
        closed-loop drain does not.
        """
        if not (self._opened and self.free):
            raise RuntimeError("admit needs an open scheduler with a free "
                               "slot")
        eng, stats, clock = self.engine, self.stats, self.clock
        if toks is None or lb is None:
            toks, lb = self.prepare(req)
        row = self.free.pop()
        local = row - self.row0          # the row in this rank's compute
        p = toks.shape[0]
        # every rank admits (a sharded cell's collectives need the whole
        # group; the cell writes the cache row on the rank holding it), so
        # every rank has the request's logits
        padded = np.zeros((1, lb), np.int32)
        padded[0, lb - p:] = toks
        args = row_args(eng.programs, eng.params, self.cache, lb)
        batch = args[1]
        batch["tokens"].copy_(torch.from_numpy(padded))
        batch["pad"].fill_(lb - p)
        args[3].fill_(row)
        args[4].fill_(self.T)
        tc0 = clock.now()
        prog, cold = self._acquire(("prefill_row", lb), "prefill_row",
                                   args, lb)
        logits, _ = prog.fn(*args)
        nxt = logits[0, -1].argmax(dim=-1, keepdim=True)
        if 0 <= local < self.rows:
            self.tok[local].copy_(nxt)
        if cold:
            self._charge_cold(tc0)
        if clock.virtual:
            clock.advance(self.step_cost.prefill_s(lb))
        first = int(nxt[0])              # the admission's host read
        t_tok = clock.now()
        st = {"tag": tag, "req": req, "row": row, "lb": lb,
              "prompt_len": int(p), "emitted": [first],
              "admitted_at": self.T, "queue_steps": stats.steps}
        self.active[row] = st
        stats.admitted += 1
        stats.prompt_tokens += int(p)
        stats.prompt_pad_tokens += lb - p
        stats.queue_steps_total += st["queue_steps"]
        stats.generated_tokens += 1
        tier = stats.tier(req.priority)
        tier.admitted += 1
        tier.queue_steps_total += st["queue_steps"]
        tier.generated_tokens += 1
        if arrival is not None:
            tier.note_ttft(t_tok - arrival)
        emitted = [(st, first, t_tok)]
        finished = []
        if self._finished(st):           # max_new_tokens == 1 / EOS
            finished.append((tag, self._retire(st)))
        return emitted, finished

    @torch.inference_mode()
    def step(self):
        """One lockstep decode step over the whole pool.

        Returns ``(emitted, finished)`` event lists (see class doc)."""
        if not (self._opened and self.active):
            raise RuntimeError("step needs an open scheduler with a live "
                               "stream")
        eng, stats, clock = self.engine, self.stats, self.clock
        args = (eng.params, self.cache, self.tok)
        tc0 = clock.now()
        prog, cold = self._acquire("decode", "decode", args, 1)
        logits, _ = prog.fn(*args)
        # the next step's input, in the decode cell's buffer
        self.tok.copy_(logits[:, -1].argmax(dim=-1, keepdim=True))
        if cold:
            self._charge_cold(tc0)
        if clock.virtual:
            clock.advance(self.step_cost.decode_step_s)
        self.T += 1                      # the cell advanced cache["pos"]
        stats.steps += 1
        stats.slot_steps_active += len(self.active)
        nxt = self.tok[:, 0]
        if self.data is not None:        # every data line's rows
            nxt = comm.all_gather(nxt, self.data, dim=0)
        nxt = nxt.tolist()               # the step's host read
        t_tok = clock.now()
        emitted, finished = [], []
        for row in list(self.active):
            st = self.active[row]
            st["emitted"].append(nxt[row])
            stats.generated_tokens += 1
            stats.tier(st["req"].priority).generated_tokens += 1
            emitted.append((st, nxt[row], t_tok))
            if self._finished(st):
                finished.append((st["tag"], self._retire(st)))
        return emitted, finished

    def cancel(self, st):
        """Retire one RUNNING stream early (cooperative cancel / deadline
        expiry): its row frees immediately and is reused by the next
        admission; the tokens emitted so far come back as a
        ``completed=False`` result.  The cache rows it wrote stay behind
        ``valid_from`` masking on reuse, so other streams are unaffected.
        """
        res = self._retire(st, completed=False)
        self.stats.cancelled += 1
        return st["tag"], res

    def truncate(self):
        """Capacity ran out mid-flight: retire every live stream with
        ``completed=False`` (the cache clock cannot rewind)."""
        finished = []
        for st in list(self.active.values()):
            finished.append((st["tag"], self._retire(st, completed=False)))
        return finished

    # -- closed-loop drain (Engine.serve_queue) -------------------------

    def run(self, requests: List[Request]):
        """Serve the whole queue; returns (results, stats) with results in
        request order."""
        reqs = []
        for r in requests:
            toks, lb = self.prepare(r)   # raises if too long
            reqs.append((r, toks, lb))
        results: list = [None] * len(reqs)
        if not reqs:
            return results, SchedulerStats(slots=self.slots)

        # base clock: the largest length bucket in the queue, so every
        # admission (at clock >= T0) has room for its prompt below it
        self.open(max(lb for _, _, lb in reqs))
        stats = self.stats
        pending = deque(enumerate(reqs))
        try:
            while pending or self.active:
                # -- admission: fill free slots from the queue ----------
                while self.free and pending and not self.exhausted():
                    idx, (r, toks, lb) = pending.popleft()
                    _, finished = self.admit(r, toks, lb, tag=idx)
                    for tag, res in finished:
                        results[tag] = res
                if not self.active:
                    break                # queue empty or out of room
                if self.exhausted():     # cache full: truncate
                    for tag, res in self.truncate():
                        results[tag] = res
                    break
                # -- one lockstep decode step over the whole pool -------
                _, finished = self.step()
                for tag, res in finished:
                    results[tag] = res
        finally:
            self.close()
        # capacity ran out with requests still queued
        for idx, (r, toks, lb) in pending:
            stats.unserved += 1
            results[idx] = StreamResult(
                rid=r.rid if r.rid is not None else idx,
                tokens=np.zeros((0,), np.int32), prompt_len=toks.shape[0],
                length_bucket=lb, admitted_at=-1, finished_at=-1,
                queue_steps=stats.steps, completed=False)
        return results, stats
