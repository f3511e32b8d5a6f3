"""Serving engine: batch-adaptive pre-packed decode.

The port of the reference's ``serve/engine.py`` (single device).  At
load, every weight the decode step hits is planned by the autotuner
and packed ONCE into block-major ``PackedTensor``s whose blocks conform
to every power-of-two batch bucket; every decoded token then replays the
bucket's stamped plan through the skinny-A kernel — the paper's
data-reuse scenario, where the pack cost amortizes to zero.  A weight
narrower than ``MIN_COLS`` (GLM-4-9B's (4096, 256) ``wk``/``wv``) stays
unpacked: a long prefill runs it through the planned tall-A kernel, a
decode step through the skinny kernel with a per-call pack.

A request group of any size b <= max_batch is padded to the nearest
bucket; larger groups are split.  A group carries its tokens and the
model's other inputs, a VLM's image ``embeds`` and an encoder-decoder's
``enc_frames`` (bf16, as the reference feeds them), padded and split
with it.  Prefill and decode run as the cells of
a :class:`~repro_torch.serve.programs.ProgramStore`: on a CUDA device one
captured CUDA graph per (kind, bucket, prompt length) cell, replayed on
the store's static buffers (each group's tokens and pad are copied into
the cell's inputs, each bucket keeps one decode cache across groups, and
each step's argmax lands in the decode cell's token buffer); on the CPU,
or in an eager store (``capture=False``), the same cells run eagerly.
:meth:`Engine.precompile` captures the whole grid at load, after which
traffic captures nothing.  A cell captured on first traffic is paid for
inside the timed window (``GenerateResult.compile_s``), as in the
reference.  Times are read through the engine's clock
(``serve/clock.py``): real time after ``torch.cuda.synchronize()``, or on
a ``VirtualClock`` the modelled ``StepCost`` of each operation.

:meth:`Engine.serve_queue` serves a ragged queue from a slot pool
(``serve/scheduler.py``): finished streams free their row mid-flight and
queued requests join the running batch through the store's
``prefill_row`` cells.

After an install sweep (``core/install.py``) on the same shapes, the
engine's start and traffic are registry lookups only.  A lookup that
misses is served at once off the model-ranked plan; with
``background_tune`` the missed problems are then timed on a thread of
their own (its own CUDA stream) and the measured winners committed to
the registry; without it (the fleet mode, DESIGN.md §15) they go to the
persisted miss log, which the fleet's ``tune_service harvest`` turns
into jobs.  With a fleet ``tune_queue`` attached (or
``REPRO_TORCH_TUNE_QUEUE`` set) the background tuner skips the misses
the fleet already owns.

Every ladder demotion on the engine's paths (a planned kernel served by
its plain version or by ``torch.matmul``, a deferred registry flush, an
ignored find-db; DESIGN.md §16) is counted on the engine's own
``DegradeStats``: the pack at load, every cell's capture and eager run,
the scheduler's steps and the miss drain run under it.
:meth:`Engine.health_report` reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.core.linear import serving_ctx
from repro_torch.core.packing import PackedTensor
from repro_torch.core.plan import BucketGrid, Problem, bucket_for, \
    buckets_for, length_buckets_for
from repro_torch.core.tsmm import prepack_for
from repro_torch.models.param import tree_map
from repro_torch.resilience import degrade
from repro_torch.serve.clock import StepCost, ensure_clock
from repro_torch.serve.programs import (ProgramStore, input_dtypes,
                                       precompile_grid, prompt_positions,
                                       ragged_supported)

log = logging.getLogger(__name__)

# Leaves consumed through core.linear (packable), as in the reference.
PACKABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
            "w_out", "head", "wq_a", "wq_b", "wkv_a", "wkv_b"}
MIN_ROWS, MIN_COLS = 512, 512
# Leaves packed zero-padded to whole blocks where no block width divides
# them (the reference leaves them unpacked): the SSM in-projection, whose
# width 2 d_inner + 2 G N + H no multiple of 128 divides at any published
# width, and a tied head (the vocabulary), so no decode step pads or
# packs them per call
PAD_COLS = {"w_in", "head"}


def resolve_device(device) -> torch.device:
    """The serving device: CUDA unless the caller asks for the CPU.  A CUDA
    request without a GPU raises; nothing carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to serve on the CPU")
    return device


def packable_divisors(path, axes_leaf, leaf):
    """(rows, cols, row_shards, col_shards) when the leaf is packed, else
    None (single device: the shard counts are 1)."""
    name = path[-1]
    if name not in PACKABLE or leaf.ndim < 2 or leaf.ndim > 3:
        return None
    if leaf.ndim == 3 and axes_leaf[0] not in ("layers", "groups"):
        return None
    rows, cols = leaf.shape[-2:]
    if rows < MIN_ROWS or cols < MIN_COLS:
        return None
    return rows, cols, 1, 1


def iter_packable(params, axes):
    """Yield (path, leaf, (rows, cols, rs, cs)) for every packable leaf."""
    def walk(p, a, path):
        if isinstance(p, dict):
            for k in p:
                yield from walk(p[k], a[k], path + (k,))
            return
        d = packable_divisors(path, a, p)
        if d is not None:
            yield path, p, d

    yield from walk(params, axes, ())


def tied_head(params, axes) -> tuple:
    """A tied model's head, the transpose of its token table, as a leaf
    ``embed/head`` (d_model, vocab) with its axes: ``unembed`` reads a
    ``head`` in place of ``tok.T``, so the packed copy the engine makes
    of it serves every step; an untied tree is returned as it is."""
    emb = params.get("embed", {})
    if "head" in emb or "tok" not in emb:
        return params, axes
    head = emb["tok"].T.contiguous()
    params = {**params, "embed": {**emb, "head": head}}
    axes = {**axes, "embed": {**axes["embed"], "head": ("embed", "vocab")}}
    return params, axes


def pack_tree_for_serving(params, axes, batch_m):
    """Replace packable weight leaves with planned PackedTensors (a tied
    head first becomes a leaf of its own: :func:`tied_head`).

    ``batch_m``: the serving batch size, or a tuple of batch buckets (the
    chosen blocks conform to every bucket).  Returns (packed_params,
    report: {path: blocks_shape}).  A tied head that does not pack is
    dropped again (``unembed`` reads ``tok.T``)."""
    report = {}
    given = params
    params, axes = tied_head(params, axes)

    def walk(p, a, path):
        if isinstance(p, dict):
            return {k: walk(p[k], a[k], path + (k,)) for k in p}
        if packable_divisors(path, a, p) is None:
            return p
        pk = prepack_for(batch_m, p, pad=path[-1] in PAD_COLS)
        if pk is None:
            return p
        report["/".join(path)] = tuple(pk.blocks.shape)
        return pk

    misses_before = registry.stats()["misses"]
    packed = walk(params, axes, ())
    if params is not given and "embed/head" not in report:
        del packed["embed"]["head"]
    if registry.stats()["misses"] > misses_before:
        registry.flush()   # persist freshly tuned plans in ONE write; after
    return packed, report  # an install sweep every lookup hits, no write


class _BackgroundTuner:
    """Measures registry-missed problems off the serving thread and
    commits the winners.

    On a miss the engine serves at once off the model-ranked plan; the
    missed problem keys are drained here, timed on a daemon thread with
    the adaptive short-list search and the measured winner committed to
    the registry (whose provenance guard keeps it over later model-ranked
    puts).  On a CUDA device the thread launches and times on a CUDA
    stream of its own: every wrapper launches on the current stream, so
    timings on the serving stream would interleave with serving.

    With a fleet tuning ``queue`` attached (DESIGN.md §15) the tuner
    defers to the fleet: a missed key the queue already owns — pending,
    leased by a worker, or measured — is skipped here, so a miss is
    measured once fleet-wide."""

    def __init__(self, hw=None, *, device, top_k: int = 4, stable: int = 2,
                 iters: int = 3, warmup: int = 1, queue=None):
        self.hw = hw
        self.queue = queue
        self.device = torch.device(device)
        self.top_k, self.stable = top_k, stable
        self.iters, self.warmup = iters, warmup
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.committed: list = []
        self._seen: set = set()
        self._threads: list = []
        self._lock = threading.Lock()

    def submit(self, problem_keys: list) -> None:
        with self._lock:
            fresh = [k for k in problem_keys if k not in self._seen]
            self._seen.update(fresh)
        if not fresh:
            return
        t = threading.Thread(target=self._work, args=(fresh,), daemon=True,
                             name="repro-torch-bg-tuner")
        with self._lock:
            self._threads.append(t)
        t.start()

    def busy(self) -> bool:
        with self._lock:
            return any(t.is_alive() for t in self._threads)

    def join(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)

    def _work(self, keys: list) -> None:
        from repro_torch.core.autotuner import make_plan
        if self.queue is not None:
            try:
                fleet_owned = self.queue.active_keys(device=self.device)
            except Exception:            # an unreadable queue: tune here
                log.exception("fleet queue unreadable; tuning locally")
                fleet_owned = set()
            deferred = [k for k in keys if k in fleet_owned]
            keys = [k for k in keys if k not in fleet_owned]
            if deferred:
                log.info("background tuner: %d misses deferred to the "
                         "fleet queue", len(deferred))
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            for key in keys:
                try:
                    cur = registry.peek(key, self.device)
                    if cur is not None and cur.chosen_by == "measured":
                        continue         # already timed
                    plan = make_plan(Problem.from_key(key), self.hw,
                                     measure="wallclock", force=True,
                                     persist=False, top_k=self.top_k,
                                     stable=self.stable, iters=self.iters,
                                     warmup=self.warmup, device=self.device)
                    self.committed.append(plan)
                    log.info("background tuner committed %s", plan)
                except Exception:        # the thread must not die silently
                    log.exception("background tune failed for %s", key)
            if self.stream is not None:
                self.stream.synchronize()
        registry.flush()                 # plans + measurement records


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor          # (B, steps)
    logits_last: torch.Tensor
    prefill_s: float = 0.0
    per_token_s: float = 0.0
    buckets: tuple = ()           # bucket(s) the group was served from
    compile_s: float = 0.0        # acquire seconds of cells cold for it


class Engine:
    """Batch-adaptive greedy-decoding engine with aligned positions.

    The engine owns power-of-two batch buckets 1..max_batch (or the given
    ``buckets``); weights are packed once with blocks conforming to all of
    them.  ``device`` is ``"cuda"`` unless the caller asks for the CPU.
    On CUDA the cells are captured graphs; an eager
    ``ProgramStore(model, device=..., capture=False)`` set as
    ``engine.programs`` serves the same cells without graphs.  ``clock``
    (default real time) and ``step_cost`` (what a virtual clock charges)
    time generation and the scheduler.  ``tune_queue``: a fleet
    ``tuning.queue.JobQueue`` the background tuner defers to (default
    one at ``REPRO_TORCH_TUNE_QUEUE`` when that is set)."""

    def __init__(self, model, params, axes, *, max_len: int,
                 max_batch: Optional[int] = None,
                 buckets: Optional[tuple] = None,
                 max_prompt: Optional[int] = None, min_prompt: int = 8,
                 prepack: bool = True, background_tune: bool = False,
                 tuner_opts: Optional[dict] = None, device="cuda",
                 clock=None, step_cost: Optional[StepCost] = None,
                 tune_queue=None):
        self.device = resolve_device(device)
        self.model = model
        self.clock = ensure_clock(clock)
        self.step_cost = step_cost or StepCost()
        # every demotion on this engine's paths; health_report() reads it
        self.degrade = degrade.DegradeStats()
        if tune_queue is None and os.environ.get("REPRO_TORCH_TUNE_QUEUE"):
            from repro_torch.tuning.queue import JobQueue
            tune_queue = JobQueue()
        self.tune_queue = tune_queue
        # batch buckets whose static cache an open scheduler holds
        self._pools: set = set()
        self.programs = ProgramStore(model, device=self.device)
        self.tuner: Optional[_BackgroundTuner] = None
        if background_tune:
            # misses rank against the measurement-calibrated model, and the
            # missed problems are timed and committed off-thread
            from repro_torch.core import autotuner, evaluator
            hw = evaluator.calibrated_hw(device=self.device)
            autotuner.set_default_hw(hw)
            self.tuner = _BackgroundTuner(hw, device=self.device,
                                          queue=tune_queue,
                                          **(tuner_opts or {}))
        if buckets:
            self.buckets = tuple(sorted(buckets))
            self.max_batch = (min(max_batch, self.buckets[-1])
                              if max_batch is not None else self.buckets[-1])
        else:
            if max_batch is None:
                raise TypeError("Engine needs max_batch or buckets")
            self.max_batch = max_batch
            self.buckets = buckets_for(max_batch)
        self.max_len = max_len
        self.grid = BucketGrid(
            self.buckets,
            length_buckets_for(min(max_prompt or max_len, max_len), min_prompt))
        if self.device.type == "cuda":
            from repro_torch.kernels import cuda
            cuda.load()              # build the kernels outside any timing
        params = tree_map(lambda t: t.to(self.device), params)
        self.pack_report = {}
        if prepack:
            with degrade.use(self.degrade):
                params, self.pack_report = pack_tree_for_serving(
                    params, axes, self.buckets)
            log.info("pre-packed %d weight leaves for buckets %s",
                     len(self.pack_report), self.buckets)
        self.params = params
        self._drain_misses()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stamp_report(self, field: int) -> dict:
        """``m{bucket}_k{k}_n{n}`` -> field ``field`` of each packed
        weight's ``kernel_specs`` stamp entries (1: the KernelSpec, 2: the
        ScheduleSpec), as its key."""
        out = {}

        def walk(p):
            if isinstance(p, dict):
                for v in p.values():
                    walk(v)
            elif isinstance(p, PackedTensor):
                k, n = p.shape[-2:]
                for entry in p.kernel_specs:
                    out[f"m{entry[0]}_k{k}_n{n}"] = entry[field].key()

        walk(self.params)
        return out

    def variant_report(self) -> dict:
        """The kernel variant each packed weight replays per batch bucket
        (``KernelSpec.key()`` values)."""
        return self._stamp_report(1)

    def schedule_report(self) -> dict:
        """The grid schedule each packed weight replays per batch bucket
        (``ScheduleSpec.key()`` values; ``default`` = the pre-schedule
        behaviour)."""
        return self._stamp_report(2)

    def _drain_misses(self) -> None:
        """Hand the registry misses since the last drain to the background
        tuner (serving already ran off the model-ranked plans), or, without
        one, to the persisted miss log.  A no-op when nothing missed."""
        with degrade.use(self.degrade):
            if self.tuner is None:
                registry.flush_misses()
                return
            keys = registry.drain_misses()
        if keys:
            log.info("background-tuning %d registry misses", len(keys))
            self.tuner.submit(keys)

    def bucket_of(self, b: int) -> int:
        return bucket_for(b, self.buckets)

    def claim_pool(self, bucket: int) -> None:
        """An opening scheduler takes ``bucket``'s static cache as its
        slot pool; a second claim, or ``generate`` on the bucket until
        :meth:`release_pool`, raises."""
        if bucket in self._pools:
            raise RuntimeError(f"bucket {bucket}'s cache is already the "
                               f"pool of an open scheduler")
        self._pools.add(bucket)

    def release_pool(self, bucket: int) -> None:
        self._pools.discard(bucket)

    @staticmethod
    def _pad_group(batch: dict, b: int, bucket: int) -> dict:
        if b == bucket:
            return batch
        return {k: (F.pad(v, (0, 0) * (v.ndim - 1) + (0, bucket - b))
                    if v.ndim and v.shape[0] == b else v)
                for k, v in batch.items()}

    def generate(self, batch: dict, steps: int) -> GenerateResult:
        """Serve one request group of ANY size: groups <= max_batch are
        padded to the nearest bucket; larger groups are split."""
        b = batch["tokens"].shape[0]
        if b <= self.max_batch:
            return self._generate_bucket(batch, steps)
        parts = []
        for lo in range(0, b, self.max_batch):
            hi = min(lo + self.max_batch, b)
            parts.append(self._generate_bucket(
                {k: (v[lo:hi] if v.ndim and v.shape[0] == b else v)
                 for k, v in batch.items()}, steps))
        return GenerateResult(
            tokens=torch.cat([r.tokens for r in parts]),
            logits_last=torch.cat([r.logits_last for r in parts]),
            prefill_s=sum(r.prefill_s for r in parts),
            per_token_s=sum(r.per_token_s for r in parts),
            buckets=tuple(bk for r in parts for bk in r.buckets),
            compile_s=sum(r.compile_s for r in parts))

    def precompile(self) -> list:
        """Capture every cell of the engine's grid (each bucket's decode
        step, each (bucket x length bucket) prefill with and without pad
        and the scheduler's ``prefill_row``) into its store; afterwards
        traffic on the grid, aligned or queued, captures nothing.
        Returns the per-cell rows."""
        with degrade.use(self.degrade):
            return precompile_grid(self.model, self.params,
                                   buckets=self.buckets,
                                   lengths=self.grid.length,
                                   max_len=self.max_len, store=self.programs)

    @torch.inference_mode()
    def _generate_bucket(self, batch: dict, steps: int) -> GenerateResult:
        clock, cost = self.clock, self.step_cost
        b = batch["tokens"].shape[0]
        bucket = self.bucket_of(b)
        if bucket in self._pools:
            raise RuntimeError(f"bucket {bucket}'s cache is the slot pool of "
                               f"an open scheduler; close it first")
        width = batch["tokens"].shape[-1]
        filled = prompt_positions(self.model.cfg, width)
        if filled + steps > self.max_len:
            raise ValueError(f"a {filled}-position prompt and {steps} steps "
                             f"do not fit the engine's max_len "
                             f"{self.max_len}")
        dtypes = input_dtypes(self.model.cfg)
        batch = self._pad_group({k: v.to(dtypes.get(k, v.dtype))
                                 for k, v in batch.items()}, b, bucket)
        store = self.programs
        cell = store.static_batch(batch)
        for k, v in batch.items():
            cell[k].copy_(v)
        cache = store.static_cache(bucket, self.max_len)
        tok = store.static_tokens(bucket)
        tokens = torch.empty((bucket, steps), dtype=torch.int32,
                             device=self.device)
        compile_s = 0.0
        with serving_ctx(), degrade.use(self.degrade):
            self._sync()
            # a cold cell's capture runs inside the timed window, so
            # compile_s means what it means in the reference
            t0 = clock.now()
            pprog = store.program("prefill", (self.params, cell, cache),
                                  bucket=bucket, tokens=width)
            logits, _ = pprog.fn(self.params, cell, cache)
            self._sync()
            if clock.virtual:
                if pprog.cold:
                    clock.advance(cost.compile_s)
                clock.advance(cost.prefill_s(bucket * width))
            t1 = clock.now()
            if pprog.cold:
                compile_s += t1 - t0
            tok.copy_(logits[:, -1].argmax(dim=-1, keepdim=True))
            dprog = None
            for i in range(steps):
                tokens[:, i:i + 1].copy_(tok)
                if dprog is None:
                    td = clock.now()
                    dprog = store.program("decode", (self.params, cache, tok),
                                          bucket=bucket, tokens=1)
                    logits, _ = dprog.fn(self.params, cache, tok)
                    if dprog.cold:
                        self._sync()
                        if clock.virtual:
                            clock.advance(cost.compile_s)
                        compile_s += clock.now() - td
                else:
                    logits, _ = dprog.fn(self.params, cache, tok)
                if clock.virtual:
                    clock.advance(cost.decode_step_s)
                # the next step's input, in the decode cell's buffer
                tok.copy_(logits[:, -1].argmax(dim=-1, keepdim=True))
            self._sync()
            t2 = clock.now()
        # a copy: the cell's output buffer is rewritten by its next replay
        logits_last = logits[:b].clone()
        self._drain_misses()
        return GenerateResult(tokens=tokens[:b], logits_last=logits_last,
                              prefill_s=t1 - t0,
                              per_token_s=(t2 - t1) / max(steps, 1),
                              buckets=(bucket,), compile_s=compile_s)

    def ragged_supported(self) -> bool:
        """Whether ragged prompts can be left-padded and masked per row:
        an attention-cache LM with a per-row prefill, fed tokens."""
        return ragged_supported(self.model)

    def serve(self, requests: list, steps: int) -> list:
        """A list of single requests (dicts with 1D ``tokens`` and any
        other per-request keys) becomes one aligned group; every key is
        stacked into it.  Ragged prompt lengths are left-padded to the
        group's length bucket and masked per row (``batch["pad"]``), so
        decode stays lockstep; a model without ragged support refuses
        them.  Returns one GenerateResult per request."""
        if not requests:
            return []
        lens = sorted({int(r["tokens"].shape[-1]) for r in requests})
        keys = requests[0].keys()
        if not self.ragged_supported():
            if len(lens) != 1:
                raise ValueError(
                    f"ragged prompt lengths {lens} need an attention-cache "
                    f"LM (family={self.model.cfg.family}); pad the prompts "
                    f"to a common length for this architecture")
            lb = lens[-1]
        elif lens[-1] > self.grid.max_prompt:
            lb = lens[-1]
        else:
            lb = self.grid.length_bucket(lens[-1])
        if len(lens) == 1 and lens[0] == lb:
            group = {k: torch.stack([torch.as_tensor(r[k]) for r in requests])
                     for k in keys}
        else:
            toks = [torch.as_tensor(r["tokens"]) for r in requests]
            pads = [lb - t.shape[-1] for t in toks]
            group = {"tokens": torch.stack([F.pad(t, (p, 0))
                                            for t, p in zip(toks, pads)]),
                     "pad": torch.tensor(pads, dtype=torch.int32)}
            for k in keys:
                if k not in ("tokens", "pad"):
                    group[k] = torch.stack([torch.as_tensor(r[k])
                                            for r in requests])
        res = self.generate(group, steps)
        return [GenerateResult(tokens=res.tokens[i:i + 1],
                               logits_last=res.logits_last[i:i + 1],
                               prefill_s=res.prefill_s,
                               per_token_s=res.per_token_s,
                               buckets=res.buckets,
                               compile_s=res.compile_s)
                for i in range(len(requests))]

    def serve_queue(self, requests: list, *, slots: Optional[int] = None):
        """Continuous batching: serve a queue of
        :class:`~repro_torch.serve.scheduler.Request`s with different
        prompt lengths and per-request stop state from a fixed slot pool
        (``slots`` snapped to a batch bucket; default ``max_batch``).
        Finished streams free their slot mid-flight and queued requests
        join the running decode batch.  Returns (results, stats)."""
        from repro_torch.serve.scheduler import ContinuousScheduler
        out = ContinuousScheduler(self, slots=slots).run(requests)
        self._drain_misses()
        return out

    def health_report(self) -> dict:
        """Whether this engine serves at full fidelity: every ladder
        demotion since construction (zero on a healthy run — the
        ``launch/serve.py --health`` gate), the breaker's open keys, the
        armed failpoints and the program store's counters."""
        from repro_torch.resilience import failpoints
        rep = self.degrade.report()
        return {
            "healthy": rep["total"] == 0,
            "degradations": rep,
            "failpoints": failpoints.report(),
            "programs": self.programs.stats(),
        }
