"""Fleet tuning workers (DESIGN.md §15), the port of the reference
package's ``tuning/worker.py``: MITuna's ``builder.py`` /
``evaluator.py`` split over the port's tuning stack.

One worker process drains the job queue for its own device's platform:

* :class:`Builder` turns a claimed job into a build-validated short
  list.  It re-enumerates the grammar candidate space under the
  CALIBRATED model (``evaluator.calibrated_hw`` — the fleet's pooled
  measurement cache makes the prune sharper than any single host's),
  seeds with the winner-transfer warm start, restricts to the job's
  harvested payload when the grammar version still matches, and
  launches each survivor once at its shape on seeded operands
  (``core/evaluator.py::build_callable``), then synchronizes.  Where
  the reference AOT-lowers each candidate, the port's kernels are built
  ahead of time (``kernels/cuda.py``), so its build check is the launch:
  a plan that the host-side launch plan or TMA check refuses, or whose
  launch fails on the host, is pruned HERE, so the evaluator never
  spends stopwatch time on it.  A kernel library that did not build and
  an error after an enqueue are the card's, not one plan's: they stop
  the worker (:data:`CARD_ERRORS`).
* :class:`Evaluator` runs the adaptive tournament
  (``autotuner.measure_short_list`` — cached-measurement reuse,
  early-stop once the leader is stable) with ``core/evaluator.py``'s
  timing and parity checks, and commits the measured winner and the
  measurement records through the registry's two-writer-safe
  flush-merge: concurrent workers flushing different problems never lose
  each other's wins, and the provenance guard keeps an existing measured
  winner over a model-ranked challenger.

:func:`run_worker` is the process body the ``tune_service work`` CLI
starts N of, each a fresh interpreter.  Workers on one card time their
candidates on it at the same time, so their timings contend; the fleet's
gate is that every job is resolved exactly once, not the timings.  Fault
injection rides the failpoint plane: arming ``worker.claim.after`` /
``worker.build.after`` with a ``crash`` action (or
``REPRO_TORCH_TUNE_CRASH=after-claim|after-build``) hard-kills the
process there — what a killed worker looks like, the hook of the lease
requeue tests.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from repro_torch.kernels import cuda
from repro_torch.resilience import failpoints

log = logging.getLogger(__name__)

# what no plan is at fault for: the worker releases its job and stops
CARD_ERRORS = (cuda.KernelBuildError, cuda.KernelLaunchError)

# builder short-list depth: how many model-ranked candidates get a build
# launch; the evaluator's tournament then early-stops within these
DEFAULT_BUILD_K = 8

# transient claim failures (lock timeout, injected queue fault) retried
# with linear backoff before the worker gives up
CLAIM_RETRIES = 3


@dataclasses.dataclass
class BuiltCandidate:
    """One builder output: a plan that launched cleanly (or the reason it
    did not)."""
    plan: object
    ok: bool
    build_s: float = 0.0
    error: str = ""


class Builder:
    """Candidate enumeration + calibrated prune + build-launch check on
    ``device``."""

    def __init__(self, *, build_k: int = DEFAULT_BUILD_K, reg=None,
                 device="cuda"):
        from repro_torch.core import registry
        self.build_k = build_k
        self.device = torch.device(device)
        self.reg = reg if reg is not None else registry.default()
        self._hw = None

    def hw(self):
        """Calibrated model, fitted once per worker from the pooled
        measurement cache (fresh workers on an unmeasured fleet fall
        back to the device's nominal spec)."""
        if self._hw is None:
            from repro_torch.core.autotuner import default_hw
            from repro_torch.core.evaluator import calibrated_hw
            self._hw = calibrated_hw(default_hw(self.device), reg=self.reg,
                                     device=self.device)
        return self._hw

    def shortlist(self, job) -> list:
        """Model-ranked candidate plans for one job, warm-started and
        (when the payload's grammar version is current) restricted to
        the harvested candidate set."""
        from repro_torch.core.autotuner import (_transfer_candidates,
                                                candidate_blocks)
        from repro_torch.core.plan import Problem
        from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION

        problem = Problem.from_key(job.problem_key)
        hw = self.hw()
        warm = _transfer_candidates(problem, hw, self.device)
        cands = candidate_blocks(problem, hw)
        if job.candidates and job.grammar_version == GRAMMAR_VERSION:
            payload = set(job.candidates)
            narrowed = [c for c in cands if c.tuning_key() in payload]
            # a stale payload (grammar point renamed, ladder moved) must
            # not empty the search — fall back to the full enumeration
            if narrowed:
                cands = narrowed
        seen, out = set(), []
        for c in warm + cands:
            tk = c.tuning_key()
            if tk not in seen:
                seen.add(tk)
                out.append(c)
        return out[:max(self.build_k, 1)]

    @torch.inference_mode()
    def build(self, job) -> list:
        """Launch every short-listed plan once at its shape through the
        dispatch ``tsmm_dot`` replays and synchronize; return the
        survivors (plus failures, flagged, for the report).  A plan the
        host refuses, or that fails otherwise, is pruned; the card's own
        errors (a library that did not build, an error after an enqueue)
        are no plan's and raise."""
        from repro_torch.core.evaluator import build_callable

        out = []
        for plan in self.shortlist(job):
            t0 = time.perf_counter()
            try:
                fn = build_callable(plan, self.device)
                fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                del fn
                out.append(BuiltCandidate(plan, True,
                                          time.perf_counter() - t0))
            except CARD_ERRORS:
                raise
            except Exception as e:  # noqa: BLE001 — any other one: prune
                out.append(BuiltCandidate(plan, False,
                                          time.perf_counter() - t0,
                                          f"{type(e).__name__}: {e}"))
                log.info("builder: pruned %s (%s)", plan.tuning_key(), e)
        return out


class Evaluator:
    """Tournament measurement + registry commit on ``device``."""

    def __init__(self, *, top_k: int = 4, stable: int = 2, iters: int = 3,
                 warmup: int = 1, reg=None, device="cuda", hw=None):
        from repro_torch.core import registry
        self.top_k = top_k
        self.stable = stable
        self.iters = iters
        self.warmup = warmup
        self.device = torch.device(device)
        self.hw = hw
        self.reg = reg if reg is not None else registry.default()

    @torch.inference_mode()
    def evaluate(self, built: list):
        """Measure the build survivors, commit the winner and the records
        (flush-merge + provenance guard) and return the plan that stands
        in the registry."""
        from repro_torch.core.autotuner import measure_short_list

        cands = [b.plan for b in built if b.ok]
        if not cands:
            raise RuntimeError(
                "no candidate survived the build stage: "
                + "; ".join(b.error for b in built if not b.ok))
        winner = measure_short_list(cands, top_k=self.top_k,
                                    stable=self.stable, iters=self.iters,
                                    warmup=self.warmup, device=self.device,
                                    hw=self.hw, reg=self.reg)
        stands = self.reg.put(winner, self.device, persist=False)
        self.reg.flush()
        return stands


@dataclasses.dataclass
class WorkReport:
    """One worker run's ledger (the CLI prints it; tests assert on it)."""
    worker: str
    done: int = 0
    failed: int = 0
    seconds: float = 0.0
    results: tuple = ()          # (job_id, winning tuning_key) pairs

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["results"] = [list(r) for r in self.results]
        return d


def run_worker(queue=None, *, worker_id: Optional[str] = None,
               max_jobs: Optional[int] = None,
               lease_s: float = 120.0, platform: Optional[str] = None,
               device="cuda", build_k: int = DEFAULT_BUILD_K, top_k: int = 4,
               stable: int = 2, iters: int = 3, warmup: int = 1,
               idle_exit: bool = True, poll_s: float = 0.5) -> WorkReport:
    """Claim-build-measure-commit on ``device`` until the queue runs dry.

    Each job is one claim -> :class:`Builder` -> :class:`Evaluator` ->
    ``complete`` round trip; any exception releases the job with
    ``fail`` (back to pending under the attempts cap, so a transient
    measurement error retries on another worker).  The card's own errors
    (:data:`CARD_ERRORS`) release the job and then raise: the context
    may be poisoned, so this worker stops instead of failing every job
    it would claim next.  With ``idle_exit`` (the CLI default) the worker
    exits when nothing is claimable."""
    from repro_torch.tuning.queue import JobQueue, default_worker_id

    queue = queue or JobQueue()
    worker_id = worker_id or default_worker_id()
    builder = Builder(build_k=build_k, device=device)
    evaluator = None
    report = WorkReport(worker=worker_id)
    t0 = time.perf_counter()
    claim_failures = 0
    while max_jobs is None or report.done + report.failed < max_jobs:
        try:
            job = queue.claim(worker_id, lease_s=lease_s, platform=platform,
                              device=device)
        except Exception as e:  # noqa: BLE001 — lock timeout / queue fault
            claim_failures += 1
            if claim_failures > CLAIM_RETRIES:
                log.warning("worker %s: claim failed %d times (%s); "
                            "giving up", worker_id, claim_failures, e)
                break
            log.warning("worker %s: claim failed (%s); retry %d/%d",
                        worker_id, e, claim_failures, CLAIM_RETRIES)
            time.sleep(poll_s * claim_failures)   # linear backoff
            continue
        claim_failures = 0
        if job is None:
            if idle_exit:
                break
            time.sleep(poll_s)
            continue
        failpoints.fp("worker.claim.after")
        log.info("worker %s: claimed %s (priority %d, attempt %d)",
                 worker_id, job.job_id, job.priority, job.attempts)
        try:
            built = builder.build(job)
            failpoints.fp("worker.build.after")
            if evaluator is None:
                evaluator = Evaluator(top_k=top_k, stable=stable,
                                      iters=iters, warmup=warmup,
                                      device=device, hw=builder.hw())
            winner = evaluator.evaluate(built)
        except CARD_ERRORS as e:
            log.error("worker %s: job %s hit the card's error (%s); "
                      "releasing it and stopping", worker_id, job.job_id, e)
            queue.fail(job.job_id, worker_id, error=f"{type(e).__name__}: {e}")
            raise
        except Exception as e:  # noqa: BLE001 — release, let a retry happen
            log.warning("worker %s: job %s failed (%s)", worker_id,
                        job.job_id, e)
            queue.fail(job.job_id, worker_id, error=f"{type(e).__name__}: {e}")
            report.failed += 1
            continue
        if queue.complete(job.job_id, worker_id,
                          result=winner.tuning_key()):
            report.done += 1
            report.results += ((job.job_id, winner.tuning_key()),)
        else:
            # lease expired under us and the job was reassigned: our
            # measurement still landed in the measurement cache, but the
            # ledger credits the current holder
            log.warning("worker %s: lost lease on %s before complete",
                        worker_id, job.job_id)
            report.failed += 1
    report.seconds = time.perf_counter() - t0
    return report
