"""Performance evaluator — times candidate plans and calibrates the model.

The port of the reference package's ``core/evaluator.py``.  On a CUDA
device it times the hand-written kernels (``impl="cuda"``) with CUDA
events, each call after an L2 flush; on the CPU it times the kernels'
plain versions (``impl="torch"``) on the host clock, so the measurement
machinery runs end to end in the CPU tests.  The device decides: there is
no fallback from one to the other.  Three jobs:

* **measure** — :func:`measure_plan` times the path ``tsmm_dot`` replays
  for the plan (including the per-call packs of a tall A and of a
  non-pre-packed skinny weight), checks the timed callable's output against the serving path
  (:func:`parity_check`) and records a :class:`MeasureRecord`
  (min-of-iters seconds, iteration count, dispersion, provenance) in the
  registry's measurement cache;
* **calibrate** — :func:`fit_hw` least-squares the roofline coefficients
  (effective HBM bandwidth, tensor-core efficiency, per-step overhead in
  ``HwSpec``) from cached measurements, so a handful of timings re-ranks
  every problem;
* **rank** — :func:`measure_plans` returns the measured winner of a
  short list (the autotuner adds the early-stopping tournament).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import packing, registry
from repro_torch.core.hw import H100, HwSpec, for_device
from repro_torch.core.plan import Plan
from repro_torch.core.registry import MeasureRecord, Registry
from repro_torch.core.smem_model import features
from repro_torch.kernels import ops, variants

# fit_hw needs at least this many cached records before it trusts a fit
MIN_FIT_RECORDS = 4
# efficiency assigned to a roofline term the active-set fit DROPPED
# (coefficient clamped to zero): effectively infinite, so predict()
# reproduces the fitted model's zero term instead of re-adding the
# datasheet value the fit rejected
DROPPED_TERM_EFFICIENCY = 1e9


def resolve_impl(device) -> str:
    """``"cuda"`` (the hand-written kernels) on a CUDA device, ``"torch"``
    (their plain versions) on the CPU.  A CUDA device without a GPU
    raises: nothing is timed on the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("evaluator: no CUDA device is available; pass "
                               "device='cpu' to time the plain versions")
        return "cuda"
    if device.type == "cpu":
        return "torch"
    raise ValueError(f"evaluator: unsupported device {device}")


class Timer:
    """CUDA-event timing of single calls, each after an L2 flush (a 256 MB
    write), so every call finds its operands in HBM as the serving path
    does.  The events also take in whatever host time the call spends
    before its launch; ``device=True`` queues a device-side sleep first,
    long enough to hide that, so the events see the device time alone."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=self.device)

    def samples(self, fn: Callable, iters: int = 5, warmup: int = 1,
                device: bool = False) -> list:
        """Milliseconds of each of ``iters`` calls after ``warmup``."""
        for _ in range(warmup):
            fn()
        cycles = 0
        if device:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            fn()
            # ~2e9 cycles a second bounds the H100's SM clock from above
            cycles = int(max(4 * (time.perf_counter() - t0), 1e-4) * 2e9)
            torch.cuda.synchronize(self.device)
        out = []
        stream = torch.cuda.current_stream(self.device)
        for _ in range(iters):
            self.flush.zero_()
            if cycles:
                torch.cuda._sleep(cycles)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            fn()
            e1.record(stream)
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return out

    def __call__(self, fn: Callable, iters: int = 5, warmup: int = 1,
                 device: bool = False) -> float:
        """Mean milliseconds of ``iters`` calls after ``warmup``."""
        ts = self.samples(fn, iters=iters, warmup=warmup, device=device)
        return sum(ts) / len(ts)


@functools.lru_cache(maxsize=None)
def _timer(device: torch.device) -> Timer:
    """One timer (and one flush buffer) per CUDA device."""
    return Timer(device)


def _materialize(plan: Plan, device, seed: int = 0):
    """The plan's operands, made from ``seed`` on ``device``."""
    p = plan.problem
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, p.dtype)
    a = torch.randn((p.m, p.k), generator=g, device=device).to(dt)
    b = torch.randn((p.k, p.n), generator=g, device=device).to(dt)
    return a, b


def build_callable(plan: Plan, device="cuda", *,
                   pack_once: bool = False) -> Callable:
    """A zero-arg callable executing the plan's serving path on operands
    made from a seed on ``device`` (``fn.operands`` holds them).

    Pre-pack cost placement follows what ``tsmm_dot`` replays: a
    ``prepack=True`` skinny plan serves from a load-time PackedTensor, so
    its pack stays outside the timed call (the paper's Eq.7 data-reuse
    case); a ``prepack=False`` skinny plan packs the weight on every call,
    so that pack is timed.  ``tsmm_dot`` packs a tall A on every call too,
    and so does the timed call: a packed tall candidate pays for its pack
    against a natural one (the port's model charges it under the launch
    gate, ``smem_model.call_pack_bytes``).  With ``pack_once`` (a caller
    that packs A once and replays the plan on it, ``HwSpec.pack_once``)
    the tall A is packed before the call and the pack stays outside it,
    as the reference keeps it (its Eq. 7 placement).  The callable
    dispatches through ``kernels.variants.run_*`` with the plan's kernel
    and schedule — the entry point ``tsmm_dot`` replays."""
    resolve_impl(device)
    a, b = _materialize(plan, device)
    spec, sched = plan.kernel, plan.schedule
    if plan.orientation == "tall_a":
        if plan.prepack and pack_once:
            ap = ops.pack_blocks(a, plan.bm, plan.bk)

            def fn():
                return variants.run_tall_a(spec, ap, b, bm=plan.bm,
                                           bk=plan.bk, packed=True,
                                           schedule=sched)
        elif plan.prepack:
            def fn():
                ap = ops.pack_blocks(a, plan.bm, plan.bk)
                return variants.run_tall_a(spec, ap, b, bm=plan.bm,
                                           bk=plan.bk, packed=True,
                                           schedule=sched)
        else:
            def fn():
                return variants.run_tall_a(spec, a, b, bm=plan.bm,
                                           bk=plan.bk, packed=False,
                                           schedule=sched)
    elif plan.prepack:
        wp = ops.pack_blocks(b, plan.bk, plan.bn)

        def fn():
            return variants.run_skinny_a(spec, a, wp, bk=plan.bk, bn=plan.bn,
                                         packed=True, schedule=sched)
    else:
        # tsmm_dot re-packs an unpacked skinny weight every call: the
        # variant owns that cost (a pack-fusing point skips it)
        def fn():
            return variants.run_skinny_a(spec, a, b, bk=plan.bk, bn=plan.bn,
                                         packed=False, schedule=sched)
    fn.operands = (a, b)
    return fn


def _launches() -> int:
    from repro_torch.kernels import cuda
    return sum(cuda.launches.values())


def parity_check(plan: Plan, device="cuda", rtol: float = 1e-2,
                 atol: float = 1e-2, fn: Optional[Callable] = None) -> None:
    """Raise unless the timed callable's output matches the serving path
    (``tsmm_dot`` replaying the same plan on the same operands), so a fast
    wrong kernel never wins.  On a CUDA device the timed call must also
    have launched a kernel: a plain version is never timed there."""
    from repro_torch.core.tsmm import tsmm_dot  # lazy: avoids a cycle
    resolve_impl(device)
    p = plan.problem
    fn = fn or build_callable(plan, device)
    a, b = fn.operands
    cuda_dev = torch.device(device).type == "cuda"
    before = _launches() if cuda_dev else 0
    timed = fn()[:p.m, :p.n].float()
    if cuda_dev and _launches() == before:
        raise AssertionError(f"evaluator: the timed call of {plan} launched "
                             f"no CUDA kernel")
    if plan.orientation == "skinny_a" and plan.prepack:
        # the explicit plan pins the variant (a candidate under
        # measurement is not in the registry yet)
        served = tsmm_dot(a, packing.pack(b, plan.bk, plan.bn), plan=plan)
    else:
        served = tsmm_dot(a, b, plan=plan)
    served = served[:p.m, :p.n].float()
    if not torch.allclose(timed, served, rtol=rtol, atol=atol):
        err = float((timed - served).abs().max())
        raise AssertionError(
            f"evaluator/serving parity failure for {plan}: timed callable "
            f"diverges from tsmm_dot replay (max abs err {err:.3e})")


def time_samples(fn: Callable, *, warmup: int = 2, iters: int = 5,
                 device="cuda") -> list:
    """Per-call seconds after warmup — the shared timing loop of the
    measurement path and the benchmarks (min-of-iters; see
    :func:`measure_plan`).  On a CUDA device: CUDA events around each
    call after an L2 flush (:class:`Timer`); on the CPU: the host clock."""
    device = torch.device(device)
    if resolve_impl(device) == "cuda":
        return [t / 1e3 for t in _timer(device).samples(fn, iters=iters,
                                                        warmup=warmup)]
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def time_callable(fn: Callable, *, warmup: int = 2, iters: int = 5,
                  device="cuda") -> float:
    """Median seconds per call."""
    return float(np.median(time_samples(fn, warmup=warmup, iters=iters,
                                        device=device)))


def _record(plan: Plan, ts: list, device, source: str) -> MeasureRecord:
    best = float(np.min(ts))
    q25, q75 = np.percentile(ts, (25, 75))
    return MeasureRecord(plan=plan, seconds=best, iters=len(ts),
                         dispersion=float((q75 - q25) / max(best, 1e-12)),
                         impl=resolve_impl(device), source=source,
                         wall_time=time.time())


def measure_plan(plan: Plan, device="cuda", *, warmup: int = 2,
                 iters: int = 5, check: bool = True,
                 reg: Optional[Registry] = None,
                 source: str = "evaluator",
                 pack_once: bool = False) -> MeasureRecord:
    """Time one plan (with parity verification) and cache the record.

    ``seconds`` is the FASTEST of the timed calls: noise on a shared
    machine is additive, so the min is the stable estimator of the
    kernel's own cost.  ``dispersion`` (IQR over min) records how noisy
    the samples were.  ``pack_once``: see :func:`build_callable`.  The
    operands are freed when the call returns."""
    fn = build_callable(plan, device, pack_once=pack_once)
    if check:
        parity_check(plan, device, fn=fn)
    ts = time_samples(fn, warmup=warmup, iters=iters, device=device)
    rec = _record(plan, ts, device, source)
    (reg or registry.default()).record_measurement(rec, device)
    return rec


def measure_plans(plans: list, device="cuda", warmup: int = 2, iters: int = 5,
                  *, check: bool = True, reuse: bool = True,
                  reg: Optional[Registry] = None,
                  source: str = "evaluator") -> Plan:
    """Time each candidate, return the winner with its measured score.
    ``reuse`` consults the measurement cache first."""
    if not plans:
        raise ValueError("measure_plans needs at least one candidate plan")
    resolve_impl(device)
    reg = reg or registry.default()
    best, best_rec = None, None
    for plan in plans:
        rec = reg.lookup_measurement(plan, device) if reuse else None
        if rec is None:
            rec = measure_plan(plan, device, warmup=warmup, iters=iters,
                               check=check, reg=reg, source=source)
        if best_rec is None or rec.seconds < best_rec.seconds:
            best, best_rec = plan, rec
    return dataclasses.replace(best, score=best_rec.seconds,
                               chosen_by="measured")


def measure_plans_interleaved(plans: list, device="cuda", *, rounds: int = 4,
                              warmup: int = 2, check: bool = True,
                              reg: Optional[Registry] = None,
                              source: str = "evaluator") -> list:
    """Time a candidate set ROUND-ROBIN and return one record per plan, so
    machine drift spreads over every candidate alike (use this to compare
    candidates, :func:`measure_plan` for one-off timings)."""
    if not plans:
        return []
    reg = reg or registry.default()
    fns = [build_callable(p, device) for p in plans]
    if check:
        for plan, fn in zip(plans, fns):
            parity_check(plan, device, fn=fn)
    for fn in fns:
        time_samples(fn, warmup=warmup, iters=0, device=device)
    samples = [[] for _ in plans]
    for _ in range(max(rounds, 1)):
        for i, fn in enumerate(fns):
            samples[i] += time_samples(fn, warmup=0, iters=1, device=device)
    out = []
    for plan, ts in zip(plans, samples):
        rec = _record(plan, ts, device, source)
        reg.record_measurement(rec, device)
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Calibration: measurements -> fitted HwSpec
# ---------------------------------------------------------------------------


def fit_hw(records: list, hw: HwSpec = H100) -> HwSpec:
    """Least-squares the roofline coefficients from measurement records.

    Solves ``t_i ~= c_m * t_mem_i + c_c * t_cmp_i + oh * steps_i`` over
    the nominal-roofline features of each record's plan, rows weighted by
    ``1/t_i`` (relative error).  A one-pass active-set projection keeps
    coefficients non-negative; the map back is ``hbm_efficiency = 1/c_m``,
    ``mxu_efficiency = 1/c_c``, ``grid_overhead_s = oh``, and a dropped
    coefficient maps to ``DROPPED_TERM_EFFICIENCY``.  Returns ``hw``
    unchanged (uncalibrated) with fewer than ``MIN_FIT_RECORDS`` records
    or a degenerate design matrix."""
    if len(records) < MIN_FIT_RECORDS:
        return hw
    A = np.asarray([features(r.plan, hw) for r in records], np.float64)
    t = np.asarray([r.seconds for r in records], np.float64)
    if (t <= 0).any():
        return hw
    W = A / t[:, None]                   # relative-error weighting
    ones = np.ones(len(t))
    free = [0, 1, 2]
    coefs = np.zeros(3)
    for _ in range(3):
        sub = W[:, free]
        if np.linalg.matrix_rank(sub) < len(free):
            return hw
        x, *_ = np.linalg.lstsq(sub, ones, rcond=None)
        if (x >= 0).all():
            for j, c in zip(free, x):
                coefs[j] = c
            break
        drop = free[int(np.argmin(x))]   # most-negative coefficient -> 0
        free = [j for j in free if j != drop]
        if not free:
            return hw
    else:
        return hw
    c_m, c_c, oh = coefs
    return dataclasses.replace(
        hw,
        hbm_efficiency=(1.0 / c_m) if c_m > 0 else DROPPED_TERM_EFFICIENCY,
        mxu_efficiency=(1.0 / c_c) if c_c > 0 else DROPPED_TERM_EFFICIENCY,
        grid_overhead_s=max(oh, 0.0),
        calibrated=True,
    )


def calibrated_hw(hw: Optional[HwSpec] = None,
                  reg: Optional[Registry] = None, *,
                  device="cuda") -> HwSpec:
    """Fit ``hw`` (default: ``device``'s spec) from the measurement cache
    of ``device``'s platform.  With too few records the nominal spec comes
    back (``.calibrated`` stays False)."""
    hw = hw or for_device(device)
    reg = reg or registry.default()
    return fit_hw(reg.measurements(device), hw)


def spearman(a, b) -> float:
    """Spearman rank correlation (average ranks for ties; no scipy)."""
    def _ranks(x):
        x = np.asarray(x, np.float64)
        order = np.argsort(x, kind="stable")
        ranks = np.empty_like(x)
        ranks[order] = np.arange(len(x), dtype=np.float64)
        # average tied ranks so equal predictions don't fake correlation
        for v in np.unique(x):
            m = x == v
            ranks[m] = ranks[m].mean()
        return ranks
    ra, rb = _ranks(a), _ranks(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / (sa * sb))
