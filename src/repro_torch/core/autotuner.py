"""The auto-tuner's runtime stage: model-ranked plan generation.

A port of the reference package's ``core/autotuner.py``: candidate
enumeration (block shapes x the kernel grammar x grid schedules), the
predictive-model prune and rank, and the registry-backed ``make_plan`` /
``make_plan_set`` / ``plan_for_matmul``.  Only the model-ranked path is
here; measurement, winner transfer and the tournament are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import registry
from repro_torch.core.hw import HwSpec, for_device
from repro_torch.core.plan import Plan, PlanSet, Problem, is_tsmm, schedules_for
from repro_torch.core.smem_model import feasible, predict


def _pow2_below(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def candidate_blocks(problem: Problem, hw: HwSpec) -> list[Plan]:
    """Every feasible candidate plan for one problem, best first: block
    shapes x every grammar point emittable for the orientation and
    pre-packing regime x every grid schedule its kernel supports, ranked
    by the predictive model (stable sort: baseline and default schedule
    win ties)."""
    from repro_torch.kernels.variants import specs_for
    orientation = "tall_a" if problem.skinny_dim == "n" else "skinny_a"
    sl = hw.sublane.get(problem.dtype, 8)
    cands: list[Plan] = []

    if orientation == "tall_a":
        n_pad = _ceil_to(problem.n, 128)
        bms = {256, 512, 1024, 2048, 4096, _pow2_below(max(problem.m, sl))}
        bks = {128, 256, 512, 1024, 2048, _pow2_below(max(problem.k, 128))}
        for bm in sorted(bms):
            for bk in sorted(bks):
                if bm > max(problem.m, sl) or bk > max(problem.k, 128):
                    continue
                cands.append(Plan(problem, "tall_a", bm=bm, bk=bk, bn=n_pad))
    else:
        bns = {128, 256, 512, 1024, 2048}
        bks = {128, 256, 512, 1024, 2048, _pow2_below(max(problem.k, 128))}
        for bn in sorted(bns):
            for bk in sorted(bks):
                if bn > _ceil_to(problem.n, 128) or bk > max(problem.k, 128):
                    continue
                cands.append(Plan(problem, "skinny_a", bm=problem.m, bk=bk,
                                  bn=bn))

    expanded = []
    for c in cands:
        for spec in specs_for(c.orientation, c.prepack):
            expanded.append(
                c if spec == c.kernel else dataclasses.replace(c, kernel=spec))
        if c.orientation == "skinny_a" and c.prepack:
            # the natural-weight call path re-packs per call: a
            # prepack=False sibling lets pack-fusing points compete (they
            # come after their prepack=True twins, so ties keep those)
            cf = dataclasses.replace(c, prepack=False)
            for spec in specs_for("skinny_a", prepack=False):
                expanded.append(dataclasses.replace(cf, kernel=spec))

    scheduled = []
    for c in expanded:
        for sched in schedules_for(c.orientation, c.kernel):
            scheduled.append(
                c if sched.is_default
                else dataclasses.replace(c, schedule=sched))

    out = [predict(c, hw) for c in scheduled if feasible(c, hw)]
    out.sort(key=lambda p: p.score)
    return out


def make_plan(problem: Problem, hw: Optional[HwSpec] = None, *,
              device="cuda") -> Plan:
    """Cached plan for ``device``, or the model's best candidate (stored
    in the registry)."""
    hw = hw or for_device(device)
    cached = registry.get(problem.key(), device)
    if cached is not None:
        return cached
    cands = candidate_blocks(problem, hw)
    if not cands:
        # degenerate shapes: a single-block plan
        best = predict(
            Plan(problem, "tall_a" if problem.skinny_dim == "n" else "skinny_a",
                 bm=max(problem.m, 8), bk=128,
                 bn=_ceil_to(max(problem.n, 1), 128), prepack=False), hw)
        return registry.put(best, device)
    return registry.put(cands[0], device)


def plan_for_matmul(m: int, k: int, n: int, dtype: str = "bfloat16",
                    **kw) -> Optional[Plan]:
    """None if the shape is not tall-and-skinny (caller uses plain GEMM)."""
    if not is_tsmm(m, k, n):
        return None
    return make_plan(Problem(m, k, n, dtype), **kw)


def make_plan_set(k: int, n: int, buckets: tuple, dtype: str = "bfloat16",
                  hw: Optional[HwSpec] = None, *,
                  device="cuda") -> PlanSet:
    """Per-bucket plans for one (k, n) weight shape; buckets whose
    (m, k, n) is not TSMM-shaped are absent."""
    plans = {}
    for m in buckets:
        if is_tsmm(m, k, n):
            plans[m] = make_plan(Problem(m, k, n, dtype), hw, device=device)
    return PlanSet(plans)
