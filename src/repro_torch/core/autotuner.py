"""The auto-tuner: install-time kernel selection and runtime planning.

A port of the reference package's ``core/autotuner.py``, with its two
stages:

* **install-time** — enumerate candidate block shapes x the kernel
  grammar x grid schedules, filter them by the cost model's on-chip gate,
  rank them by the model, then (``measure="wallclock"``) time the
  short list with the evaluator;
* **runtime** — given a concrete Problem, look the plan up in the
  registry, or produce it.

The measured path is an adaptive short-list search: candidates are
ranked by the (optionally calibrated) model, then measured in rank order
with cached-measurement reuse, stopping once the leader has survived
``stable`` challengers.  A challenger within the leader's dispersion
ties it, and a tie goes to the plan of fewer launches (under the launch
gate; :func:`launch_count`), then to the better model rank, so that
near-equal timings do not pick a different program on every run.  Under
a spec whose gate is the launch model (the H100's), the short list is
first deduped by :func:`launch_key`: plans that launch the same kernels
on the same layouts are timed once, the model-best of them standing for
the rest.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from repro_torch.core import registry
from repro_torch.core.hw import HwSpec, for_device
from repro_torch.core.plan import (BucketGrid, Plan, PlanGrid, PlanSet,
                                   Problem, is_tsmm, schedules_for)
from repro_torch.core.smem_model import (feasible, launch_count, launch_key,
                                         predict)

log = logging.getLogger(__name__)

# The spec trace-time planning ranks against when the caller passes none:
# the device's own spec (``for_device``) unless one was installed with
# set_default_hw (the serving engine installs the calibrated spec, so
# registry misses rank by measured reality, not the data sheet).
_DEFAULT_HW: Optional[HwSpec] = None


def default_hw(device="cuda") -> HwSpec:
    return _DEFAULT_HW if _DEFAULT_HW is not None else for_device(device)


def set_default_hw(hw: Optional[HwSpec]) -> Optional[HwSpec]:
    """Install ``hw`` as the planning default (None: each device's own
    spec); returns the previous one."""
    global _DEFAULT_HW
    prev, _DEFAULT_HW = _DEFAULT_HW, hw
    return prev


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
    pre-packing regime (under the launch gate a tall plan's A natural as
    well as packed) x every grid schedule its kernel supports, ranked by
    the predictive model (stable sort: baseline and default schedule win
    ties)."""
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
        elif c.orientation == "tall_a" and hw.gate == "launch" \
                and not hw.pack_once:
            # on the card tsmm_dot packs a tall A on every call, and the
            # model charges that pack: a natural-A sibling (no pack)
            # competes with each packed plan (a caller that packs A once
            # replays a packed plan only)
            cf = dataclasses.replace(c, prepack=False)
            for spec in specs_for("tall_a", prepack=False):
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


def _transfer_candidates(problem: Problem, hw: HwSpec,
                         device) -> list[Plan]:
    """Winner-transfer warm start: the measured winners of the
    neighbouring bucket shapes (m/2 and 2m, same k/n/dtype), rebased onto
    this problem.  Only measured neighbours transfer; infeasible rebases
    are dropped."""
    out = []
    for m2 in (problem.m // 2, problem.m * 2):
        if m2 < 1 or m2 == problem.m:
            continue
        near = registry.get(dataclasses.replace(problem, m=m2).key(), device)
        if near is None or near.chosen_by != "measured":
            continue
        cand = dataclasses.replace(
            near, problem=problem, chosen_by="model", score=0.0,
            t_compute=0.0, t_memory=0.0)
        if cand.orientation == "skinny_a":
            cand = dataclasses.replace(cand, bm=problem.m)
        if feasible(cand, hw):
            out.append(predict(cand, hw))
    return out


def dedupe_short_list(cands: list, hw: HwSpec) -> list:
    """The short list without repeats: by tuning key, and under the launch
    gate also by :func:`launch_key` (the first, model-best plan of each
    launch stands for it)."""
    seen, out = set(), []
    for c in cands:
        tk = c.tuning_key()
        lk = launch_key(c, hw) if hw.gate == "launch" else None
        if tk in seen or (lk is not None and lk in seen):
            continue
        seen.add(tk)
        if lk is not None:
            seen.add(lk)
        out.append(c)
    return out


def measure_short_list(cands: list, *, top_k: int, stable: int,
                       iters: int, warmup: int, device,
                       hw: Optional[HwSpec] = None,
                       reg: Optional[registry.Registry] = None) -> Plan:
    """The tournament: the model-ranked short list is measured in order
    (cached records of ``reg``, default the process registry, replay for
    free), the leader defending against each challenger, until it has
    beaten ``stable`` challengers in a row.  A challenger that differs
    from the leader by no more than the leader's dispersion (IQR over its
    min) ties; a tie goes to fewer launches under the launch gate of
    ``hw``, then to the earlier place in ``cands``.  Under a ``hw`` with
    ``pack_once`` a packed tall plan is timed on an A packed before the
    call; such records share the tuning keys of per-call timings, so they
    belong in a ``reg`` of their own."""
    from repro_torch.core.evaluator import measure_plan  # lazy: a cycle
    reg = reg or registry.default()
    count = hw is not None and hw.gate == "launch"
    pack_once = hw is not None and hw.pack_once

    def order(rank, plan):
        return (launch_count(plan, hw) if count else 0, rank)

    best, best_rec, best_order, streak, tried = None, None, None, 0, 0
    for rank, plan in enumerate(cands[:max(top_k, 1)]):
        rec = reg.lookup_measurement(plan, device)
        if rec is None:
            rec = measure_plan(plan, device, warmup=warmup, iters=iters,
                               reg=reg, source="autotuner",
                               pack_once=pack_once)
        tried += 1
        if best_rec is not None and abs(rec.seconds - best_rec.seconds) \
                <= best_rec.dispersion * best_rec.seconds:
            wins = order(rank, plan) < best_order
        else:
            wins = best_rec is None or rec.seconds < best_rec.seconds
        if wins:
            best, best_rec, streak = plan, rec, 0
            best_order = order(rank, plan)
        else:
            streak += 1
        if tried >= 2 and streak >= stable:
            break
    log.info("evaluator: measured %d/%d candidates (leader stable after %d)",
             tried, len(cands), streak)
    return dataclasses.replace(best, score=best_rec.seconds,
                               chosen_by="measured")


def make_plan(problem: Problem, hw: Optional[HwSpec] = None, *,
              measure: Optional[str] = None, top_k: int = 3,
              stable: int = 2, iters: int = 5, warmup: int = 2,
              persist: bool = True, force: bool = False,
              device="cuda") -> Plan:
    """Runtime-stage entry: the cached plan for ``device``, or a fresh
    tune stored in the registry.  ``measure="wallclock"`` times the short
    list on ``device`` (model only otherwise).  ``force`` skips the
    lookup and re-tunes; the registry's provenance guard still keeps an
    existing measured winner over a model-ranked challenger, and ``put``
    returns whichever plan stands."""
    hw = hw or default_hw(device)
    if not force:
        cached = registry.get(problem.key(), device)
        if cached is not None:
            return cached

    cands = candidate_blocks(problem, hw)
    if not cands:
        # degenerate shapes: a single-block plan
        plan = predict(
            Plan(problem, "tall_a" if problem.skinny_dim == "n" else "skinny_a",
                 bm=max(problem.m, 8), bk=128,
                 bn=_ceil_to(max(problem.n, 1), 128), prepack=False), hw)
        return registry.put(plan, device, persist=persist)

    if measure == "wallclock":
        # seed the tournament with measured winners of the neighbouring
        # buckets, then the model ranking
        short = dedupe_short_list(
            _transfer_candidates(problem, hw, device) + cands, hw)
        best = measure_short_list(short, top_k=top_k, stable=stable,
                                  iters=iters, warmup=warmup, device=device,
                                  hw=hw)
    else:
        best = cands[0]
    best = registry.put(best, device, persist=persist)
    log.info("autotuned %s", best)
    return best


def plan_for_matmul(m: int, k: int, n: int, dtype: str = "bfloat16",
                    num_shards: int = 1, **kw) -> Optional[Plan]:
    """None if the shape is not tall-and-skinny (caller uses plain GEMM).
    ``num_shards`` keys a per-shard problem (the tall dim split over that
    many ranks)."""
    if not is_tsmm(m, k, n):
        return None
    return make_plan(Problem(m, k, n, dtype, num_shards), **kw)


def make_plan_set(k: int, n: int, buckets: tuple, dtype: str = "bfloat16",
                  hw: Optional[HwSpec] = None, *,
                  measure: Optional[str] = None, persist: bool = True,
                  iters: int = 5, force: bool = False,
                  device="cuda", num_shards: int = 1) -> PlanSet:
    """Per-bucket plans for one (k, n) weight shape; buckets whose
    (m, k, n) is not TSMM-shaped are absent.  ``num_shards`` keys the
    problems of a weight's per-shard (k, n) on a mesh.  With ``persist`` the set is
    written back in ONE registry write, and only if a lookup missed (a
    warm, all-hit call never rewrites the cache file)."""
    misses_before = registry.stats()["misses"]
    plans = {}
    for m in buckets:
        if not is_tsmm(m, k, n):
            continue
        plans[m] = make_plan(Problem(m, k, n, dtype, num_shards), hw,
                             measure=measure, persist=False, iters=iters,
                             force=force, device=device)
    # force-mode re-tunes bypass the lookup, so the miss counter cannot
    # be their write trigger
    tuned = (force and plans) or registry.stats()["misses"] > misses_before
    if persist and tuned:
        registry.flush()
    return PlanSet(plans)


def make_plan_grid(k: int, n: int, grid: BucketGrid, dtype: str = "bfloat16",
                   hw: Optional[HwSpec] = None, *,
                   measure: Optional[str] = None, persist: bool = True,
                   iters: int = 5, force: bool = False,
                   device="cuda") -> PlanGrid:
    """Per-cell prefill plans for one (k, n) shape over a 2D bucket grid:
    cell (bb, lb) -> the plan of the (bb*lb, k, n) problem; cells sharing
    a token count share one plan.  Writes back at most once, as
    ``make_plan_set``."""
    misses_before = registry.stats()["misses"]
    by_tokens = {}
    for m in grid.token_buckets():
        if not is_tsmm(m, k, n):
            continue
        by_tokens[m] = make_plan(Problem(m, k, n, dtype), hw,
                                 measure=measure, persist=False,
                                 iters=iters, force=force, device=device)
    plans = {cell: by_tokens[cell[0] * cell[1]] for cell in grid.cells()
             if cell[0] * cell[1] in by_tokens}
    tuned = (force and by_tokens) or registry.stats()["misses"] > misses_before
    if persist and tuned:
        registry.flush()
    return PlanGrid(grid, plans)
