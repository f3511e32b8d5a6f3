"""The cache-blocked designer's predictive model, on the H100.

A port of the reference package's ``core/vmem_model.py``: the same
per-axis HBM-traffic terms, roofline and per-step overhead, so that a
spec built from the reference's TPU numbers ranks plans byte-identically.

The on-chip gate (:func:`feasible`) is chosen by ``HwSpec.gate``:

* ``"vmem"`` — the reference's gate.  On the TPU a plan's ``(bk, bn)`` is
  both the packed layout and the VMEM block one grid step holds, so its
  double-buffered working set (:func:`vmem_bytes_needed`) is charged
  against ``HwSpec.vmem_bytes``.  A spec rebuilt from the reference's
  fields keeps it, and with it the reference's enumeration and ranking.
* ``"launch"`` (the H100 spec) — a model of the launches the plan
  produces on the card (:func:`plan_launches`).  The CUDA kernels' CTA
  tile is their own, far smaller than the layout block, so a plan is
  feasible when every wrapper it would run takes its layout
  (``kernels/tsmm.py::tall_plan``, ``skinny_plan`` and, for a per-call
  pack, ``pack_plan`` do not raise) and each chosen launch plan's shared
  memory fits ``HwSpec.vmem_bytes`` (the 227 KB one CTA may opt into).

Both gates keep the grammar's structural and k-split rules.  Under the
launch gate the memory term also charges the pack ``tsmm_dot`` makes of
a tall A on every call of a packed tall plan (:func:`call_pack_bytes`),
which the evaluator times with the call; the reference amortizes it, and
so does a spec with ``HwSpec.pack_once`` (the paper's data reuse).  The
launch gate also prices how well the plan's kernel fills the card
(:func:`occupancy`): a launch of too few CTAs, or a last wave that leaves
SMs idle, scales its compute term up.
:func:`launch_key` names the launches a plan produces: plans that differ
only in axes the card does not see (``m_split``, ``dims``,
``multibuffer``, a natural A's ``bm``) share a key, and the measured
tournament times each key once.

The paper's Eq.2/Eq.3 cache bounds become this gate; the model ranks
every grammar point (:class:`~repro_torch.kernels.variants.grammar.GenSpec`)
through the same per-axis terms as the reference.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hw import H100, VMEM_USABLE_FRACTION, HwSpec, dtype_bytes
from repro_torch.core.plan import SEMANTICS, Plan, Problem
from repro_torch.kernels.variants import grammar
from repro_torch.kernels.variants.grammar import GenSpec, from_kernel_spec

# The per-contraction-step overhead lives on ``HwSpec.grid_overhead_s``
# so the calibration pass (``core/evaluator.py::fit_hw``) can fit it.


def nominal(hw: HwSpec) -> HwSpec:
    """``hw`` with the calibration coefficients reset — the datasheet
    roofline the fit regresses against (see :func:`features`)."""
    return dataclasses.replace(hw, mxu_efficiency=1.0, hbm_efficiency=1.0,
                               calibrated=False)


def _ceil(a, b):
    return -(-a // b)


def _gen(plan: Plan) -> GenSpec:
    """The plan's grammar point — the kernel dimension of the cost model
    (DESIGN.md §10, §14).  Raises ValueError for an undecodable spec
    (:func:`feasible` turns that into infeasibility)."""
    return from_kernel_spec(plan.kernel)


def contraction_steps(plan: Plan) -> int:
    """SERIAL k-axis steps the plan's grammar point executes — the unit
    the fitted per-step overhead multiplies (``HwSpec.grid_overhead_s``).
    A k-split point runs its partial sums in parallel, so each chain is
    ``nk / ksplit`` long; every other point walks all nk blocks."""
    nk = plan.grid[1]
    g = _gen(plan)
    if g.ksplit > 1:
        return max(1, nk // g.ksplit)
    return nk


def grid_rank(plan: Plan) -> int:
    """Rank of the Pallas grid the plan's (grammar point, schedule)
    launches — what a ``dims`` override must match to apply
    (DESIGN.md §11)."""
    g = _gen(plan)
    if g.ksplit > 1:
        return 3              # (panel, split, k-within-split)
    if plan.orientation == "tall_a" and g.loop == "kouter":
        return 1              # fori_loop of single-axis row-panel passes
    base = 2
    if plan.orientation == "tall_a" and plan.schedule.m_split > 1:
        base += 1             # the extra leading M-partition parallel axis
    return base


def overhead_steps(plan: Plan, hw: HwSpec = H100) -> float:
    """Schedule-aware per-step overhead count — the regressor the fitted
    ``HwSpec.grid_overhead_s`` multiplies (DESIGN.md §9/§11).

    * the serial k-chain (``contraction_steps``) dominates, scaled by
      ``2 / multibuffer``: classic double buffering exposes one DMA-issue
      slot per step, deeper buffering hides proportionally more of it
      (at ``multibuffer``x the streamed-operand VMEM footprint, gated by
      :func:`feasible`);
    * each extra M-partition adds one per-partition launch/semaphore
      overhead (``m_split - 1``).

    * a ``loop=kouter`` point makes one kernel launch per k block, each
      ``hw.launch_steps`` steps (0 under the reference's fields).

    A default schedule reproduces ``contraction_steps`` exactly, so
    calibration fits over pre-schedule measurement records are
    unchanged."""
    sched = plan.schedule
    steps = contraction_steps(plan) * (2.0 / max(sched.multibuffer, 2))
    if hw.launch_steps and plan.orientation == "tall_a" \
            and _gen(plan).loop == "kouter":
        steps += plan.grid[1] * hw.launch_steps
    return steps + (sched.m_split - 1)


def vmem_bytes_needed(plan: Plan, hw: HwSpec = H100) -> int:
    """Working set of one grid step, with ``schedule.multibuffer``-deep
    buffering on the streamed k-loop operands (2 = the classic double
    buffering the pre-schedule model assumed) and a single fp32
    accumulator (the Pallas pipeline's actual residency).  Grammar-aware:
    ``bres=resident`` holds the WHOLE streamed operand (never swapped, so
    no multibuffering on it), ``acc=revisit`` trades the VMEM scratch
    accumulator for an fp32 output block, ``loop=kouter`` additionally
    streams that fp32 block back in as an aliased input, and k-split
    points stream fp32 partial blocks out."""
    p = plan.problem
    eb = dtype_bytes(p.dtype)
    g = _gen(plan)
    mb = max(plan.schedule.multibuffer, 2)
    if plan.orientation == "tall_a":
        n_pad = _ceil(p.n, 128) * 128
        a = mb * plan.bm * plan.bk * eb
        b = mb * plan.bk * n_pad * eb
        acc = plan.bm * n_pad * 4
        out = 2 * plan.bm * n_pad * eb
        if g.loop == "kouter":
            # no VMEM scratch, but the aliased fp32 accumulator streams
            # through as BOTH an input block and the output block
            # (input_output_aliases shares HBM, not the VMEM windows)
            acc = 2 * plan.bm * n_pad * 4
            out = 2 * plan.bm * n_pad * 4
        elif g.ksplit > 1:
            out = 2 * plan.bm * n_pad * 4                   # fp32 partials
        elif g.acc == "revisit":
            acc = 0                                         # o_ref IS it
            out = 2 * plan.bm * n_pad * 4
        if g.bres == "resident":
            b = _ceil(p.k, plan.bk) * plan.bk * n_pad * eb  # full B, once
    else:  # skinny_a
        sl = hw.sublane.get(p.dtype, 8)
        m_pad = _ceil(p.m, sl) * sl
        a = mb * m_pad * plan.bk * eb         # streamed X panel
        b = mb * plan.bk * plan.bn * eb       # streamed W block
        acc = m_pad * plan.bn * 4
        out = 2 * m_pad * plan.bn * eb
        if g.ksplit > 1:
            out = 2 * m_pad * plan.bn * 4                   # fp32 partials
        elif g.acc == "revisit":
            acc = 0
            out = 2 * m_pad * plan.bn * 4
        if g.bres == "resident":
            a = m_pad * _ceil(p.k, plan.bk) * plan.bk * eb  # full X, once
    return a + b + acc + out


def feasible(plan: Plan, hw: HwSpec = H100) -> bool:
    p = plan.problem
    if plan.bm <= 0 or plan.bk <= 0 or plan.bn <= 0:
        return False
    # MXU/tile alignment: lane dim multiples of 128, sublane of 8/16
    if plan.bk % 128 or plan.bn % 128:
        return False
    sl = hw.sublane.get(p.dtype, 8)
    if plan.orientation == "tall_a" and plan.bm % sl:
        return False
    try:
        g = _gen(plan)
    except ValueError:
        return False          # undecodable spec (unknown name/axis/value)
    # the grammar's structural + orientation rules gate the whole point
    # (kouter is tall-A only, pack fusion needs an unpacked weight, ...)
    if not grammar.valid(g, plan.orientation, plan.prepack):
        return False
    if g.ksplit > 1:
        # the split must cut the k-block count evenly into >= 2 chains,
        # or the schedule degenerates to the baseline
        if plan.grid[1] % g.ksplit:
            return False
    # grid-schedule gates (DESIGN.md §11)
    sched = plan.schedule
    if sched.m_split < 1 or not 2 <= sched.multibuffer <= 4:
        return False
    if g.loop == "kouter" and not sched.is_default:
        return False          # no streamed-operand pipeline to re-schedule
    if sched.m_split > 1:
        # M partitioning: tall-A only, k-inner unsplit points only (the
        # row-panel axis must be the leading parallel grid axis), and the
        # partition count must cut it evenly (a ragged partition would
        # replay a different program than was tuned)
        if plan.orientation != "tall_a" or g.loop != "kinner" \
                or g.ksplit > 1:
            return False
        if plan.grid[0] % sched.m_split:
            return False
    if sched.dims:
        if any(d not in SEMANTICS for d in sched.dims):
            return False
        if len(sched.dims) != grid_rank(plan):
            return False
    if hw.gate == "launch":
        try:
            launches = plan_launches(plan, hw)
        except (ValueError, TypeError):
            return False      # a wrapper refuses the layout
        return all(smem <= hw.vmem_bytes for *_, smem in launches)
    return vmem_bytes_needed(plan, hw) <= hw.vmem_bytes * VMEM_USABLE_FRACTION


# ---------------------------------------------------------------------------
# The launch model (``HwSpec.gate == "launch"``)
# ---------------------------------------------------------------------------


def _torch_dtype(dtype: str):
    import torch
    if dtype not in ("float32", "bfloat16"):
        raise TypeError(f"the CUDA kernels take float32 and bfloat16, not "
                        f"{dtype}")
    return getattr(torch, dtype)


def plan_launches(plan: Plan, hw: HwSpec = H100) -> tuple:
    """The launches ``core/tsmm.py::tsmm_dot`` makes for ``plan`` on a card
    of ``hw.sm_count`` SMs: ``kernels/gen.py::launches``, whose step lists
    the emitters follow, for the call the evaluator times (no bias and no
    activation).  Raises ValueError (TypeError for a dtype the kernels do
    not take) where a wrapper refuses the layout."""
    from repro_torch.kernels import gen
    p = plan.problem
    return gen.launches(_gen(plan), plan.orientation, p.m, p.k, p.n,
                        dtype=_torch_dtype(p.dtype), bm=plan.bm, bk=plan.bk,
                        bn=plan.bn, prepack=plan.prepack,
                        sms=hw.sm_count or H100.sm_count)


def launch_key(plan: Plan, hw: HwSpec = H100) -> tuple:
    """The launches ``plan`` produces on the card, without their shared
    memory — what the measured tournament dedupes on: two plans with one
    key run the same kernels on the same layouts, so timing both would
    time one program twice.  Plans that differ only in ``m_split``,
    ``dims``, ``multibuffer`` or, for a natural A, ``bm`` (where the
    padded M does not change) share a key.  Raises where
    :func:`plan_launches` does."""
    return tuple(entry[:-1] for entry in plan_launches(plan, hw))


def launch_count(plan: Plan, hw: HwSpec = H100) -> int:
    """How many launches one call of ``plan`` makes: its kernels, each as
    many times as it runs, and its plain passes.  The tournament's tie
    rule prefers the smaller."""
    return sum(e[7] if e[0] != "torch" else 1
               for e in plan_launches(plan, hw))


def call_pack_bytes(plan: Plan, hw: HwSpec = H100) -> int:
    """HBM bytes of the pack ``tsmm_dot`` makes of a tall A on every call
    of a ``prepack=True`` tall plan (read A, write its blocks), charged
    under the launch gate only: the reference's model amortizes it
    (paper Eq.7, :func:`hbm_traffic_bytes`), and its spec keeps that, as
    does a spec whose caller packs A once (``HwSpec.pack_once``)."""
    if hw.gate != "launch" or hw.pack_once \
            or plan.orientation != "tall_a" or not plan.prepack:
        return 0
    p = plan.problem
    eb = dtype_bytes(p.dtype)
    return (p.m * p.k + _ceil(p.m, plan.bm) * plan.bm
            * _ceil(p.k, plan.bk) * plan.bk) * eb


def epilogue_roundtrip_bytes(plan: Plan) -> int:
    """HBM bytes of a POST-HOC bias/activation epilogue: one extra read +
    write of the full (padded) output.  This is the traffic the fused
    epilogues delete (DESIGN.md §11) — the fusion credit the model grants
    every fused plan, what an ``epi=split`` grammar point pays back, and
    what ``hbm_traffic_bytes(..., epilogue='posthoc')`` charges the
    pre-fusion behavior."""
    p = plan.problem
    eb = dtype_bytes(p.dtype)
    if plan.orientation == "tall_a":
        rows = _ceil(p.m, plan.bm) * plan.bm
        cols = _ceil(p.n, 128) * 128
    else:
        rows = max(p.m, 8)
        cols = _ceil(p.n, plan.bn) * plan.bn
    return 2 * rows * cols * eb


def hbm_traffic_bytes(plan: Plan, *, epilogue: str = "fused") -> int:
    """Total HBM bytes moved by one execution of the plan.

    Grammar-aware (DESIGN.md §10, §14): the kernel dimension of the
    search space changes WHERE bytes move, and these per-axis terms are
    what a calibration fit regresses through (a later slice):

    * ``ksplit>1`` streams fp32 partials out and reads them back for the
      fused reduction (the k-split reduction traffic);
    * ``loop=kouter`` fetches each B panel ONCE per k step but revisits
      the fp32 output every step; a k-inner ``acc=revisit`` point writes
      the fp32 output once per panel then pays the final cast pass;
    * ``bres=resident`` loads the streamed operand exactly once;
    * ``epi=split`` pays one extra read+write pass over the output
      (the post-hoc epilogue priced INTO the point itself);
    * ``packfuse`` skips the per-call pack of a prepack=False skinny
      weight (2x the weight bytes) that every re-packing point pays;
    * pre-pack traffic of a ``prepack=True`` operand stays a one-time
      cost amortized over reuse (paper Eq.7) and is NOT counted here.

    ``epilogue`` (DESIGN.md §11): the default ``"fused"`` models the
    serving reality — bias+activation apply inside the kernel, so no
    separate output round trip; ``"posthoc"`` adds
    :func:`epilogue_roundtrip_bytes` (the pre-fusion behavior, kept so
    benchmarks can quote the fusion credit)."""
    p = plan.problem
    eb = dtype_bytes(p.dtype)
    g = _gen(plan)
    if plan.orientation == "tall_a":
        nm, nk = _ceil(p.m, plan.bm), _ceil(p.k, plan.bk)
        n_pad = _ceil(p.n, 128) * 128
        a = nm * nk * plan.bm * plan.bk * eb              # each A block once
        b = nm * nk * plan.bk * n_pad * eb                # B reloaded per row
        out_eb = nm * plan.bm * n_pad * eb
        c = out_eb
        if g.loop == "kouter":
            b = nk * plan.bk * n_pad * eb                 # B once per k step
            c = ((2 * nk - 1) * nm * plan.bm * n_pad * 4  # fp32 revisits
                 + nm * plan.bm * n_pad * (4 + eb))       # final cast pass
        elif g.ksplit > 1:
            parts = g.ksplit * nm * plan.bm * n_pad * 4
            c = 2 * parts + out_eb        # write+read partials, write final
        elif g.acc == "revisit":
            c = (nm * plan.bm * n_pad * 4                 # fp32 output once
                 + nm * plan.bm * n_pad * (4 + eb))       # final cast pass
        if g.bres == "resident":
            b = nk * plan.bk * n_pad * eb                 # B loaded once
        if g.epi == "split":
            c += 2 * out_eb                               # post-hoc pass
    else:
        nn, nk = _ceil(p.n, plan.bn), _ceil(p.k, plan.bk)
        m_pad = max(p.m, 8)
        a = nn * nk * m_pad * plan.bk * eb                # X reloaded per col
        b = nn * nk * plan.bk * plan.bn * eb              # each W block once
        out_eb = nn * m_pad * plan.bn * eb
        c = out_eb
        if g.ksplit > 1:
            parts = g.ksplit * m_pad * nn * plan.bn * 4
            c = 2 * parts + out_eb
        elif g.acc == "revisit":
            c = nn * m_pad * plan.bn * 4 + nn * m_pad * plan.bn * (4 + eb)
        if g.bres == "resident":
            a = m_pad * _ceil(p.k, plan.bk) * plan.bk * eb
        if g.epi == "split":
            c += 2 * out_eb                               # extra output pass
        if not plan.prepack and not g.packfuse:
            # a prepack=False skinny plan re-packs the weight every call
            # (tsmm_dot replay fidelity, DESIGN.md §9): read + write W
            b += 2 * nk * plan.bk * nn * plan.bn * eb
    total = a + b + c
    if epilogue == "posthoc":
        total += epilogue_roundtrip_bytes(plan)
    return total


def compute_time_s(plan: Plan, hw: HwSpec = H100) -> float:
    """Tile-padding-aware compute time at the dtype's peak: the tall
    kernels compute whole 128-wide column tiles (the TPU's MXU width,
    and on the card the padded N the tall launch plans tile by 128 or
    256), so the skinny dim is padded up to 128.  Under the launch gate
    the kernel runs over the padded (M, K, N) of its launch
    (:func:`plan_launches`): a block that does not divide M or K adds
    the zero rows or k steps the card computes (the skinny rows padded to
    8 as before)."""
    p = plan.problem
    if hw.gate == "launch":
        m, k, n = next(e[6] for e in plan_launches(plan, hw)
                       if e[0] in ("tsmm_tall", "tsmm_skinny"))
        if plan.orientation == "skinny_a":
            m = _ceil(max(m, 1), 8) * 8
        flops = 2.0 * m * k * n
    elif plan.orientation == "tall_a":
        eff_n = _ceil(p.n, 128) * 128
        flops = 2.0 * p.m * p.k * eff_n
    else:
        eff_m = _ceil(max(p.m, 1), 8) * 8  # sublane padding
        flops = 2.0 * eff_m * p.k * p.n
    return flops / (hw.peak_flops(p.dtype) * hw.mxu_efficiency)


def memory_time_s(plan: Plan, hw: HwSpec = H100) -> float:
    return ((hbm_traffic_bytes(plan) + call_pack_bytes(plan, hw))
            / (hw.hbm_bw * hw.hbm_efficiency))


def occupancy(plan: Plan, hw: HwSpec = H100) -> float:
    """How much longer the plan's kernel runs than a launch that fills
    the card, >= 1: under the launch gate, for each TSMM launch of
    :func:`plan_launches`, its CTAs against the ``hw.sm_count`` SMs times
    the CTAs each SM must hold to run the design at its rate
    (``kernels/tsmm.py::fill_ctas``: one for the TMA designs, every CTA
    the registers allow for the SIMT kernels), quantised to whole waves:
    ``ceil(ctas / slots) * slots / ctas``; the largest over the launches.
    A launch that fills every SM in whole waves scores 1, so its plan
    scores as it did before the term.  1 under the reference's gate.

    It scales the compute term only (:func:`_terms`).  A byte-bound launch
    of few CTAs, each keeping a ring of TMA loads in flight, is held back
    by fixed launch and pipeline latency, not in proportion to its idle
    SMs: scaling its bytes too ranked k-splits first at every decode
    shape, and the tournament's short lists there measured 4-6x slower
    than the unsplit plans (PERF.md §6)."""
    if hw.gate != "launch":
        return 1.0
    from repro_torch.kernels import tsmm as kt
    sms = hw.sm_count or H100.sm_count
    occ = 1.0
    for entry in plan_launches(plan, hw):
        if entry[0] not in ("tsmm_tall", "tsmm_skinny"):
            continue
        lp, (m, _, n) = entry[4], entry[6]
        ctas = kt.grid_ctas(lp, m, n, entry[2])
        slots = sms * kt.fill_ctas(lp)
        occ = max(occ, _ceil(ctas, slots) * slots / ctas)
    return occ


def _terms(plan: Plan, hw: HwSpec) -> tuple:
    """(memory seconds, compute seconds) under ``hw``, the compute scaled
    by the plan's :func:`occupancy`."""
    return (memory_time_s(plan, hw),
            compute_time_s(plan, hw) * occupancy(plan, hw))


def features(plan: Plan, hw: HwSpec = H100) -> tuple:
    """Nominal-roofline regressors for the calibration fit: (memory
    seconds at datasheet bandwidth, compute seconds at datasheet FLOPs
    scaled by the plan's :func:`occupancy`, and the schedule-aware
    overhead-step count).  A measured time t then fits
    ``t ~= t_mem / hbm_efficiency + t_cmp / mxu_efficiency
    + steps * grid_overhead_s`` — linear in the three coefficients (the
    occupancy is a property of the plan, not a fitted coefficient)."""
    return (*_terms(plan, nominal(hw)), overhead_steps(plan, hw))


def predict(plan: Plan, hw: HwSpec = H100) -> Plan:
    """Attach predicted times + a scalar score (lower = better).

    The overhead term counts SERIAL contraction steps
    (:func:`contraction_steps` — the k-axis, divided by the split factor
    for k-split points): output-tile steps pipeline against the operand
    DMAs, but every extra k-block serializes another partial-sum
    accumulation (on the XLA fallback, another pass over the fp32
    accumulator) — measurements show the k-split, not the output split,
    is what costs.

    Uncalibrated: the classic ``max(compute, memory)`` roofline.  A
    calibrated ``hw`` uses the additive form the least-squares fit solved
    (overlap is absorbed into the fitted efficiencies; the max() roofline
    is not linear in its coefficients, so it cannot be fitted directly).

    The overhead count is schedule-aware (:func:`overhead_steps`):
    deeper multibuffering hides per-step DMA-issue latency, each extra
    M partition adds a per-partition launch overhead — so grid geometry
    ranks in the same units as blocks and grammar points
    (DESIGN.md §11)."""
    t_m, t_c = _terms(plan, hw)
    steps = overhead_steps(plan, hw)
    base = (t_c + t_m) if hw.calibrated else max(t_c, t_m)
    score = base + steps * hw.grid_overhead_s
    return dataclasses.replace(plan, t_compute=t_c, t_memory=t_m, score=score)


def pack_time_s(problem: Problem, hw: HwSpec = H100) -> float:
    """One-time pre-pack cost: read + write the tall operand."""
    eb = dtype_bytes(problem.dtype)
    tall_elems = problem.tall * problem.k
    return 2 * tall_elems * eb / hw.hbm_bw
