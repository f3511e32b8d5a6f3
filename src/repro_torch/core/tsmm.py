"""Public TSMM API: planned matmul and the serving pre-pack.

``tsmm_dot`` is the entry point applications use; it consults the plan
registry (the paper's runtime stage) and dispatches pre-packed weights
to the planned skinny-A kernel, TSMM-shaped plain weights to the planned
skinny-A or tall-A kernel, plain GEMM otherwise.

Every planned call runs down the degradation ladder of the reference
(DESIGN.md §16, :func:`_laddered`): the planned hand-written CUDA kernel
→ the same blocked function as its plain PyTorch version, on the same
device → ``torch.matmul`` with a post-hoc epilogue.  A rung is left only
for a fault a caller armed on purpose (``kernels.lower.*`` /
``kernels.xla.*``), raised before anything reaches the device.  Every
real error raises through: a layout the host-side launch plan or TMA
check refuses (``kernels.tsmm.LaunchRefused``, a fault of the planner to
fix, not to serve around on the plain version), a kernel library that
did not build (``cuda.KernelBuildError``) and an error after an enqueue
(``cuda.KernelLaunchError``, after which the stream may be poisoned).
Every demotion is logged and counted on the ambient
:class:`~repro_torch.resilience.degrade.DegradeStats`.  With nothing
armed and no key failing, a call runs rung 1 directly: an eager step
pays a contextvar read and two checks per call, a replay nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

from repro_torch.core import registry
from repro_torch.core.autotuner import (default_hw, make_plan,
                                        make_plan_set, plan_for_matmul)
from repro_torch.core.hw import HwSpec, dtype_name
from repro_torch.core.packing import PackedTensor, is_packed, pack
from repro_torch.core.plan import (Plan, Problem, ScheduleSpec, is_tsmm,
                                   parse_schedule)
from repro_torch.core.smem_model import feasible, predict
from repro_torch.kernels import variants
from repro_torch.kernels.ref import act_ref
from repro_torch.kernels.variants import KernelSpec
from repro_torch.resilience import degrade, failpoints
from repro_torch.sharding.context import (data_split_of, dp_group, dp_rank,
                                          dp_size, kblocks_split, serve_2d)

log = logging.getLogger(__name__)



def _gemm_epilogue(a2, w, bias, act, out_dtype):
    """Plain GEMM for shapes no plan covers, with a post-hoc epilogue: the
    bottom rung of the ladder."""
    out = torch.matmul(a2, w).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if act is not None:
        out = act_ref(out.float(), act).to(out.dtype)
    return out


def _laddered(orientation: str, key_of, planned, plain, gemm):
    """Run one planned TSMM down the ladder: ``planned()`` (the kernel),
    ``plain()`` (its plain PyTorch version on the same device), ``gemm()``
    (``torch.matmul``).  Each demotion is counted on the ambient
    DegradeStats; after K consecutive failures of a key (``key_of()``)
    its breaker opens and the planned rung is no longer tried
    (``kernel.pinned``).  With no failpoint armed and no key failing,
    nothing can leave rung 1: it runs without building the key."""
    stats = degrade.current()
    breaker = stats.breaker
    if breaker.idle() and not failpoints.armed():
        return planned()
    breaker_key = key_of()
    if breaker.allow(breaker_key):
        try:
            failpoints.fp(f"kernels.lower.{orientation}")
            out = planned()
        except failpoints.InjectedFault as e:
            opened = breaker.failure(breaker_key)
            log.warning("tsmm: planned %s kernel failed for %s (%s); "
                        "degrading to its plain version%s", orientation,
                        breaker_key, e, " [breaker OPEN: fallback pinned]"
                        if opened else "")
            stats.record("kernel.variant", key=breaker_key, fallback="torch",
                         error=str(e))
        else:
            breaker.success(breaker_key)
            return out
    else:
        stats.record("kernel.pinned", key=breaker_key, fallback="torch")
    try:
        failpoints.fp(f"kernels.xla.{orientation}")
        return plain()
    except failpoints.InjectedFault as e:
        log.warning("tsmm: plain %s version failed for %s (%s); degrading "
                    "to torch.matmul", orientation, breaker_key, e)
        stats.record("kernel.xla", key=breaker_key, fallback="gemm",
                     error=str(e))
        return gemm()


def _epilogue(out, bias, act, dtype):
    """The kernels' epilogue on an fp32 or compute-dtype product: bias in
    fp32, then the activation, then one cast (``kernels/tsmm.py:58-68``
    of the reference)."""
    out = out.float()
    if bias is not None:
        out = out + bias.float()
    return act_ref(out, act).to(dtype)


def _data_sum(part, group):
    """The data group's partial products of a k-split summed: the one
    collective of a 2D tensor-parallel product."""
    from repro_torch.sharding import comm
    return comm.all_reduce(part, group)


def ksplit_sum(part, bias, act, dtype):
    """A k-split product's partial (m, n) output (this rank's K slice of
    the activation times its row piece of the weight, no bias, no
    activation) summed over the data group in the compute dtype, then the
    epilogue once on the sum: a bias added, or SiLU applied, per partial
    sum would be wrong."""
    return _epilogue(_data_sum(part, dp_group()), bias, act, dtype)


def _ksplit_dot(a2, b: PackedTensor, bias, act, plan):
    """2D tensor parallelism's packed product: ``b`` is this rank's row
    piece (its K slice) of a weight whose rows lie on the data axis.  The
    rank multiplies its K slice of the activation panel by it (the
    planned kernel), and :func:`ksplit_sum` sums the partial outputs over
    the data group and runs the epilogue once."""
    kp = b.orig_rows
    r = dp_rank()
    part = tsmm_dot(a2[:, r * kp:(r + 1) * kp].contiguous(),
                    dataclasses.replace(b, spec=()), plan=plan)
    return ksplit_sum(part, bias, act, a2.dtype)


def _gathered(b: PackedTensor, split: str) -> tuple:
    """FSDP's weight before use: a rank's packed piece gathered over the
    data group along the block-count dim the data axis split (rows: nk,
    cols: nn).  Returns (the gathered PackedTensor, None or a function
    that drops each piece's zero-padded columns from an output)."""
    from repro_torch.sharding import comm
    group, n = dp_group(), dp_size()
    if split == "rows":
        blocks = comm.all_gather(b.blocks, group, dim=-4)
        return dataclasses.replace(b, blocks=blocks,
                                   orig_rows=b.orig_rows * n, spec=()), None
    blocks = comm.all_gather(b.blocks, group, dim=-3)
    width = b.blocks.shape[-3] * b.blocks.shape[-1]
    if width == b.orig_cols:
        return dataclasses.replace(b, blocks=blocks,
                                   orig_cols=b.orig_cols * n, spec=()), None
    oc = b.orig_cols

    def keep(out):
        return out.reshape(out.shape[0], n, width)[:, :, :oc].reshape(
            out.shape[0], n * oc)

    return dataclasses.replace(b, blocks=blocks, orig_cols=width * n,
                               spec=()), keep


def variant_choice() -> Optional[KernelSpec]:
    """``REPRO_TSMM_VARIANT`` override — force a named kernel variant on
    every planned TSMM (syntax ``name`` or ``name:key=val,...``; an
    unknown name raises, listing the grammar)."""
    raw = os.environ.get("REPRO_TSMM_VARIANT", "")
    if not raw:
        return None
    return variants.parse_spec(raw)


def schedule_choice() -> Optional[ScheduleSpec]:
    """``REPRO_TSMM_SCHEDULE`` override — force a grid schedule on every
    planned TSMM (unknown fields raise)."""
    raw = os.environ.get("REPRO_TSMM_SCHEDULE", "")
    if not raw:
        return None
    return parse_schedule(raw)


def _override_spec(spec: KernelSpec, override: Optional[KernelSpec],
                   orientation: str) -> KernelSpec:
    if override is not None and variants.applies_to(override, orientation):
        return override
    return spec


def _stamped_spec(b: PackedTensor, m: int) -> tuple:
    """The (kernel spec, schedule) ``prepack_for`` stamped on the packed
    weight for the smallest batch bucket covering ``m``; (None, None)
    when unstamped or past the largest bucket."""
    for entry in b.kernel_specs:
        if entry[0] >= m:
            return entry[1], entry[2]
    return None, None


def tsmm_dot(a, b, *, bias=None, act: Optional[str] = None,
             plan: Optional[Plan] = None):
    """C = act(A @ B + bias) with TSMM planning.

    ``a``: (..., k) activations; ``b``: (k, n) tensor or PackedTensor."""
    override = variant_choice()
    sched_override = schedule_choice()
    lead, k = a.shape[:-1], a.shape[-1]
    m = 1
    for d in lead:
        m *= d
    a2 = a.reshape(m, k)

    if is_packed(b):
        split = data_split_of(b.spec)
        if split == "rows" and kblocks_split(k):
            return _ksplit_dot(a2, b, bias, act, plan).reshape(
                *lead, b.orig_cols)
        if split is not None and not serve_2d():
            # FSDP: the weight gathered over the data group before use
            b, keep = _gathered(b, split)
            out = tsmm_dot(a2, b, bias=bias, act=act, plan=plan)
            if keep is not None:
                out = keep(out)
            return out.reshape(*lead, out.shape[-1])
        nk, _, bk, bn = b.blocks.shape[-4:]
        spec = plan.kernel if plan is not None else None
        sched = plan.schedule if plan is not None else None
        if spec is None:
            # serving replay of the variant stamped when the weight was
            # packed...
            spec, sched = _stamped_spec(b, m)
        if spec is None:
            # ...else a registry peek (prefill token counts past the
            # buckets, manually packed tensors); uncovered: the baseline
            cached = registry.peek(
                Problem(m, k, b.orig_cols, dtype_name(a.dtype)).key(), a.device)
            if cached is not None and cached.orientation != "skinny_a":
                cached = None      # a tall plan of an unpacked twin shape
            spec = cached.kernel if cached is not None else variants.BASELINE
            sched = cached.schedule if cached is not None else None
        spec = _override_spec(spec, override, "skinny_a")
        sched = sched_override or sched

        def _packed(use_impl):
            return variants.run_skinny_a(
                spec, a2, b.blocks, bias, act, bk=bk, bn=bn, packed=True,
                impl=use_impl, schedule=sched)[:, : b.orig_cols]

        out = _laddered(
            "skinny", lambda: f"skinny_a/{m}x{k}x{b.orig_cols}/{spec.key()}",
            lambda: _packed(None), lambda: _packed("torch"),
            lambda: _gemm_epilogue(a2, b.unpack(), bias, act, a.dtype))
        return out.reshape(*lead, b.orig_cols)

    n = b.shape[-1]
    if plan is None and is_tsmm(m, k, n):
        plan = plan_for_matmul(m, k, n, dtype_name(a.dtype), device=a.device)
    if plan is not None and plan.orientation == "skinny_a":
        spec = _override_spec(plan.kernel, override, "skinny_a")
        sched = sched_override or plan.schedule

        def _skinny(use_impl):
            return variants.run_skinny_a(
                spec, a2, b, bias, act, bk=plan.bk, bn=plan.bn, packed=False,
                impl=use_impl, schedule=sched)[:, :n]

        out = _laddered(
            "skinny", lambda: f"skinny_a/{m}x{k}x{n}/{spec.key()}",
            lambda: _skinny(None), lambda: _skinny("torch"),
            lambda: _gemm_epilogue(a2, b, bias, act, a.dtype))
        return out.reshape(*lead, n)
    if plan is not None and plan.orientation == "tall_a":
        # bias and activation fuse into the point's epilogue placement
        spec = _override_spec(plan.kernel, override, "tall_a")
        sched = sched_override or plan.schedule

        def _tall(use_impl):
            if plan.prepack:
                # the per-call pack of A (the pack kernel on the card)
                ap = pack(a2, plan.bm, plan.bk, impl=use_impl)
                return variants.run_tall_a(
                    spec, ap.blocks, b, bias, act, bm=plan.bm, bk=plan.bk,
                    packed=True, impl=use_impl, schedule=sched)[:m, :n]
            return variants.run_tall_a(
                spec, a2, b, bias, act, bm=plan.bm, bk=plan.bk, packed=False,
                impl=use_impl, schedule=sched)

        out = _laddered(
            "tall", lambda: f"tall_a/{m}x{k}x{n}/{spec.key()}",
            lambda: _tall(None), lambda: _tall("torch"),
            lambda: _gemm_epilogue(a2, b, bias, act, a.dtype))
        return out.reshape(*lead, n)
    return _gemm_epilogue(a2, b, bias, act, a.dtype).reshape(*lead, n)


def _layout(buckets: tuple, ks: int, ns: int, dt: str, hw: HwSpec,
            device, pad: bool = False, num_shards: int = 1,
            piece: Optional[tuple] = None) -> tuple:
    """(the per-bucket PlanSet, the (bk, bn) blocks or None) of a (ks, ns)
    weight packed for ``buckets`` (``pad``: see :func:`prepack_for`);
    ``piece``: the (rows, cols) the blocks must divide, where the weight
    packed is a piece of the (ks, ns) one the kernel multiplies."""
    pset = make_plan_set(ks, ns, buckets, dt, hw=hw, persist=False,
                         device=device, num_shards=num_shards)
    problems = [pset.plans[m].problem if m in pset.plans
                else Problem(m, ks, ns, dt, num_shards) for m in buckets]
    caps = (max((pl.bk for pl in pset.plans.values()), default=None),
            max((pl.bn for pl in pset.plans.values()), default=None))
    return pset, _conforming_blocks(problems, ks, ns, hw, caps=caps, pad=pad,
                                    piece=piece)


def prepack_blocks(m_skinny, ks: int, ns: int, dtype: str = "bfloat16", *,
                   hw: Optional[HwSpec] = None, device="cuda",
                   pad: bool = False) -> Optional[tuple]:
    """The (bk, bn) blocks :func:`prepack_for` packs a (ks, ns) weight of
    ``dtype`` into on ``device`` (None: it stays unpacked), without
    packing anything."""
    buckets = (m_skinny,) if isinstance(m_skinny, int) else tuple(m_skinny)
    return _layout(buckets, ks, ns, dtype, hw or default_hw(device),
                   device, pad)[1]


def prepack_for(m_skinny, w, *, hw: Optional[HwSpec] = None,
                pad: bool = False, num_shards: int = 1,
                plan_shape: Optional[tuple] = None,
                spec: tuple = ()) -> Optional[PackedTensor]:
    """Plan and pack a weight for decode-time reuse.

    ``m_skinny`` is one serving batch size or a tuple of batch buckets:
    ONE packed layout serves every bucket, its (bk, bn) chosen among the
    blocks that divide the weight's dims and pass the cost model's
    on-chip gate for every bucket, ranked by predicted time summed over
    buckets.  The per-bucket (variant, schedule) is stamped on the packed
    weight.  With ``pad`` a block width need not divide N: the weight is
    zero-padded to whole blocks (the kernel's output columns past N are
    sliced off), for weights whose width no multiple of 128 divides.

    On a mesh each rank packs its own piece of the weight; ``num_shards``
    keys the tuned problems, so a sharded engine looks up what an
    ``install --mesh`` sweep wrote.  ``plan_shape``: the (K, N) the
    kernel multiplies where it is not the piece's (an FSDP piece is
    gathered over the data group first): the problems are planned and
    stamped at it, and the blocks divide the piece.  ``spec``: the
    piece's (row, col) spec entries (:class:`PackedTensor`).  Returns
    None when no conforming block exists."""
    device = w.device
    hw = hw or default_hw(device)
    buckets = (m_skinny,) if isinstance(m_skinny, int) else tuple(m_skinny)
    k, n = int(w.shape[-2]), int(w.shape[-1])
    pk_, pn_ = plan_shape or (k, n)
    pset, chosen = _layout(buckets, pk_, pn_, dtype_name(w.dtype), hw,
                           device, pad, num_shards, piece=(k, n))
    if chosen is None:
        return None
    pk = pack(w, *chosen)
    pk.spec = tuple(spec)
    pk.kernel_specs = tuple(sorted(
        ((m, *_stamp_spec_for_blocks(pset.plans[m], *chosen, hw=hw))
         for m in pset.plans), key=lambda e: e[0]))
    return pk


def _stamp_spec_for_blocks(plan: Plan, bk: int, bn: int, *,
                           hw: HwSpec) -> tuple:
    """``plan``'s tuned (kernel variant, schedule), re-validated for a
    PACKED weight with blocks (bk, bn): a point with no packed-path form
    (pack fusion) or infeasible at these blocks degrades to the baseline;
    an infeasible schedule to the default."""
    spec, sched = plan.kernel, plan.schedule
    if not spec.is_baseline:
        try:
            g = variants.from_kernel_spec(spec)
        except ValueError:
            g = None
        if g is None or not variants.grammar.valid(g, "skinny_a", True):
            spec = KernelSpec()
    trial = dataclasses.replace(plan, bk=bk, bn=bn, prepack=True, kernel=spec)
    if not feasible(trial, hw):
        sched = ScheduleSpec()
        trial = dataclasses.replace(trial, schedule=sched)
        if not feasible(trial, hw):
            spec = KernelSpec()
    return spec, sched


def blocks_tile(k: int, n: int, pad: bool = False) -> bool:
    """Whether some (bk, bn) of multiples of 128 tiles a (k, n) weight: bk
    must divide k, and bn n unless ``pad`` (N zero-padded).  Where none
    does (DeepSeek-V2's 576-wide ``wkv_a``), :func:`prepack_for` leaves
    the weight unpacked; the install sweep asks the same question
    (``core/install.py::_unpacked_leaves``)."""
    return k % 128 == 0 and (n % 128 == 0 or pad)


def _conforming_blocks(problems, ks: int, ns: int, hw: HwSpec,
                       caps: tuple = (None, None), pad: bool = False,
                       piece: Optional[tuple] = None) -> Optional[tuple]:
    """Best (bk, bn) conforming for EVERY problem: multiples of 128 that
    divide the weight's dims (the ``piece`` packed, where it is a piece
    of the (ks, ns) one) within the tuned ``caps`` (with ``pad``, where
    no width divides N, any width up to N rounded up to 128: N is
    zero-padded), feasible for all buckets, minimal predicted time summed
    across buckets."""
    ks, ns = piece or (ks, ns)
    if not blocks_tile(ks, ns, pad):
        return None
    cap_bk = min(ks, caps[0]) if caps[0] else ks
    cap_bn = min(ns, caps[1]) if caps[1] else ns
    bks = [d for d in range(128, max(cap_bk, 128) + 1, 128) if ks % d == 0]
    bns = [d for d in range(128, max(cap_bn, 128) + 1, 128) if ns % d == 0]
    if pad and ns % 128:
        bns = list(range(128, max(cap_bn, 128) + 128, 128))
    best, best_score = None, None
    for bk in bks:
        for bn in bns:
            trial = [Plan(p, "skinny_a", bm=p.m, bk=bk, bn=bn)
                     for p in problems]
            if not all(feasible(t, hw) for t in trial):
                continue
            score = sum(predict(t, hw).score for t in trial)
            if best_score is None or score < best_score:
                best, best_score = (bk, bn), score
    return best


# ---------------------------------------------------------------------------
# Distributed TSMM: the paper's multi-thread optimizer at mesh scale
# ---------------------------------------------------------------------------


def distributed_tsmm(a, b, group, *, plan: Optional[Plan] = None):
    """Tall-A TSMM with the tall dim split over ``group``; B replicated.

    ``a`` is this rank's rows of A, (M / n, K), natural or a
    ``PackedTensor`` packed once at the plan's (bm, bk) (the paper's
    pre-pack); ``b`` the whole (K, N) skinny operand.  Each rank runs the
    planned tall-A kernel on its own rows (``plan``: default the
    registry's plan of ``Problem(M / n, K, N, dtype, n)``; a natural ``a``
    is packed per call where the plan packs) and keeps its rows of C:
    zero collectives, the paper's GEBB_t property."""
    from repro_torch.sharding import comm
    shards = comm.group_size(group)
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[1]
    if plan is None:
        plan = make_plan(Problem(m, k, n, dtype_name(a.dtype), shards),
                         device=a.device)
    if is_packed(a):
        if a.blocks.shape[-2:] != (plan.bm, plan.bk):
            raise ValueError(f"A is packed at {tuple(a.blocks.shape[-2:])}, "
                             f"the plan wants ({plan.bm}, {plan.bk})")
        blocks, packed = a.blocks, True
    elif plan.prepack:
        blocks, packed = pack(a, plan.bm, plan.bk).blocks, True
    else:
        blocks, packed = a, False
    out = variants.run_tall_a(plan.kernel, blocks, b, bm=plan.bm, bk=plan.bk,
                              packed=packed, schedule=plan.schedule)
    return out[:m, :n]


def conventional_ksplit(a, b, group):
    """The conventional library decomposition the paper beats: the
    contraction dim split over ``group`` (``a`` this rank's (M, K / n)
    columns, ``b`` its (K / n, N) rows), the fp32 partial product
    (``torch.matmul``, as the reference's ``jnp.dot`` runs outside
    Pallas) summed by one all-reduce, then one cast.  Every rank returns
    the whole (M, N)."""
    from repro_torch.sharding import comm
    part = torch.matmul(a.float(), b.float())
    return comm.all_reduce(part, group).to(a.dtype)


def overlapped_ring_tsmm(a, b, group):
    """Ring-pipelined TSMM for an A that arrives k-sharded (``a`` this
    rank's (M, K / n) columns, ``b`` its (K / n, N) rows) when the
    no-n-split output layout is still wanted: each step multiplies the
    resident pair (fp32 accumulation) while the pair moves one rank
    along the ring (``isend`` / ``irecv``), instead of a blocking
    all-gather.  n - 1 shifts of each operand; every rank returns the
    whole (M, N)."""
    from repro_torch.sharding import comm
    shards = comm.group_size(group)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    a_cur, b_cur = a, b
    for step in range(shards):
        nxt = None
        if step < shards - 1:
            nxt = (comm.ring_shift(a_cur, group, wait=False),
                   comm.ring_shift(b_cur, group, wait=False))
        acc += torch.matmul(a_cur.float(), b_cur.float())
        if nxt is not None:
            a_cur, b_cur = nxt[0](), nxt[1]()
    return acc.to(a.dtype)
