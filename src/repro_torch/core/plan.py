"""Execution plans — the artifact the paper's runtime stage produces.

Copied from the reference package's ``core/plan.py`` (plans, problems,
schedules and batch buckets are framework-free), so that plan JSON and
tuning keys are byte-identical across the two packages.

A :class:`Plan` fixes everything about one TSMM problem instance:
the orientation (which operand is skinny), the block shapes (the paper's
m_c/k_c/n_c + the inner-kernel m_r x n_r collapsed into one MXU-aligned
Pallas block), the distribution strategy (shard the tall dim, never the
skinny one), and the implementation backend.  Plans are produced by the
autotuner, persisted by the registry, and replayed by ``tsmm_dot``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional

# the spec module carries no kernel code, so Plan can name a variant
# without loading the kernels
from repro_torch.kernels.variants.spec import KernelSpec


# ---------------------------------------------------------------------------
# Grid schedules (DESIGN.md §11): how a plan's block grid is mapped onto
# the hardware — the paper's runtime thread-level partitioning of the tall
# dimension, plus the Pallas pipeline knobs that decide operand streaming.
# ---------------------------------------------------------------------------


SEMANTICS = ("parallel", "arbitrary")

# Kernels whose tall-dim grid axis can be partitioned into per-core chunks
# (an extra leading *parallel* grid axis).  ksplit already spends its
# parallel axis on the contraction split; kmajor's k loop lives at the XLA
# level (single-axis grid, output aliasing) so neither re-partitions.
M_SPLIT_KERNELS = frozenset({"baseline", "b_resident"})
# Kernels with no streamed-operand pipeline to re-schedule: the k loop is
# a fori_loop of single-slice Pallas passes, so multibuffer depth and
# dimension-semantics overrides do not apply.
FIXED_SCHEDULE_KERNELS = frozenset({"kmajor"})

# Whether the kernel can express a per-operand buffering depth.  The
# port's CUDA skinny kernel has no staging-depth parameter yet: a
# multibuffer!=2 plan would execute the same program, so the autotuner
# only ENUMERATES multibuffer when it is expressible (the knob stays
# modeled and reachable via REPRO_TSMM_SCHEDULE).
MULTIBUFFER_EXPRESSIBLE = False


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """One point in the grid-schedule dimension of the search space.

    A KernelSpec names WHICH inner kernel runs; a ScheduleSpec decides HOW
    its grid is laid onto the machine:

    * ``dims`` — per-grid-axis dimension semantics override
      (``parallel``/``arbitrary``); empty means the kernel's default.
      Length must match the variant's grid rank (``vmem_model.grid_rank``).
    * ``m_split`` — M-partition factor: the tall dimension's row-panel
      axis is split into ``m_split`` per-core chunks, each a *parallel*
      leading grid axis (the paper's runtime thread-level partitioning,
      TSM2X's tunable thread mapping).  Only meaningful for
      ``M_SPLIT_KERNELS`` and when it divides the row-panel count.
    * ``multibuffer`` — buffering depth of the k-loop operand streams
      (2 = the classic double buffering the pre-schedule model assumed;
      deeper hides more DMA-issue latency at ``multibuffer``x the
      streamed-operand VMEM footprint).

    The default ScheduleSpec IS the pre-schedule behavior, so plans and
    measurement records written before the schedule axis existed decode
    to it and keep matching their tuning keys."""

    dims: tuple = ()
    m_split: int = 1
    multibuffer: int = 2

    @property
    def is_default(self) -> bool:
        return self == ScheduleSpec()

    def key(self) -> str:
        """Stable string identity, e.g. ``ms2,mb3`` or
        ``ms2,dims=parallel.arbitrary.arbitrary``; ``default`` when
        nothing deviates."""
        parts = []
        if self.m_split != 1:
            parts.append(f"ms{self.m_split}")
        if self.multibuffer != 2:
            parts.append(f"mb{self.multibuffer}")
        if self.dims:
            parts.append("dims=" + ".".join(self.dims))
        return ",".join(parts) if parts else "default"

    def to_json(self) -> dict:
        return {"dims": list(self.dims), "m_split": self.m_split,
                "multibuffer": self.multibuffer}

    @staticmethod
    def from_json(d) -> "ScheduleSpec":
        """Decode a schedule; ``None``/missing (pre-schedule plan records
        on disk) defaults to the pre-schedule behavior — old registries
        load."""
        if d is None:
            return ScheduleSpec()
        if isinstance(d, ScheduleSpec):
            return d
        return ScheduleSpec(dims=tuple(d.get("dims") or ()),
                            m_split=int(d.get("m_split", 1)),
                            multibuffer=int(d.get("multibuffer", 2)))


DEFAULT_SCHEDULE = ScheduleSpec()


def parse_schedule(text: str) -> ScheduleSpec:
    """Parse the ``REPRO_TSMM_SCHEDULE`` override syntax:
    ``m_split=2,multibuffer=3,dims=parallel;arbitrary``.  Unknown keys or
    bad semantics names fail loudly instead of silently serving the
    default schedule."""
    fields = {"dims": (), "m_split": 1, "multibuffer": 2}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in fields:
            raise ValueError(
                f"unknown schedule field {k!r}; valid fields: "
                f"{', '.join(sorted(fields))}")
        if k == "dims":
            dims = tuple(s.strip() for s in v.split(";") if s.strip())
            bad = [s for s in dims if s not in SEMANTICS]
            if bad:
                raise ValueError(
                    f"bad dimension semantics {bad}; valid: {SEMANTICS}")
            fields[k] = dims
        else:
            fields[k] = int(v)
    return ScheduleSpec(**fields)


def schedules_for(orientation: str, kernel="baseline") -> list:
    """Every ScheduleSpec the autotuner enumerates for one
    (orientation, kernel variant) — the schedule dimension of the search
    space, default first (ties under the stable score sort keep the
    pre-schedule behavior).  ``kernel`` is a KernelSpec or a bare variant
    name.  Only knobs that change the EXECUTED program are enumerated:
    ``m_split`` for the named M-partitionable kernels (it changes the
    grid; novel ``gen`` grammar points keep the default schedule — their
    structure axes already span the space m_split would re-cover),
    ``multibuffer`` only when the Pallas API can express it
    (``MULTIBUFFER_EXPRESSIBLE``); ``dims`` overrides never (a
    debugging knob via ``REPRO_TSMM_SCHEDULE``).  Infeasible combos are
    pruned by ``vmem_model.feasible``, not here."""
    kernel_name = getattr(kernel, "name", kernel)
    out = [DEFAULT_SCHEDULE]
    if kernel_name in FIXED_SCHEDULE_KERNELS:
        return out
    splits = ((1, 2, 4) if orientation == "tall_a"
              and kernel_name in M_SPLIT_KERNELS else (1,))
    depths = (2, 3) if MULTIBUFFER_EXPRESSIBLE else (2,)
    for ms in splits:
        for mb in depths:
            s = ScheduleSpec(m_split=ms, multibuffer=mb)
            if not s.is_default:
                out.append(s)
    return out


@dataclasses.dataclass(frozen=True)
class Problem:
    """One TSMM instance: C(m,n) = A(m,k) @ B(k,n)."""
    m: int
    k: int
    n: int
    dtype: str = "bfloat16"
    # devices the tall dim may be sharded over (the runtime 'thread count')
    num_shards: int = 1

    @property
    def skinny_dim(self) -> str:
        return "n" if self.n <= self.m else "m"

    @property
    def skinny(self) -> int:
        return min(self.m, self.n)

    @property
    def tall(self) -> int:
        return max(self.m, self.n)

    def key(self) -> str:
        return f"m{self.m}_k{self.k}_n{self.n}_{self.dtype}_s{self.num_shards}"

    @staticmethod
    def from_key(key: str) -> "Problem":
        """Inverse of :meth:`key` — lets the registry's miss log hand a
        re-tunable Problem to the background tuner (DESIGN.md §9)."""
        m = re.fullmatch(r"m(\d+)_k(\d+)_n(\d+)_([A-Za-z0-9]+)_s(\d+)", key)
        if m is None:
            raise ValueError(f"not a Problem key: {key!r}")
        return Problem(int(m.group(1)), int(m.group(2)), int(m.group(3)),
                       m.group(4), int(m.group(5)))


# A problem is "tall-and-skinny" when one output dim is at most this and the
# other is at least GEMM_MIN_TALL x larger — below the MXU ridge point the
# matmul is HBM-bound and the TSMM machinery pays off (DESIGN.md §2).
SKINNY_MAX = 256
TALL_RATIO = 8


def is_tsmm(m: int, k: int, n: int) -> bool:
    lo, hi = min(m, n), max(m, n)
    return lo <= SKINNY_MAX and hi >= TALL_RATIO * lo and k >= 512


@dataclasses.dataclass(frozen=True)
class Plan:
    problem: Problem
    orientation: str          # "tall_a" (A tall, B skinny) | "skinny_a" (decode)
    bm: int                   # block of the tall/output-row dim
    bk: int                   # k block
    bn: int                   # block of the wide output dim (skinny_a) or
                              # padded skinny width (tall_a)
    impl: str = "auto"        # pallas | pallas_interpret | xla | auto
    prepack: bool = True      # pre-pack the tall operand
    shard_tall: bool = True   # distribute the tall dim over num_shards
    # which member of the inner-kernel family executes this plan — the
    # variant dimension of the search space (kernels/variants, DESIGN.md
    # §10); defaults to the baseline so pre-variant records stay valid
    kernel: KernelSpec = KernelSpec()
    # how the kernel's grid maps onto the machine — the schedule dimension
    # (DESIGN.md §11); defaults to the pre-schedule behavior so records
    # written before the axis existed stay valid
    schedule: ScheduleSpec = DEFAULT_SCHEDULE
    # predicted roofline terms (seconds) from the cost model
    t_compute: float = 0.0
    t_memory: float = 0.0
    # provenance
    chosen_by: str = "model"  # "model" | "measured"
    score: float = 0.0

    @property
    def grid(self) -> tuple:
        p = self.problem
        if self.orientation == "tall_a":
            return (-(-p.m // self.bm), -(-p.k // self.bk))
        return (-(-p.n // self.bn), -(-p.k // self.bk))

    def tuning_key(self) -> str:
        """The tunable-choice part of a plan's identity — what the
        measurement cache is keyed by (together with the problem key):
        two plans with the same tuning key execute the same program.

        The kernel variant extends the key, so a measured baseline plan
        and a model-ranked variant plan can never collide in the
        measurement cache; a baseline spec adds no suffix, so records
        cached before the variant axis existed keep matching.  The grid
        schedule extends it the same way (DESIGN.md §11): only a
        non-default ScheduleSpec appends, so pre-schedule measurement
        records keep matching their default-schedule plans."""
        base = (f"{self.orientation}_bm{self.bm}_bk{self.bk}_bn{self.bn}"
                f"_pp{int(self.prepack)}_{self.impl}")
        if not self.kernel.is_baseline:
            base += f"_kv:{self.kernel.key()}"
        if not self.schedule.is_default:
            base += f"_sch:{self.schedule.key()}"
        return base

    def gen_spec(self):
        """This plan's kernel decoded to its grammar point (DESIGN.md
        §14) — legacy variant names resolve to their equivalent GenSpec,
        so pre-grammar plans ride the generated emitters unchanged.
        Raises ValueError for a spec outside the grammar."""
        from repro_torch.kernels.variants.grammar import from_kernel_spec
        return from_kernel_spec(self.kernel)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["kernel"] = self.kernel.to_json()
        d["schedule"] = self.schedule.to_json()
        return d

    @staticmethod
    def from_json(d: dict) -> "Plan":
        d = dict(d)
        d["problem"] = Problem(**d["problem"])
        # pre-variant records carry no "kernel" key: default to baseline;
        # pre-schedule records carry no "schedule": default behavior
        d["kernel"] = KernelSpec.from_json(d.get("kernel"))
        d["schedule"] = ScheduleSpec.from_json(d.get("schedule"))
        return Plan(**d)

    def __str__(self) -> str:
        p = self.problem
        return (f"Plan[{p.key()} {self.orientation} blocks=({self.bm},{self.bk},"
                f"{self.bn}) grid={self.grid} kernel={self.kernel.key()} "
                f"schedule={self.schedule.key()} "
                f"impl={self.impl} prepack={self.prepack} "
                f"t_c={self.t_compute:.2e}s "
                f"t_m={self.t_memory:.2e}s by={self.chosen_by}]")


# ---------------------------------------------------------------------------
# Batch buckets + PlanSet (DESIGN.md §7) and the 2D bucket grid (§8)
# ---------------------------------------------------------------------------


def buckets_for(max_batch: int, min_bucket: int = 1) -> tuple:
    """Power-of-two buckets ``min_bucket``..max_batch.

    ``max_batch`` itself is always a bucket, so a full batch never pads."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
    out = []
    b = min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def length_buckets_for(max_prompt: int, min_prompt: int = 8) -> tuple:
    """Power-of-two prompt-length buckets min_prompt..max_prompt.

    The floor keeps the jit-program count bounded (a 1-token prompt shares
    the ``min_prompt`` program); ``max_prompt`` is always a bucket."""
    return buckets_for(max_prompt, min(min_prompt, max_prompt))


def bucket_for(n: int, buckets: tuple) -> int:
    """Smallest bucket >= n (the admission pad target)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class PlanSet:
    """Per-bucket execution plans for one (k, n) weight shape.

    The serving runtime is batch-adaptive: each power-of-two bucket m gets
    its own Plan (the vmem working set and MXU occupancy both depend on m),
    while the packed weight layout is shared across buckets (see
    ``core.tsmm.prepack_for``).  Buckets whose (m, k, n) is not TSMM-shaped
    are absent — callers fall back to plain GEMM for those.
    """

    plans: Mapping[int, Plan]

    @property
    def buckets(self) -> tuple:
        return tuple(sorted(self.plans))

    def for_batch(self, m: int) -> Optional[Plan]:
        """Plan of the smallest bucket >= m.

        Returns None when the set is empty OR when ``m`` exceeds every
        bucket: a plan tuned for a smaller batch would replay with
        ``bm = problem.m`` blocks too small for the real batch, so the
        caller must split the group or fall back to plain GEMM instead of
        silently running a mistuned plan."""
        bs = self.buckets
        for b in bs:
            if b >= m:
                return self.plans[b]
        return None

    def to_json(self) -> dict:
        return {str(m): p.to_json() for m, p in self.plans.items()}

    @staticmethod
    def from_json(d: dict) -> "PlanSet":
        return PlanSet({int(m): Plan.from_json(p) for m, p in d.items()})


# ---------------------------------------------------------------------------
# 2D bucket grid: batch-bucket x length-bucket (DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketGrid:
    """Admission grid for ragged traffic: requests arrive with any
    (batch, prompt-length) and are padded up to the minimal covering
    (batch-bucket, length-bucket) cell.

    Execution plans, the install sweep, and the engine's jit caches are
    all keyed by the cell: a cell's prefill problem has ``m = bb * lb``
    tokens, its decode problem ``m = bb``.  Both axes are power-of-two
    ladders whose ceiling is always a bucket (see ``buckets_for``).
    """

    batch: tuple
    length: tuple

    @staticmethod
    def build(max_batch: int, max_prompt: int,
              min_prompt: int = 8) -> "BucketGrid":
        return BucketGrid(buckets_for(max_batch),
                          length_buckets_for(max_prompt, min_prompt))

    @property
    def max_batch(self) -> int:
        return self.batch[-1]

    @property
    def max_prompt(self) -> int:
        return self.length[-1]

    def cell_for(self, b: int, s: int) -> tuple:
        """Minimal covering (batch_bucket, length_bucket) for a group of
        ``b`` requests whose longest prompt is ``s`` tokens."""
        return (bucket_for(b, self.batch), bucket_for(s, self.length))

    def length_bucket(self, s: int) -> int:
        return bucket_for(s, self.length)

    def cells(self) -> tuple:
        return tuple((bb, lb) for bb in self.batch for lb in self.length)

    def token_buckets(self) -> tuple:
        """Distinct prefill token counts ``bb * lb`` over all cells —
        the m-values the install sweep plans for the prefill path."""
        return tuple(sorted({bb * lb for bb, lb in self.cells()}))

    def padding_waste(self, b: int, s: int) -> int:
        """Padded-token overhead of admitting (b, s): cell tokens minus
        real tokens."""
        bb, lb = self.cell_for(b, s)
        return bb * lb - b * s


@dataclasses.dataclass(frozen=True)
class PlanGrid:
    """Per-cell prefill plans for one (k, n) weight shape.

    The cell (bb, lb) maps to the TSMM problem (bb*lb, k, n); cells whose
    token count is not TSMM-shaped are absent (plain GEMM at runtime).
    Distinct cells with the same token count share one Plan object."""

    grid: BucketGrid
    plans: Mapping[tuple, Plan]

    def for_request(self, b: int, s: int) -> Optional[Plan]:
        """Plan of the minimal covering cell (None if outside the grid or
        the cell is not TSMM-shaped)."""
        try:
            cell = self.grid.cell_for(b, s)
        except ValueError:
            return None
        return self.plans.get(cell)

    def to_json(self) -> dict:
        return {
            "batch": list(self.grid.batch),
            "length": list(self.grid.length),
            "plans": {f"{bb}x{lb}": p.to_json()
                      for (bb, lb), p in self.plans.items()},
        }

    @staticmethod
    def from_json(d: dict) -> "PlanGrid":
        grid = BucketGrid(tuple(d["batch"]), tuple(d["length"]))
        plans = {}
        for key, pj in d["plans"].items():
            bb, lb = key.split("x")
            plans[(int(bb), int(lb))] = Plan.from_json(pj)
        return PlanGrid(grid, plans)
