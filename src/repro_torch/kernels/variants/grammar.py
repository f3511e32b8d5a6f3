"""Kernel-synthesis spec grammar, copied from the reference package.

PR 4 seeded the inner-kernel tuning axis with a closed list of ~8
hand-written variant bodies.  This module replaces that list with a small
grammar: a :class:`GenSpec` is one point in the cross product of

* ``loop``     — contraction loop order: ``kinner`` streams K blocks under
  a grid whose innermost axis is K; ``kouter`` walks K in a sequential
  ``fori_loop`` inside one grid step per output row panel;
* ``ksplit``   — K-split factor: >1 partitions the contraction into that
  many partial-sum groups reduced post-hoc (the paper's k-split schedule);
* ``acc``      — accumulator residency: ``vmem`` keeps an fp32 scratch
  accumulator; ``revisit`` accumulates directly into the (fp32) output
  block across grid steps and pays a cast pass afterwards;
* ``bres``     — streamed-operand residency: ``stream`` re-fetches one
  block per grid step; ``resident`` pins the whole streamed operand (B for
  tall-A, X for skinny-A) in VMEM and slices it with ``pl.ds``;
* ``epi``      — epilogue placement: ``fused`` in the kernel epilog,
  ``split`` as a separate pass, ``postreduce`` fused into the partial-sum
  reduction (k-split only);
* ``packfuse`` — consume the natural-layout weight directly (fuse the
  block-packing into the kernel's index map) instead of packing first.

``kernels.gen`` lowers any valid skinny-A point onto the hand-written
CUDA kernel (or its plain PyTorch version on the CPU).  Every legacy ``KernelSpec`` name maps to exactly one grammar
point (:func:`from_kernel_spec`) and that point renders BACK to the legacy
name (:func:`to_kernel_spec`), so registry JSON, measurement-cache tuning
keys and PackedTensor kernel stamps written before the grammar existed
keep resolving bit-for-bit.  Structural rules (below) cut the raw cross
product down to the emittable space; orientation rules restrict points to
the regime they make sense in.  This module stays import-light so plan
decoding and CLI parsing never pay for the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.kernels.variants.spec import KernelSpec

# Version stamp for the generator + grammar semantics.  Folded into the
# ProgramStore structural key (serve/programs.py): AOT executables compiled
# against one generation of kernel bodies must not be replayed after the
# emitter changes underneath them.  Bump on ANY change to the grammar's
# axes, rules, or emitted kernel semantics.
GRAMMAR_VERSION = "gen-1"

LOOPS = ("kinner", "kouter")
KSPLITS = (1, 2, 4, 8)
ACCS = ("vmem", "revisit")
BRES = ("stream", "resident")
EPIS = ("fused", "split", "postreduce")

#: axis name -> value domain, in canonical ``gen:axis=value`` spelling
AXES = {
    "loop": LOOPS,
    "ksplit": KSPLITS,
    "acc": ACCS,
    "bres": BRES,
    "epi": EPIS,
    "packfuse": (0, 1),
}

ORIENTATIONS = ("tall_a", "skinny_a")

#: legacy KernelSpec name -> orientations it was registered for (PR 4).
#: ``gen`` is the open-ended namespace for points with no legacy name.
LEGACY_ORIENTATIONS = {
    "baseline": ("tall_a", "skinny_a"),
    "ksplit": ("tall_a", "skinny_a"),
    "kmajor": ("tall_a",),
    "b_resident": ("tall_a",),
    "epilogue_split": ("skinny_a",),
    "fused_pack": ("skinny_a",),
    "gen": ("tall_a", "skinny_a"),
}


@dataclasses.dataclass(frozen=True)
class GenSpec:
    """One point of the kernel-synthesis grammar.  Frozen + hashable so it
    can ride as a static argument on the jitted emitter programs."""

    loop: str = "kinner"
    ksplit: int = 1
    acc: str = "vmem"
    bres: str = "stream"
    epi: str = "fused"
    packfuse: bool = False


BASELINE_POINT = GenSpec()

# Structural rules — orientation-independent emittability constraints.
# Each entry: (predicate that must HOLD, rule text shown in errors).
_RULES = (
    (lambda g: g.loop != "kouter"
     or (g.ksplit == 1 and g.acc == "revisit" and g.bres == "stream"),
     "loop=kouter implies ksplit=1, acc=revisit, bres=stream (the "
     "sequential K walk IS the revisit; splitting/pinning it is moot)"),
    (lambda g: g.ksplit == 1
     or (g.acc == "vmem" and g.epi in ("postreduce", "split")),
     "ksplit>1 implies acc=vmem and epi in {postreduce, split} (partial "
     "sums land in fp32 group outputs; the epilogue runs at/after the "
     "reduction)"),
    (lambda g: g.ksplit > 1 or g.epi != "postreduce",
     "epi=postreduce implies ksplit>1 (there is no reduction to fuse "
     "into otherwise)"),
    (lambda g: g.acc != "revisit" or g.epi in ("fused", "split"),
     "acc=revisit implies epi in {fused, split}"),
    (lambda g: not g.packfuse or (g.loop == "kinner" and g.acc == "vmem"),
     "packfuse implies loop=kinner and acc=vmem (the natural-layout "
     "index map needs the blocked K-inner grid)"),
)


def describe_axes() -> str:
    """Human-readable axis/value/rule listing — appended to every bad-spec
    error so ``REPRO_TSMM_VARIANT=gen:...`` typos are self-documenting."""
    lines = ["grammar axes (syntax gen:axis=value,axis=value,...):"]
    for axis, dom in AXES.items():
        lines.append(f"  {axis:8s} in {{{', '.join(str(v) for v in dom)}}}")
    lines.append("structural rules:")
    for _, msg in _RULES:
        lines.append(f"  - {msg}")
    lines.append("orientation rules:")
    lines.append("  - loop=kouter applies to tall_a only")
    lines.append("  - packfuse=1 applies to skinny_a without pre-packing "
                 "only")
    return "\n".join(lines)


def violations(g: GenSpec) -> Tuple[str, ...]:
    """Structural problems with ``g`` (empty tuple == emittable)."""
    out = []
    for axis in ("loop", "ksplit", "acc", "bres", "epi"):
        v = getattr(g, axis)
        if v not in AXES[axis]:
            out.append(f"{axis}={v!r} not in {{"
                       f"{', '.join(str(x) for x in AXES[axis])}}}")
    if out:
        return tuple(out)
    return tuple(msg for ok, msg in _RULES if not ok(g))


def valid(g: GenSpec, orientation: str, prepack: bool = True) -> bool:
    """Is ``g`` emittable for this orientation/pre-packing regime?"""
    if orientation not in ORIENTATIONS or violations(g):
        return False
    if g.loop == "kouter" and orientation != "tall_a":
        return False
    if g.packfuse and (orientation != "skinny_a" or prepack):
        return False
    return True


def enumerate_points(orientation: str, prepack: bool = True) -> list:
    """Every valid grammar point for the regime, deterministically ordered
    (baseline first).  This IS the tuner's kernel axis: ``specs_for``
    renders these points to candidate ``KernelSpec``s."""
    out = []
    for packfuse in (False, True):
        for loop in LOOPS:
            for ksplit in KSPLITS:
                for acc in ACCS:
                    for bres in BRES:
                        for epi in EPIS:
                            g = GenSpec(loop=loop, ksplit=ksplit, acc=acc,
                                        bres=bres, epi=epi,
                                        packfuse=bool(packfuse))
                            if valid(g, orientation, prepack):
                                out.append(g)
    return out


# ---------------------------------------------------------------------------
# Legacy KernelSpec <-> grammar point mapping (back-compat contract)
# ---------------------------------------------------------------------------


def from_kernel_spec(spec: KernelSpec) -> GenSpec:
    """Decode any ``KernelSpec`` — legacy PR-4 name or ``gen`` grammar
    syntax — to its grammar point.  Raises ``ValueError`` (with the full
    axis/value listing) on unknown names, axes, or rule violations."""
    if spec is None:
        return BASELINE_POINT
    name, params = spec.name, spec.kwargs()
    if name == "baseline":
        return BASELINE_POINT
    if name == "gen":
        return _decode_gen_params(params)
    if name == "ksplit":
        g = GenSpec(ksplit=int(params.get("splits", 2)), epi="postreduce")
    elif name == "kmajor":
        g = GenSpec(loop="kouter", acc="revisit")
    elif name == "b_resident":
        g = GenSpec(bres="resident")
    elif name == "epilogue_split":
        g = GenSpec(epi="split")
    elif name == "fused_pack":
        g = GenSpec(packfuse=True)
    else:
        raise ValueError(
            f"unknown kernel variant {name!r}; registered variants: "
            f"{', '.join(sorted(LEGACY_ORIENTATIONS))}\n{describe_axes()}")
    probs = violations(g)
    if probs:
        raise ValueError(f"kernel variant {spec.key()!r} decodes to an "
                         f"invalid grammar point: {'; '.join(probs)}\n"
                         f"{describe_axes()}")
    return g


def _decode_gen_params(params: dict) -> GenSpec:
    bad = sorted(set(params) - set(AXES))
    if bad:
        raise ValueError(f"unknown grammar axis {', '.join(bad)!s}\n"
                         f"{describe_axes()}")
    kw = {}
    for k, v in params.items():
        if k == "ksplit":
            try:
                v = int(v)
            except (TypeError, ValueError):
                pass                     # caught by the domain check below
        elif k == "packfuse":
            if not isinstance(v, bool):
                try:
                    v = bool(int(v))
                except (TypeError, ValueError):
                    raise ValueError(f"packfuse={v!r} not in {{0, 1}}\n"
                                     f"{describe_axes()}")
        kw[k] = v
    g = GenSpec(**kw)
    probs = violations(g)
    if probs:
        raise ValueError(f"invalid grammar point: {'; '.join(probs)}\n"
                         f"{describe_axes()}")
    return g


def to_kernel_spec(g: GenSpec, orientation: str) -> KernelSpec:
    """Render a grammar point to its canonical ``KernelSpec``: the legacy
    PR-4 name when this orientation registered one for the point (so
    tuning keys / registry JSON / PackedTensor stamps stay bit-identical
    with pre-grammar caches), ``gen[...]`` with non-default axes
    otherwise."""
    if g == BASELINE_POINT:
        return KernelSpec()
    if (g.ksplit > 1
            and g == GenSpec(ksplit=g.ksplit, epi="postreduce")):
        return KernelSpec.make("ksplit", splits=g.ksplit)
    if orientation == "tall_a":
        if g == GenSpec(loop="kouter", acc="revisit"):
            return KernelSpec.make("kmajor")
        if g == GenSpec(bres="resident"):
            return KernelSpec.make("b_resident")
    elif orientation == "skinny_a":
        if g == GenSpec(epi="split"):
            return KernelSpec.make("epilogue_split")
        if g == GenSpec(packfuse=True):
            return KernelSpec.make("fused_pack")
    params = {}
    for axis in ("loop", "ksplit", "acc", "bres", "epi", "packfuse"):
        v = getattr(g, axis)
        if v != getattr(BASELINE_POINT, axis):
            params[axis] = int(v) if axis == "packfuse" else v
    return KernelSpec.make("gen", **params)
