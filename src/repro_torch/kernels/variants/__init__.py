"""Inner-kernel variant subsystem: the tall-A and skinny-A dispatch.

A :class:`KernelSpec` names one point of the ``variants.grammar`` spec
grammar (legacy names are aliases for their grammar points);
``run_tall_a`` and ``run_skinny_a`` lower any valid point through
``kernels.gen.emit_tall_a`` / ``emit_skinny_a`` onto the CUDA tall and
skinny kernels, or onto their plain PyTorch versions for CPU tensors.

This ``__init__`` imports only the spec/grammar modules; the emitter
module loads the first time a spec is run.
"""

from __future__ import annotations

from repro_torch.kernels.variants import grammar
from repro_torch.kernels.variants.grammar import (GRAMMAR_VERSION, GenSpec,
                                                  from_kernel_spec,
                                                  to_kernel_spec)
from repro_torch.kernels.variants.spec import (BASELINE, BASELINE_NAME,
                                               KernelSpec, legacy_specs_for,
                                               parse_spec, sampled_specs_for,
                                               specs_for, variant_names)

__all__ = [
    "BASELINE", "BASELINE_NAME", "GRAMMAR_VERSION", "GenSpec", "KernelSpec",
    "applies_to", "from_kernel_spec", "grammar", "legacy_specs_for",
    "parse_spec", "run_skinny_a", "run_tall_a", "sampled_specs_for",
    "specs_for", "to_kernel_spec", "variant_names",
]


def applies_to(spec: KernelSpec, orientation: str) -> bool:
    """Whether ``spec``'s grammar point is emittable for ``orientation``
    (in at least one pre-packing regime) — the gate the
    ``REPRO_TSMM_VARIANT`` override uses so that forcing an
    orientation-specific variant only rebinds the matching regime.
    Legacy names stay pinned to the orientations they were registered
    for."""
    if spec.name not in grammar.LEGACY_ORIENTATIONS:
        raise ValueError(
            f"unknown kernel variant {spec.name!r}; registered variants: "
            f"{', '.join(variant_names())}")
    if orientation not in grammar.LEGACY_ORIENTATIONS[spec.name]:
        return False
    g = from_kernel_spec(spec)
    return (grammar.valid(g, orientation, True)
            or grammar.valid(g, orientation, False))


def run_tall_a(spec: KernelSpec, a, b, bias=None, act=None, *, bm: int = 0,
               bk: int = 0, packed: bool = False, schedule=None):
    """Dispatch a tall-A (prefill) matmul at ``spec``'s grammar point.

    ``a`` is natural (M, K) or pre-packed (nm, nk, bm, bk) per ``packed``
    (the caller owns the pack).  ``bias``/``act`` fuse into the point's
    epilogue placement; ``schedule`` is the plan's ScheduleSpec (None:
    the default)."""
    if not applies_to(spec, "tall_a"):
        raise ValueError(f"kernel variant {spec.key()!r} has no tall_a "
                         f"implementation")
    from repro_torch.kernels import gen
    return gen.emit_tall_a(from_kernel_spec(spec), a, b, bias, act, bm=bm,
                           bk=bk, packed=packed, schedule=schedule)


def run_skinny_a(spec: KernelSpec, x, w, bias=None, act=None, *,
                 bk: int = 0, bn: int = 0, packed: bool = True,
                 schedule=None):
    """Dispatch a skinny-A (decode) matmul at ``spec``'s grammar point.

    ``w`` is the packed (nk, nn, bk, bn) blocks when ``packed`` else the
    natural (K, N) weight.  A pack-fusing point against an already-packed
    weight runs the baseline kernel (there is no pack left to fuse).
    Returns (m, N padded to the block width)."""
    if not applies_to(spec, "skinny_a"):
        raise ValueError(f"kernel variant {spec.key()!r} has no skinny_a "
                         f"implementation")
    from repro_torch.kernels import gen
    return gen.emit_skinny_a(from_kernel_spec(spec), x, w, bias, act, bk=bk,
                             bn=bn, packed=packed, schedule=schedule)
