"""Kernel-variant specs over the synthesis grammar.

A copy of the reference package's ``kernels/variants/spec.py``: the port
keeps its own so that it never imports the JAX package.

The paper's install-time stage selects among *competing inner kernels*,
not just block sizes.  A :class:`KernelSpec` names one member of that
family and rides on ``core.plan.Plan`` as a first-class tuning axis: it
round-trips through the plan registry's JSON, extends ``Plan.tuning_key``
(so the measurement cache never conflates two schedules), and the
autotuner enumerates the cross product of variants x block shapes.

Since the generator refactor (DESIGN.md §14) the variant family is no
longer a closed registry of hand-written kernels: :func:`specs_for`
renders ``variants.grammar.enumerate_points`` — every emittable
:class:`~repro_torch.kernels.variants.grammar.GenSpec` — to candidate specs.
Points equivalent to a pre-grammar variant keep their legacy name
(``ksplit[splits=2]``, ``kmajor``, ...) so old registry JSON and
measurement-cache tuning keys keep resolving; novel points spell their
non-default axes as ``gen[...]`` params.

This module is import-light on purpose — ``core.plan`` imports it.  The
CUDA emitters live in ``kernels.gen`` and load only when a spec is run.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

BASELINE_NAME = "baseline"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One point in the kernel-variant dimension of the search space.

    ``params`` is a sorted tuple of (key, value) pairs so specs hash and
    compare structurally (frozen dataclasses with dicts would not)."""

    name: str = BASELINE_NAME
    params: tuple = ()

    @staticmethod
    def make(name: str, **params) -> "KernelSpec":
        return KernelSpec(name, tuple(sorted(params.items())))

    def kwargs(self) -> dict:
        return dict(self.params)

    @property
    def is_baseline(self) -> bool:
        return self.name == BASELINE_NAME and not self.params

    def key(self) -> str:
        """Stable string identity, e.g. ``ksplit[splits=2]``."""
        if not self.params:
            return self.name
        inner = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.name}[{inner}]"

    def to_json(self) -> dict:
        return {"name": self.name, "params": dict(self.params)}

    @staticmethod
    def from_json(d: Optional[Mapping]) -> "KernelSpec":
        """Decode a spec; ``None``/missing (pre-variant plan records on
        disk) defaults to the baseline variant — old registries load."""
        if d is None:
            return KernelSpec()
        if isinstance(d, KernelSpec):
            return d
        return KernelSpec.make(d["name"], **dict(d.get("params") or {}))


BASELINE = KernelSpec()


def _parse_value(v: str):
    v = v.strip()
    try:
        return int(v)
    except ValueError:
        return v


def parse_spec(text: str) -> KernelSpec:
    """Parse ``name`` / ``name:k=v,k2=v2`` (the ``REPRO_TSMM_VARIANT``
    syntax).  Accepts both legacy variant names (``ksplit:splits=2``) and
    raw grammar points (``gen:loop=kouter,acc=revisit``).  Raises with
    the full variant list AND the grammar's axis/value/rule listing on a
    bad name, axis, value, or rule violation."""
    from repro_torch.kernels.variants import grammar

    text = text.strip()
    name, _, rest = text.partition(":")
    name = name.strip()
    if name not in grammar.LEGACY_ORIENTATIONS:
        raise ValueError(
            f"unknown kernel variant {name!r}; registered variants: "
            f"{', '.join(variant_names())}\n{grammar.describe_axes()}")
    params = {}
    for part in rest.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        params[k.strip()] = _parse_value(v)
    spec = KernelSpec.make(name, **params)
    grammar.from_kernel_spec(spec)   # validates axes, values, and rules
    return spec


def variant_names() -> list:
    """Every spellable variant NAME: the legacy family plus the ``gen``
    grammar namespace (sorted, for deterministic error listings)."""
    from repro_torch.kernels.variants import grammar
    return sorted(grammar.LEGACY_ORIENTATIONS)


def specs_for(orientation: str, prepack: bool = True) -> list:
    """Every emittable KernelSpec for (orientation, prepack), baseline
    first — the variant dimension of the autotuner's search space.
    Rendered from the grammar enumeration, so the space grows with the
    grammar rather than with hand-written registrations; deterministic
    order (baseline, then legacy-named points, then ``gen[...]`` by
    key)."""
    from repro_torch.kernels.variants import grammar
    out = [grammar.to_kernel_spec(g, orientation)
           for g in grammar.enumerate_points(orientation, prepack)]
    out.sort(key=lambda s: (not s.is_baseline, s.name == "gen", s.key()))
    return out


def legacy_specs_for(orientation: str, prepack: bool = True) -> list:
    """The grammar points equivalent to a pre-grammar hand-written
    variant (their specs keep the legacy names) — the back-compat subset
    every parity/interpret check must always cover."""
    return [s for s in specs_for(orientation, prepack) if s.name != "gen"]


def sampled_specs_for(orientation: str, prepack: bool = True,
                      stride: int = 5) -> list:
    """Bounded deterministic sample of the grammar space: EVERY
    legacy-equivalent point plus every ``stride``-th novel ``gen`` point.
    Tier-1 tests parametrize over this (the full enumeration rides in
    ``install --check``'s interpret sweep, where wall clock is budgeted
    for it)."""
    legacy, novel = [], []
    for s in specs_for(orientation, prepack):
        (legacy if s.name != "gen" else novel).append(s)
    return legacy + novel[::max(1, stride)]
