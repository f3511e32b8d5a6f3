"""Inner-kernel variant subsystem: the tall-A and skinny-A dispatch.

A :class:`KernelSpec` names one point of the ``variants.grammar`` spec
grammar (legacy names are aliases for their grammar points);
``run_tall_a`` and ``run_skinny_a`` lower any valid point through
``kernels.gen.emit_tall_a`` / ``emit_skinny_a`` onto the CUDA tall and
skinny kernels, or onto their plain PyTorch versions for CPU tensors.
``verify_variants`` and ``verify_schedules`` are the install stage's
``--check`` of the grammar.

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
    "specs_for", "to_kernel_spec", "variant_names", "verify_schedules",
    "verify_variants",
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


# ---------------------------------------------------------------------------
# grammar self-check (install --check)
# ---------------------------------------------------------------------------


def _checker(device: str, dtype: str, seed: int):
    """(mk, check) for one self-check: ``mk(shape)`` draws a seeded
    operand on ``device``; ``check(run, want_fn)`` runs ``run(operands)``
    and compares it, within the dtype's tolerance, with: on a CUDA
    device, the same call on CPU copies of the operands (the kernels'
    plain versions), after checking that the call launched a CUDA kernel;
    on the CPU, ``want_fn`` (``kernels/ref.py``)."""
    import numpy as np
    import torch

    device = torch.device(device)
    dt = getattr(torch, dtype)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)
    rng = np.random.default_rng(seed)

    def mk(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt).to(device)

    def check(run, args, want_fn, rows, cols):
        if device.type == "cuda":
            from repro_torch.kernels import cuda
            before = sum(cuda.launches.values())
            got = run(*args)
            if sum(cuda.launches.values()) == before:
                raise AssertionError("no CUDA kernel launched")
            want = run(*(a.cpu() if torch.is_tensor(a) else a
                         for a in args))
        else:
            got, want = run(*args), want_fn()
        torch.testing.assert_close(
            got[:rows, :cols].float().cpu(), want[:rows, :cols].float().cpu(),
            **tol)

    return mk, check


def verify_variants(device: str = "cpu", *, dtype: str = "float32",
                    stride: int = 3) -> list:
    """Run a sampled set of grammar points — EVERY legacy-equivalent point
    plus every ``stride``-th novel ``gen`` point — on one tiny shape per
    regime (the reference's) and check each.

    On a CUDA device each point runs through the CUDA kernels and is held
    to its plain version on the same inputs; on the CPU the plain version
    is held to ``kernels/ref.py``.  Returns ``{spec, orientation, ok,
    error}`` per point; ``install --check`` fails when any is not ok."""
    from repro_torch.kernels import ops, ref

    mk, check = _checker(device, dtype, 0)
    # tall: M=256, K=512, N=8 with a bias, so every point's epilogue
    # placement is exercised; skinny: m=4, K=512, N=256
    a, bt = mk((256, 512)), mk((512, 8))
    x, w = mk((4, 512)), mk((512, 256))
    bias = mk((256,))
    bias_t = mk((8,))

    out = []
    for spec in sampled_specs_for("tall_a", stride=stride):
        row = {"spec": spec.key(), "orientation": "tall_a",
               "ok": True, "error": ""}
        try:
            for packed in (False, True):
                check(lambda a_, b_, c_, packed=packed, spec=spec: run_tall_a(
                          spec, ops.pack_blocks(a_, 128, 128) if packed
                          else a_, b_, c_, bm=128, bk=128, packed=packed),
                      (a, bt, bias_t),
                      lambda: ref.tsmm_ref(a, bt, bias=bias_t), 256, 8)
        except Exception as e:  # a broken point must not abort the sweep
            row["ok"] = False
            row["error"] = f"{type(e).__name__}: {e}"
        out.append(row)
    seen = set()
    for prepack in (True, False):
        for spec in sampled_specs_for("skinny_a", prepack, stride=stride):
            if spec.key() in seen:
                continue
            seen.add(spec.key())
            row = {"spec": spec.key(), "orientation": "skinny_a",
                   "ok": True, "error": ""}
            try:
                g = from_kernel_spec(spec)
                modes = (False,) if g.packfuse else (True, False)
                for packed in modes:
                    check(lambda x_, w_, c_, packed=packed, spec=spec:
                          run_skinny_a(spec, x_, ops.pack_blocks(w_, 128, 128)
                                       if packed else w_, c_, None, bk=128,
                                       bn=128, packed=packed),
                          (x, w, bias),
                          lambda: ref.tsmm_ref(x, w, bias=bias), 4, 256)
            except Exception as e:
                row["ok"] = False
                row["error"] = f"{type(e).__name__}: {e}"
            out.append(row)
    return out


def verify_schedules(device: str = "cpu", *, dtype: str = "float32") -> list:
    """Run EVERY enumerable grid schedule against every legacy-equivalent
    grammar point (plus a couple of novel points) it applies to, on one
    tiny shape, checked as in :func:`verify_variants` — the schedule
    axis's self-check.  Also runs the all-``arbitrary`` dimension
    semantics override and an ``mb=3`` schedule (neither enumerated, both
    reachable through ``REPRO_TSMM_SCHEDULE``).  Returns ``{spec,
    schedule, orientation, ok, error}`` per combination."""
    from repro_torch.core.plan import ScheduleSpec, schedules_for
    from repro_torch.kernels import ops, ref

    mk, check = _checker(device, dtype, 1)
    # M=512 / bm=128 -> 4 row panels, so m_split in {2, 4} divides evenly
    a, bt = mk((512, 512)), mk((512, 8))
    x, w = mk((4, 512)), mk((512, 256))
    bias_t, bias_s = mk((8,)), mk((256,))

    def sampled(orientation, prepack=True):
        legacy = legacy_specs_for(orientation, prepack)
        novel = [s for s in specs_for(orientation, prepack)
                 if s.name == "gen"]
        return legacy + novel[:2]

    out = []
    for orientation in grammar.ORIENTATIONS:
        specs = sampled(orientation) if orientation == "tall_a" else \
            sampled(orientation, True) + [
                s for s in sampled(orientation, False)
                if from_kernel_spec(s).packfuse][:1]
        for spec in specs:
            g = from_kernel_spec(spec)
            scheds = list(schedules_for(orientation, spec))
            scheds.append(ScheduleSpec(dims=("arbitrary", "arbitrary")))
            if g.loop != "kouter":
                scheds.append(ScheduleSpec(multibuffer=3))
            for sched in scheds:
                row = {"spec": spec.key(), "schedule": sched.key(),
                       "orientation": orientation, "ok": True, "error": ""}
                try:
                    if orientation == "tall_a":
                        check(lambda a_, b_, c_, spec=spec, sched=sched:
                              run_tall_a(spec, a_, b_, c_, bm=128, bk=128,
                                         packed=False, schedule=sched),
                              (a, bt, bias_t),
                              lambda: ref.tsmm_ref(a, bt, bias=bias_t),
                              512, 8)
                    else:
                        check(lambda x_, w_, c_, spec=spec, sched=sched, g=g:
                              run_skinny_a(spec, x_, w_ if g.packfuse else
                                           ops.pack_blocks(w_, 128, 128),
                                           c_, None, bk=128, bn=128,
                                           packed=not g.packfuse,
                                           schedule=sched),
                              (x, w, bias_s),
                              lambda: ref.tsmm_ref(x, w, bias=bias_s),
                              4, 256)
                except Exception as e:
                    row["ok"] = False
                    row["error"] = f"{type(e).__name__}: {e}"
                out.append(row)
    return out
