"""Fused vs post-hoc tall-A epilogues, on the port.

    PYTHONPATH=src python3 -m repro_torch.launch.epilogue_fusion \\
        [--device cuda] [--rounds 24] [--json PATH]

The port of the reference's ``benchmarks/epilogue_fusion.py``.  Every
tall-A kernel applies bias and activation in its epilogue
(``csrc/tsmm_tall.cu``, mode 0); a post-hoc epilogue would pay another
read and write of the (m, n) output.  At the reference's three fp32 gate
shapes (tall activations x skinny weight, the MLP up-projection case;
the SIMT kernel on the card) it times both with ``_paired`` (A/B rounds
in alternating order, the speedup the median of the per-round ratios),
each call timed by the evaluator (CUDA events after an L2 flush; the
host clock on the CPU), after holding the two outputs to each other
within 1e-4 + 1e-4 |ref|.  Beside the measured speedup it quotes the
cost model's fusion credit: ``smem_model.hbm_traffic_bytes(plan,
epilogue="posthoc")`` against the fused value.

The reference's second row per shape times the model-best non-default
grid schedule against the default one.  On the card ``m_split``, ``dims``
and ``multibuffer`` change no launch (ROADMAP Queue 3 observations), so
that row says so, with the non-default plan's ``launch_key`` shown
equal to its default-schedule twin's, and times nothing.  Writes the
rows as JSON to ``build/bench/epilogue_fusion.json`` (or ``--json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.plan import DEFAULT_SCHEDULE, Problem

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_JSON = ROOT / "build" / "bench" / "epilogue_fusion.json"

# the reference's gate shapes (its GATE_PROBLEMS) and activation
GATE_PROBLEMS = [
    Problem(2048, 2048, 128, "float32"),
    Problem(4096, 2048, 128, "float32"),
    Problem(4096, 1024, 240, "float32"),
]
ACT = "gelu"
TOL = 1e-4        # fp32: the same sums, the epilogue applied in fp32


def _paired(fn_a, fn_b, device, *, warmup: int = 2, rounds: int = 24) -> dict:
    """Paired A/B timing: each round times both callables back to back,
    the order alternating by round, and ``speedup`` is the median of the
    per-round b/a ratios, so drift that hits both sides of a round
    cancels.  ``best`` / ``median`` per side are over the rounds."""
    from repro_torch.core.evaluator import time_samples

    for fn in (fn_a, fn_b):
        time_samples(fn, warmup=warmup, iters=0, device=device)
    ta, tb = [], []
    for r in range(rounds):
        order = ((fn_a, ta), (fn_b, tb)) if r % 2 == 0 else \
            ((fn_b, tb), (fn_a, ta))
        for fn, sink in order:
            sink += time_samples(fn, warmup=0, iters=1, device=device)
    ratios = [b / a for a, b in zip(ta, tb)]
    return {"a": {"best": float(np.min(ta)), "median": float(np.median(ta))},
            "b": {"best": float(np.min(tb)), "median": float(np.median(tb))},
            "speedup": float(np.median(ratios))}


def _posthoc_epilogue(out, bias, act):
    """The pre-fusion behaviour: bias add and activation as separate
    passes over the written output, each reading and writing all of it
    (the reference's ``_posthoc_epilogue``)."""
    from repro_torch.kernels.ref import act_ref
    out = out + bias.to(out.dtype)
    return act_ref(out.float(), act).to(out.dtype)


def _operands(p: Problem, device, seed: int = 0):
    """A, B, bias of ``p`` from numpy's generator (as the reference
    makes them)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device) for s in ((p.m, p.k), (p.k, p.n), (p.n,)))


def plan_for(prob: Problem, hw):
    """The model-best default-schedule candidate (the reference's pick)."""
    from repro_torch.core.autotuner import candidate_blocks
    return next(c for c in candidate_blocks(prob, hw) if c.schedule.is_default)


def fused_and_posthoc(plan, a, b, bias, act=ACT) -> tuple:
    """Zero-arg callables of the plan's kernel on the natural A with the
    epilogue fused, and without it followed by :func:`_posthoc_epilogue`."""
    from repro_torch.kernels import variants
    spec, sched = plan.kernel, plan.schedule

    def fused():
        return variants.run_tall_a(spec, a, b, bias, act, bm=plan.bm,
                                   bk=plan.bk, packed=False, schedule=sched)

    def posthoc():
        out = variants.run_tall_a(spec, a, b, bm=plan.bm, bk=plan.bk,
                                  packed=False, schedule=sched)
        return _posthoc_epilogue(out, bias, act)
    return fused, posthoc


def run(device="cuda", *, rounds: int = 24, json_path=DEFAULT_JSON) -> list:
    from repro_torch.core.autotuner import candidate_blocks
    from repro_torch.core.evaluator import calibrated_hw
    from repro_torch.core.smem_model import (epilogue_roundtrip_bytes,
                                             hbm_traffic_bytes, launch_key)
    from repro_torch.serve.engine import resolve_device

    device = resolve_device(device)
    hw = calibrated_hw(device=device)
    rows = []
    for prob in GATE_PROBLEMS:
        plan = plan_for(prob, hw)
        a, b, bias = _operands(prob, device)
        fused, posthoc = fused_and_posthoc(plan, a, b, bias)
        # parity first: a fast wrong epilogue must not win
        got, want = fused().float(), posthoc().float()
        if not bool(torch.all((got - want).abs() <= TOL + TOL * want.abs())):
            raise AssertionError(f"epilogue_fusion {prob.key()}: fused and "
                                 f"post-hoc epilogues differ by "
                                 f"{float((got - want).abs().max())}")
        del got, want
        res = _paired(fused, posthoc, device, rounds=rounds)
        credit = epilogue_roundtrip_bytes(plan)
        traffic = hbm_traffic_bytes(plan)
        posthoc_traffic = hbm_traffic_bytes(plan, epilogue="posthoc")
        assert posthoc_traffic - traffic == credit
        rows.append({"name": f"epilogue_fusion_{prob.key()}",
                     "plan": str(plan), "us": res["a"]["best"] * 1e6,
                     "posthoc_us": res["b"]["best"] * 1e6,
                     "speedup": res["speedup"],
                     "median_us": res["a"]["median"] * 1e6,
                     "posthoc_median_us": res["b"]["median"] * 1e6,
                     "model_credit_bytes": credit, "traffic_fused": traffic,
                     "traffic_posthoc": posthoc_traffic})
        print(json.dumps(rows[-1]), flush=True)
        # the schedule axis: nothing to time on the card, where the
        # model-best non-default schedule launches what its default twin
        # does (the same kernels on the same layouts)
        alt = next((c for c in candidate_blocks(prob, hw)
                    if not c.schedule.is_default), None)
        if alt is not None:
            twin = dataclasses.replace(alt, schedule=DEFAULT_SCHEDULE)
            rows.append({"name": f"schedule_axis_{prob.key()}",
                         "plan": str(alt), "schedule": alt.schedule.key(),
                         "timed": False,
                         "same_launches_as_default": (
                             launch_key(alt, hw) == launch_key(twin, hw)
                             if hw.gate == "launch" else None),
                         "note": "m_split, dims and multibuffer change no "
                                 "launch on the card: nothing to time"})
            print(json.dumps(rows[-1]), flush=True)
    if json_path:
        out = Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "bench": "epilogue_fusion", "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "rows": rows}, indent=1))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=24,
                    help="paired A/B timing rounds per shape")
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="where the rows go (empty: nowhere)")
    args = ap.parse_args(argv)
    run(args.device, rounds=args.rounds, json_path=args.json or None)


if __name__ == "__main__":
    main()
