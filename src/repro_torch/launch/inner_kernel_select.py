"""Install-time inner-kernel selection over the kernel grammar (the
paper's Fig. 8), timed by the port's evaluator.

    PYTHONPATH=src python3 -m repro_torch.launch.inner_kernel_select \
        [--device cuda] [--json PATH]

The port of the reference's ``benchmarks/inner_kernel_select.py``.  The
paper benchmarks competing register-blocked inner kernels and keeps the
best; here the family is generated.  Per gate shape the hand-seeded
variants (baseline, k-split, k-major, B-resident, split epilogue,
pack-on-the-fly, each at its model-best block shape) race the tuner's
model-ranked short list over the whole grammar, measured together in one
interleaved pass (``measure_plans_interleaved``; on a CUDA device the
hand-written kernels under CUDA events), each distinct launch once.  The
assertions run inline:

* the grammar's space is >= 4x the hand-seeded variant list;
* the tuner's pick is never slower than the hand-seeded winner (its
  candidate set contains every hand-seeded plan, so a failure means the
  measurement itself is broken).

The gate shapes are the reference's three (fp32: the tall ``f32`` /
``tf32x3`` designs on the card) and two bf16 shapes of the ported models' serving paths (the Hopper
designs): GLM-4-9B's K/V projection at a 2048-token prefill and a
qwen1.5-4b MLP projection at decode batch 4.  Writes the rows as JSON to
``build/bench/inner_kernel_select.json`` (or ``--json``).
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

from repro_torch.core.autotuner import candidate_blocks, dedupe_short_list
from repro_torch.core.evaluator import calibrated_hw, measure_plans_interleaved
from repro_torch.core.hw import for_device
from repro_torch.core.plan import Problem
from repro_torch.core.registry import Registry
from repro_torch.kernels.variants import specs_for

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_JSON = ROOT / "build" / "bench" / "inner_kernel_select.json"

GATE_PROBLEMS = [
    Problem(2048, 2048, 16, "float32"),
    Problem(2048, 2048, 128, "float32"),
    Problem(64, 2048, 4096, "float32"),
    Problem(2048, 4096, 256, "bfloat16"),
    Problem(4, 2560, 6912, "bfloat16"),
]

# the closed hand-seeded candidate list the grammar replaced: tall
# [baseline, ksplit2, kmajor, b_resident], skinny [baseline, ksplit2,
# epilogue_split, fused_pack] — the 4x floor is against this
PRE_GRAMMAR_VARIANTS = 4

TOP_K = 8          # tuner short list: model-ranked grammar candidates


def hand_seeded_plans(cands) -> dict:
    """Model-best plan per legacy-named spec: candidates come back
    score-sorted, so the first plan seen per spec is its best block
    config under the model."""
    best = {}
    for plan in cands:
        if plan.kernel.name == "gen":
            continue
        best.setdefault(plan.kernel.key(), plan)
    return best


def run(device="cuda", json_path=DEFAULT_JSON, problems=GATE_PROBLEMS,
        rounds: int = 3) -> dict:
    import torch
    device = torch.device(device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_iks_",
                                     dir=ROOT / "build") as td:
        # a registry of its own: the benchmark's records stay out of the
        # install cache
        reg = Registry(plan_path=Path(td) / "plans.json",
                       measure_path=Path(td) / "measurements.json")
        hw = calibrated_hw(for_device(device), device=device)
        mode = "calibrated" if hw.calibrated else "datasheet"
        sections, summary = [], []
        for prob in problems:
            cands = candidate_blocks(prob, hw)
            if not cands:
                continue
            orientation = cands[0].orientation
            space = specs_for(orientation, prepack=(orientation == "tall_a"))
            assert len(space) >= 4 * PRE_GRAMMAR_VARIANTS, (
                f"grammar space for {orientation} is {len(space)}, < 4x the "
                f"hand-seeded list ({PRE_GRAMMAR_VARIANTS})")
            legacy = hand_seeded_plans(cands)
            # under the launch gate a plan stands for every plan of its
            # launch (the tournament's dedupe); the hand-seeded ones first
            union = dedupe_short_list(
                list(legacy.values())
                + dedupe_short_list(cands, hw)[:TOP_K], hw)
            legacy = {k: p for k, p in legacy.items() if p in union}
            recs = measure_plans_interleaved(union, device, rounds=rounds,
                                             warmup=1, reg=reg,
                                             source="benchmark")
            timed = sorted(zip(union, recs), key=lambda pr: pr[1].seconds)
            legacy_keys = {p.tuning_key() for p in legacy.values()}
            hand_best = min((r for p, r in timed
                             if p.tuning_key() in legacy_keys),
                            key=lambda r: r.seconds)
            tuner_pick = timed[0][1]     # min over the measured superset
            assert tuner_pick.seconds <= hand_best.seconds, \
                "tournament pick slower than a plan inside its own superset"

            print(f"\n== {prob.key()} ({mode} model, grammar space "
                  f"{len(space)}, {device}) ==")
            print(f"{'candidate':34s} {'blocks':>18s} {'model_s':>10s} "
                  f"{'measured_s':>11s}")
            rows = []
            for plan, rec in timed:
                origin = ("hand-seeded" if plan.tuning_key() in legacy_keys
                          else "generated")
                mark = " <- tuner-pick" if rec is tuner_pick else ""
                print(f"{plan.kernel.key():34s} ({plan.bm:5d},{plan.bk:5d},"
                      f"{plan.bn:5d}) {plan.score:10.3e} "
                      f"{rec.seconds:11.3e}  {origin}{mark}")
                rows.append({"kernel": plan.kernel.key(),
                             "schedule": plan.schedule.key(),
                             "blocks": [plan.bm, plan.bk, plan.bn],
                             "prepack": plan.prepack, "origin": origin,
                             "model_s": plan.score, "measured_s": rec.seconds,
                             "dispersion": rec.dispersion})
            sections.append({"problem": prob.key(), "rows": rows})
            summary.append({
                "problem": prob.key(), "pick": tuner_pick.plan.kernel.key(),
                "pick_s": tuner_pick.seconds,
                "hand_best": hand_best.plan.kernel.key(),
                "hand_best_s": hand_best.seconds,
                "speedup_vs_hand": hand_best.seconds
                / max(tuner_pick.seconds, 1e-12),
                "grammar_space": len(space),
                "space_growth": len(space) / PRE_GRAMMAR_VARIANTS})
    blob = {"bench": "inner_kernel_select", "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "model": mode, "sections": sections, "summary": summary}
    if json_path:
        out = Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(blob, indent=1))
        print(f"wrote {out}")
    for row in summary:
        print(json.dumps(row))
    return blob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="where the rows go (empty: nowhere)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="interleaved timing rounds per candidate")
    args = ap.parse_args(argv)
    from repro_torch.serve.engine import resolve_device
    run(resolve_device(args.device), args.json or None, rounds=args.rounds)


if __name__ == "__main__":
    main()
