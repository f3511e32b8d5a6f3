"""Calibration quality: does the evaluator earn its keep?

    PYTHONPATH=src python3 -m repro_torch.launch.calibration_quality \
        [--device cuda] [--quick] [--json PATH]

The port of the reference's ``benchmarks/calibration_quality.py``, timed
by the port's evaluator (on a CUDA device: the hand-written kernels under
CUDA events).  It measures a grid of TSMM problems' candidate short lists
(interleaved round-robin timing, ``measure_plans_interleaved``), fits the
roofline coefficients from those records (``core/evaluator.py::fit_hw``)
and reports the Spearman rank correlation between predicted and measured
times before and after calibration:

* per problem (the mean over the gate problems): the ordering the
  autotuner acts on when it prunes its short list — the inline
  acceptance check is that the calibrated model ranks strictly better
  than the data-sheet model there;
* pooled over every (problem, plan) record.

The gate problems are the reference's tall shapes plus GLM-4-9B's K/V
projection at its two prefill token counts (bf16); the context problems
are the reference's skinny decode shapes plus qwen1.5-4b's MLP
projection at decode batch 4.  It also drives the runtime miss path: a
registry-miss ``serve()`` on a cold registry returns off the calibrated
model's plan while the background tuner times and commits the measured
winner on its own stream.  Writes the rows as JSON to
``build/bench/calibration_quality.json`` (or ``--json``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_JSON = ROOT / "build" / "bench" / "calibration_quality.json"

GATE_SPECS = [
    (16384, 1024, 128, "float32"),
    (8192, 1024, 64, "float32"),
    (32768, 512, 128, "float32"),
    (16384, 1024, 128, "bfloat16"),
    (2048, 4096, 256, "bfloat16"),
    (4096, 4096, 256, "bfloat16"),
]
CONTEXT_SPECS = [
    (16, 4096, 2048, "float32"),
    (16, 4096, 2048, "bfloat16"),
    (32, 8192, 1024, "float32"),
    (4, 2560, 6912, "bfloat16"),
]
QUICK_GATE = GATE_SPECS[:2]
QUICK_CONTEXT = CONTEXT_SPECS[:1]


def measure_grid(specs, top_k: int, iters: int, reg, hw, device) -> list:
    """[(problem, records)]: each problem's ``top_k`` model-ranked
    candidates (distinct launches under the launch gate, as the
    tournament sees them), timed round-robin."""
    from repro_torch.core.autotuner import candidate_blocks, dedupe_short_list
    from repro_torch.core.evaluator import measure_plans_interleaved
    from repro_torch.core.plan import Problem

    by_problem = []
    for (m, k, n, dtype) in specs:
        prob = Problem(m, k, n, dtype)
        cands = dedupe_short_list(candidate_blocks(prob, hw), hw)[:top_k]
        recs = measure_plans_interleaved(cands, device, rounds=iters,
                                         warmup=2, reg=reg,
                                         source="benchmark")
        by_problem.append((prob, recs))
    return by_problem


def rank_quality(by_problem, hw) -> tuple:
    """(pooled Spearman, mean per-problem Spearman) of predicted vs
    measured seconds under ``hw``."""
    from repro_torch.core.evaluator import spearman
    from repro_torch.core.smem_model import predict

    pooled_pred, pooled_meas, per_problem = [], [], []
    for _prob, recs in by_problem:
        pred = [predict(r.plan, hw).score for r in recs]
        meas = [r.seconds for r in recs]
        pooled_pred += pred
        pooled_meas += meas
        if len(recs) >= 3:
            per_problem.append(spearman(pred, meas))
    pooled = spearman(pooled_pred, pooled_meas)
    mean_pp = float(np.mean(per_problem)) if per_problem else 0.0
    return pooled, mean_pp


def miss_path_demo(cache_dir: Path, device):
    """A registry-miss ``serve()`` returns without waiting for the
    measurement; the background tuner commits the measured plans."""
    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import autotuner, registry
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine

    env = {"REPRO_TORCH_PLAN_CACHE": "plans.json",
           "REPRO_TORCH_MEASURE_CACHE": "measurements.json",
           "REPRO_TORCH_MISS_LOG": "misses.json"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(cache_dir / v) for k, v in env.items()})
    registry.clear_memory()
    cfg = get_reduced_config("qwen1_5_4b").reduced(
        d_model=512, d_ff=1024, num_layers=2, vocab_size=1024,
        num_heads=8, num_kv_heads=8, head_dim=64)
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    prev = autotuner.set_default_hw(None)
    try:
        eng = Engine(model, params, axes, max_len=64, max_batch=4,
                     background_tune=True, device=device,
                     tuner_opts=dict(iters=2, warmup=1, top_k=3))
        prompts = [{"tokens": torch.arange(8, dtype=torch.int32)
                    % cfg.vocab_size} for _ in range(2)]
        t0 = time.perf_counter()
        outs = eng.serve(prompts, steps=2)
        serve_s = time.perf_counter() - t0
        busy_at_return = eng.tuner.busy()
        eng.tuner.join(timeout=600)
        committed = len(eng.tuner.committed)
    finally:
        autotuner.set_default_hw(prev)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        registry.clear_memory()
    assert len(outs) == 2
    return serve_s, busy_at_return, committed


def run(top_k: int = 6, iters: int = 5, quick: bool = False, device="cuda",
        json_path=DEFAULT_JSON) -> dict:
    import torch

    from repro_torch.core.evaluator import fit_hw
    from repro_torch.core.hw import for_device
    from repro_torch.core.registry import Registry

    device = torch.device(device)
    hw = for_device(device)
    gate_specs = QUICK_GATE if quick else GATE_SPECS
    ctx_specs = QUICK_CONTEXT if quick else CONTEXT_SPECS
    if quick:
        top_k, iters = min(top_k, 5), min(iters, 3)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_cal_",
                                     dir=ROOT / "build") as td:
        reg = Registry(plan_path=Path(td) / "plans.json",
                       measure_path=Path(td) / "measurements.json")
        gate = measure_grid(gate_specs, top_k, iters, reg, hw, device)
        ctx = measure_grid(ctx_specs, top_k, iters, reg, hw, device)
        records = [r for _p, recs in gate + ctx for r in recs]
        hw_cal = fit_hw(records, hw)
        rho0, pp0 = rank_quality(gate + ctx, hw)
        rho1, pp1 = rank_quality(gate + ctx, hw_cal)
        _, gate0 = rank_quality(gate, hw)
        _, gate1 = rank_quality(gate, hw_cal)
        # persist the measurement cache so the demo's Engine fits the
        # same records and serves off the calibrated model
        reg.flush()
        serve_s, busy, committed = miss_path_demo(Path(td), device)

    rows = {
        "records": len(records), "gate_problems": len(gate),
        "context_problems": len(ctx), "rounds": iters, "top_k": top_k,
        "spearman_rank_uncal": gate0, "spearman_rank_cal": gate1,
        "spearman_rank_delta": gate1 - gate0,
        "spearman_rank_all_problems": [pp0, pp1],
        "spearman_pooled": [rho0, rho1],
        "hbm_efficiency": hw_cal.hbm_efficiency,
        "mxu_efficiency": hw_cal.mxu_efficiency,
        "grid_overhead_s": hw_cal.grid_overhead_s,
        "calibrated": hw_cal.calibrated,
        "miss_serve_s": serve_s, "tuner_busy_at_return": busy,
        "tuner_committed": committed,
    }
    blob = {"bench": "calibration_quality", "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "rows": rows,
            "per_problem": [
                {"problem": p.key(),
                 "measured_s": [r.seconds for r in recs],
                 "model_s": [r.plan.score for r in recs],
                 "kernels": [r.plan.kernel.key() for r in recs]}
                for p, recs in gate + ctx]}
    if json_path:
        out = Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(blob, indent=1))
        print(f"wrote {out}")
    print(json.dumps(rows))
    assert gate1 > gate0, (
        f"calibration did not improve candidate-ranking correlation "
        f"({gate0:.3f} -> {gate1:.3f})")
    return blob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--top-k", type=int, default=6,
                    help="candidates measured per problem")
    ap.add_argument("--iters", type=int, default=5,
                    help="interleaved timing rounds per candidate")
    ap.add_argument("--quick", action="store_true",
                    help="2 gate + 1 context problems, 5 candidates, 3 "
                         "rounds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="where the rows go (empty: nowhere)")
    args = ap.parse_args(argv)
    from repro_torch.serve.engine import resolve_device
    run(top_k=args.top_k, iters=args.iters, quick=args.quick,
        device=resolve_device(args.device), json_path=args.json or None)


if __name__ == "__main__":
    main()
