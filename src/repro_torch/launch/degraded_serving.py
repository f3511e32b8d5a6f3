"""Degraded serving: the cost of serving one rung down the kernel ladder.

    PYTHONPATH=src python -m repro_torch.launch.degraded_serving
    PYTHONPATH=src python -m repro_torch.launch.degraded_serving \
        --reduced --device cpu --requests 4 --max-batch 2

The port of the reference's ``benchmarks/degraded_serving.py`` (which
stays as it is).  The same ragged queue is served twice, each time on a
fresh engine with its grid captured at load: once healthy, once with the
ladder's top rung knocked out (the ``kernels.lower.skinny`` and
``kernels.lower.tall`` failpoints raise, so every planned ``tsmm_dot``
runs its plain PyTorch version on the same device, DESIGN.md §16).  On
the card the cells capture that rung, so the degraded run replays it.
The reference builds its trace with ``benchmarks/serving_slo.py``, which
the port does not have; the queue here is the workload of
``launch/continuous_batching.py`` (prompt lengths 3-120, budgets 2-12)
through ``Engine.serve_queue``.

Rows: each run's generated tokens per second (warm: the acquire time of
cold cells taken out, real wall clock around work that ends in a host
read), its demotions, and healthy / degraded.  Each run must report what
it is: the healthy run 0 demotions, the degraded run at least one
``kernel.variant``.  On the CPU both rungs are the same plain function,
so the token streams must be identical (the tool raises otherwise); on
the card the plain version sums in another order, so near-ties may pick
other tokens: the identical streams are counted and printed.  On the CPU
no time is a device time.  ``--json`` writes the rows to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.launch.continuous_batching import ragged_max_len, workload
from repro_torch.models.registry import build_model
from repro_torch.resilience import failpoints
from repro_torch.serve.engine import Engine, resolve_device

# both planned orientations refused -> rung 2 (the plain versions) serves
LADDER_FAULTS = "kernels.lower.skinny=raise;kernels.lower.tall=raise"


def serve_once(cfg, reqs, device, max_batch: int) -> tuple:
    """One fresh engine (grid captured at load) serving ``reqs``; returns
    (token streams, scheduler stats, health report)."""
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, axes, max_len=ragged_max_len(reqs),
                 max_batch=max_batch,
                 max_prompt=max(len(r.tokens) for r in reqs), device=device)
    del params
    eng.precompile()
    results, stats = eng.serve_queue(reqs)
    return [r.tokens.tolist() for r in results], stats, eng.health_report()


def run(cfg, *, requests: int = 16, max_batch: int = 4,
        device="cuda") -> list:
    device = resolve_device(device)
    reqs = workload(cfg, requests)
    failpoints.reset()
    healthy_toks, healthy, h_health = serve_once(cfg, reqs, device,
                                                 max_batch)
    if not h_health["healthy"]:
        raise SystemExit(f"healthy run degraded: {h_health['degradations']}")
    failpoints.configure(LADDER_FAULTS)
    try:
        degraded_toks, degraded, d_health = serve_once(cfg, reqs, device,
                                                       max_batch)
    finally:
        failpoints.reset()
    by_seam = d_health["degradations"]["by_seam"]
    if not by_seam.get("kernel.variant"):
        raise SystemExit(f"the degraded run was not degraded: {by_seam}")
    same = sum(a == b for a, b in zip(healthy_toks, degraded_toks))
    if device.type == "cpu" and same != len(reqs):
        raise SystemExit("rung 2 changed tokens on the CPU, where both rungs "
                         "are the same plain function")
    rows = []
    for name, stats, health in (("healthy", healthy, h_health),
                                ("rung2_torch", degraded, d_health)):
        rows.append({"name": f"{name}_tokens_per_s",
                     "value": stats.tokens_per_s,
                     "note": f"{stats.generated_tokens} tokens, wall "
                             f"{stats.wall_s:.6f} s, compile "
                             f"{stats.compile_s:.6f} s, demotions "
                             f"{health['degradations']['by_seam']}"})
    rows.append({"name": "healthy_vs_rung2",
                 "value": healthy.tokens_per_s
                 / max(degraded.tokens_per_s, 1e-9),
                 "note": f"streams with identical tokens: {same}/"
                         f"{len(reqs)}"})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference benchmark's reduced config (2 "
                         "layers, d_model 512, vocab 1024)")
    ap.add_argument("--layers", type=int, default=8,
                    help="depth of the published config (full width)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="", help="write the rows here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.reduced:
        cfg = get_reduced_config(args.arch).reduced(
            d_model=512, d_ff=1024, num_layers=2, vocab_size=1024,
            num_heads=8, num_kv_heads=8, head_dim=64)
    else:
        cfg = dataclasses.replace(get_config(args.arch),
                                  num_layers=args.layers)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
            if device.type == "cuda" else "cpu")
    print(card)
    rows = run(cfg, requests=args.requests, max_batch=args.max_batch,
               device=device)
    for r in rows:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "layers": cfg.num_layers,
                       "dtype": cfg.dtype, "device": card, "rows": rows},
                      f, indent=1)
    return rows


if __name__ == "__main__":
    main()
