"""Continuous batching against aligned groups, on one engine.

    PYTHONPATH=src python -m repro_torch.launch.continuous_batching
    PYTHONPATH=src python -m repro_torch.launch.continuous_batching \
        --reduced --device cpu --requests 4 --max-batch 2

The port of the reference's ``benchmarks/continuous_batching.py`` (which
stays as it is).  ONE ragged workload — requests with different prompt
lengths and different decode budgets — goes through two serving
disciplines on the SAME engine (same packed weights, same cells):

* **ragged queue** — ``Engine.serve_queue``: each prompt pads only to
  its own length bucket, finished streams free their slot mid-flight,
  queued requests join the running batch;
* **aligned groups** — every prompt padded to the global maximum prompt
  bucket, requests chunked into ``max_batch`` groups in arrival order,
  each group decoding until its LAST stream finishes.

Rows: the generated tokens per second of both (warm: the acquire time
of cold cells is taken out of both), their ratio, and the prompt padding
each prefills.  Real wall clock (``time.perf_counter`` around work that
ends in a host read or ``torch.cuda.synchronize``); on the CPU no time
is a device time.  By default the model is qwen1.5-4b at full width and
depth on the card; ``--reduced`` takes the reference benchmark's reduced
config.  ``--json`` writes the rows to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine, resolve_device
from repro_torch.serve.scheduler import Request

# prompt lengths / decode budgets cycled over the request queue: spread
# across the length buckets (the regime the aligned baseline pads worst)
# with high decode-budget variance (the regime group-drain wastes worst)
DEFAULT_LENS = (5, 60, 12, 88, 30, 9, 120, 3, 45, 17, 70, 26)
DEFAULT_STEPS = (12, 2, 8, 3, 12, 2, 10, 4, 2, 12, 3, 8)


def workload(cfg, n_requests: int, *, lens=DEFAULT_LENS, steps=DEFAULT_STEPS,
             seed: int = 0) -> list:
    """``n_requests`` requests cycling ``lens`` / ``steps``, random
    prompts from ``seed``."""
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, cfg.vocab_size,
                                        size=lens[i % len(lens)])
                    .astype(np.int32),
                    max_new_tokens=steps[i % len(steps)], rid=i)
            for i in range(n_requests)]


def ragged_max_len(reqs) -> int:
    """Global-clock capacity of a queue: the base bucket, a prompt below
    it, and one step per generated token."""
    return (2 * max(len(r.tokens) for r in reqs)
            + sum(r.max_new_tokens for r in reqs) + 8)


def run_ragged(eng, reqs) -> tuple:
    t0 = time.perf_counter()
    results, stats = eng.serve_queue(reqs)
    wall = time.perf_counter() - t0
    if not all(r.completed for r in results):
        raise AssertionError("continuous_batching: a queued stream did not "
                             "complete (raise max_len)")
    return sum(len(r.tokens) for r in results), wall, stats


def run_aligned(eng, reqs, bucket: int) -> tuple:
    """Global-max padding + group-drain decode.  Returns (useful tokens,
    warm wall seconds): each group's cold-cell time (``compile_s``) is
    taken out, as the scheduler's ``stats.compile_s`` is."""
    wall, toks = 0.0, 0
    for lo in range(0, len(reqs), eng.max_batch):
        group = reqs[lo:lo + eng.max_batch]
        padded = [{"tokens": F.pad(torch.as_tensor(r.tokens, dtype=torch.int32),
                                   (bucket - len(r.tokens), 0))}
                  for r in group]
        steps = max(r.max_new_tokens for r in group)   # drain the group
        t0 = time.perf_counter()
        outs = eng.serve(padded, steps=steps)
        wall += time.perf_counter() - t0 - outs[0].compile_s
        toks += sum(r.max_new_tokens for r in group)   # useful tokens only
    return toks, wall


def compare(eng, reqs, *, repeats: int = 2) -> list:
    """Both disciplines ``repeats`` times on ``eng`` (the first repeat
    warms any cell the grid lacks); returns the rows of the last."""
    bucket = eng.grid.length_bucket(max(len(r.tokens) for r in reqs))
    for _ in range(repeats):
        r_toks, r_wall, stats = run_ragged(eng, reqs)
        a_toks, a_wall = run_aligned(eng, reqs, bucket)
    r_tps = r_toks / max(r_wall - stats.compile_s, 1e-9)
    a_tps = a_toks / max(a_wall, 1e-9)
    lens = [len(r.tokens) for r in reqs]
    return [
        {"name": "ragged_tokens_per_s", "value": r_tps,
         "note": f"{r_toks} tokens in {r_wall:.6f} s, occupancy "
                 f"{stats.occupancy:.3f}, mean_queue_steps "
                 f"{stats.mean_queue_steps:.2f}, steps {stats.steps}"},
        {"name": "ragged_compile_s", "value": stats.compile_s,
         "note": "cold-cell time on the last repeat, taken out of the rate"},
        {"name": "aligned_tokens_per_s", "value": a_tps,
         "note": f"{a_toks} tokens in {a_wall:.6f} s, every prompt padded "
                 f"to {bucket}"},
        {"name": "ragged_vs_aligned", "value": r_tps / a_tps, "note": ""},
        {"name": "prompt_pad_tokens_aligned",
         "value": sum(bucket - n for n in lens), "note": f"prompts {lens}"},
        {"name": "prompt_pad_tokens_ragged", "value": stats.prompt_pad_tokens,
         "note": f"length buckets {eng.grid.length}"},
    ]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference benchmark's reduced config (2 "
                         "layers, d_model 512, vocab 1024)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="", help="write the rows here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.reduced:
        cfg = get_reduced_config(args.arch).reduced(
            d_model=512, d_ff=1024, num_layers=2, vocab_size=1024,
            num_heads=8, num_kv_heads=8, head_dim=64)
    else:
        cfg = get_config(args.arch)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
            if device.type == "cuda" else "cpu")
    print(card)
    model = build_model(cfg)
    reqs = workload(cfg, args.requests)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, axes, max_len=ragged_max_len(reqs),
                 max_batch=args.max_batch,
                 max_prompt=max(len(r.tokens) for r in reqs), device=device)
    del params
    eng.precompile()
    rows = compare(eng, reqs, repeats=args.repeats)
    for r in rows:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "layers": cfg.num_layers,
                       "device": card, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
