"""Serving launcher: batch-adaptive pre-packed decode on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_4b \
        --trace 1,3,4 --prompt-len 256 --steps 8

Each comma-separated ``--trace`` entry is one request group admitted
against the bucket set.  ``--device`` defaults to ``cuda``; pass
``--device cpu`` (with ``--reduced``) to run the plain PyTorch versions
on the CPU.  Params are random, from seed 0.  After an install sweep
(``repro_torch.core.install``) on the same shapes the registry line
reads 0 misses; ``--background-tune`` times the problems that did miss
on a thread of their own and commits the measured plans.

On a CUDA device every (kind, bucket, prompt length) cell is a captured
CUDA graph (``serve/programs.py``).  ``--precompile`` captures the whole
grid at load; ``--require-warm`` then exits 1 if serving missed the
registry or captured any cell: the reference's "restart is lookup-only"
gate, under the port's restart contract (a graph lives in its process,
so the load captures the grid and traffic must capture nothing).
"""

from __future__ import annotations

import argparse
import logging
from collections import Counter

import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import registry
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine, resolve_device


def make_group(cfg, b: int, prompt_len: int, device) -> dict:
    tokens = (torch.arange(b * prompt_len, device=device)
              .reshape(b, prompt_len) % cfg.vocab_size).to(torch.int32)
    return {"tokens": tokens}


def parse_overrides(text: str) -> dict:
    out = {}
    for part in text.split(","):
        k, _, v = part.strip().partition("=")
        if k:
            out[k] = int(v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma-separated int config overrides (e.g. "
                         "d_model=512,num_layers=1) applied with reduced()")
    ap.add_argument("--trace", default="4",
                    help="comma-separated request-group sizes")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="bucket ceiling (default: largest group)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--no-prepack", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--background-tune", action="store_true",
                    help="time registry-missed problems off the serving "
                         "thread and commit the measured plans")
    ap.add_argument("--precompile", action="store_true",
                    help="capture every serving cell at load")
    ap.add_argument("--require-warm", action="store_true",
                    help="exit 1 if serving logged any registry miss or "
                         "captured any cell")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.override:
        cfg = cfg.reduced(**parse_overrides(args.override))
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params, axes = model.init(gen)

    trace = [int(b) for b in args.trace.split(",") if b.strip()]
    max_batch = args.max_batch or max(trace)
    max_len = args.max_len or (args.prompt_len + args.steps + 8)
    eng = Engine(model, params, axes, max_len=max_len, max_batch=max_batch,
                 max_prompt=args.prompt_len, prepack=not args.no_prepack,
                 background_tune=args.background_tune, device=device)
    del params
    print(f"buckets={eng.buckets} length_buckets={eng.grid.length} "
          f"packed_leaves={len(eng.pack_report)} device={device}")
    if args.precompile:
        rows = eng.precompile()
        st = eng.programs.stats()
        print(f"precompiled {len(rows)} cells ({st['captured']} captured, "
              f"{st['eager']} eager) in {st['capture_s']:.2f}s, "
              f"pool_bytes={st['pool_bytes']}")
    loaded = eng.programs.stats()
    for b in trace:
        res = eng.generate(make_group(cfg, b, args.prompt_len, device),
                           steps=args.steps)
        print(f"group b={b:4d} -> buckets={res.buckets} "
              f"prefill={res.prefill_s:.3f}s "
              f"per_token={res.per_token_s * 1e3:.2f}ms "
              f"compile={res.compile_s:.3f}s")
        print("  tokens[0]:", res.tokens[0].tolist())
    s = registry.stats()
    print(f"plan registry: {s['hits']} hits / {s['misses']} misses")
    ps = eng.programs.stats()
    cold = (ps["captured"] + ps["eager"]) - (loaded["captured"]
                                             + loaded["eager"])
    print(f"program store: {ps['programs']} cells (captured="
          f"{ps['captured']} eager={ps['eager']} reused={ps['reused']}) "
          f"capture_s={ps['capture_s']:.2f} pool_bytes={ps['pool_bytes']}; "
          f"{cold} acquired cold by traffic")
    if eng.tuner is not None:
        eng.tuner.join()
        print(f"background tuner: {len(eng.tuner.committed)} measured plans "
              f"committed")
    vr = eng.variant_report()
    if vr:
        counts = Counter(vr.values())
        print("kernel variants in play: "
              + ", ".join(f"{k} x{v}" for k, v in sorted(counts.items())))
    if device.type == "cuda":
        from repro_torch.kernels import cuda
        print("kernel launches: " + ", ".join(
            f"{k}={v}" for k, v in sorted(cuda.launches.items())))
    if args.require_warm and (s["misses"] or cold):
        raise SystemExit(f"--require-warm: serving was not lookup-only "
                         f"({s['misses']} registry misses, {cold} cells "
                         f"acquired by traffic)")


if __name__ == "__main__":
    main()
