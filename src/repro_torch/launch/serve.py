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
    for b in trace:
        res = eng.generate(make_group(cfg, b, args.prompt_len, device),
                           steps=args.steps)
        print(f"group b={b:4d} -> buckets={res.buckets} "
              f"prefill={res.prefill_s:.3f}s "
              f"per_token={res.per_token_s * 1e3:.2f}ms")
        print("  tokens[0]:", res.tokens[0].tolist())
    s = registry.stats()
    print(f"plan registry: {s['hits']} hits / {s['misses']} misses")
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


if __name__ == "__main__":
    main()
