"""Serving launcher: batch-adaptive pre-packed decode on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_4b \
        --trace 1,3,4 --prompt-len 256 --steps 8

Each comma-separated ``--trace`` entry is one request group admitted
against the bucket set: ``b`` (b requests at ``--prompt-len``) or
``b:p`` (b requests with p-token prompts).  Mixed prompt lengths, or
``--queue``, route the whole trace through the continuous-batching
scheduler (``Engine.serve_queue``), which prints one row per request and
its telemetry (padding waste, queue wait, slot occupancy):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_4b \
        --reduced --device cpu --trace 2:9,3:30,1:5 --max-batch 4 --steps 8

``--async`` turns the same trace into a seeded Poisson arrival process at
``--rate`` requests/s served by the open-loop ``AsyncEngine`` (priority
tiers, tenant fairness, ``--queue-limit`` backpressure,
``--prefill-budget`` chunked admission) on the deterministic virtual
clock, and prints the TTFT percentiles and per-tier telemetry.

Every config of the reference serves here: the dense, MoE, SSM and
hybrid families, the sliding-window h2o-danube-1.8b (its prompts may be
longer than the window: the cache rolls), the LLaVA-NeXT backbone (each
group carries image embeddings before its tokens) and whisper-base (each
group carries encoder frames), the last two with bf16 zeros as the
reference's launcher builds them:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_base \
        --reduced --device cpu --trace 1,3 --steps 2

``--device`` defaults to ``cuda``; pass
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
so the load captures the grid and traffic must capture nothing): the
grid holds the scheduler's ``prefill_row`` cells too, so a queue that
captures one fails it as well.

``--mesh model=2`` (or ``data=2,model=2``) serves tensor-parallel, one
rank a process, launched by torchrun; each rank takes the card
``cuda:{local_rank % device_count}`` (gloo where ranks share a card,
``launch/mesh.py``), every rank draws the same seeded params and keeps
its pieces of each leaf as it is drawn (``models/param.py::init_pieces``), and rank 0 prints, the collectives of one decode call
among its lines:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen1_5_4b \
        --reduced --device cpu --mesh model=2 --trace 1,3 --steps 2

The MoE family serves the same way (``--arch olmoe_1b_7b`` or
``deepseek_v2_236b``): its experts split over ``model`` by whole experts
or by their columns, MLA's latent cache along its sequence.  So does
every other family:

* ``--arch mamba2_780m``: each rank its Mamba2 heads, conv channels and
  state, ``w_in`` cut by segments (its heads' ``z`` / ``x`` / ``dt``, the
  whole ``B`` / ``C``), the gated norm's sum of squares all-reduced;
* ``--arch zamba2_2_7b``: the Mamba stack so, the shared block by its
  heads and its MLP's columns;
* ``--arch llava_next_mistral_7b``: the LLaVA-NeXT backbone by its heads,
  each group's image embeddings ahead of its tokens on every rank;
* ``--arch whisper_base``: the encoder, the decoder and the cross cache
  by their heads, the odd vocabulary whole on every rank.

``--find-db`` attaches a fleet find-db artifact (``REPRO_TORCH_FIND_DB``):
the registry folds its plans in under the local ones, so a fresh host
serves with 0 misses.  ``--health`` prints the engine's health report
after serving and exits 1 when any ladder demotion fired (a planned
kernel served by its plain version or by ``torch.matmul``, a deferred
flush, an ignored find-db):

    REPRO_TORCH_FAILPOINTS='kernels.lower.skinny=raise' PYTHONPATH=src \
        python -m repro_torch.launch.serve --arch qwen1_5_4b --reduced \
        --device cpu --trace 1 --steps 2 --health      # exits 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
from collections import Counter

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import registry
from repro_torch.models.param import init_pieces
from repro_torch.models.registry import (active_param_count, build_model,
                                         param_count)
from repro_torch.serve.engine import Engine, resolve_device
from repro_torch.serve.scheduler import Request


def make_group(cfg, b: int, prompt_len: int, device,
               seed=None) -> dict:
    """A group of ``b`` prompts of ``prompt_len`` tokens, with the
    model's other inputs as the reference's launcher builds them: a VLM's
    ``embeds`` (b, num_image_tokens, d_model) and an encoder-decoder's
    ``enc_frames`` (b, encoder_seq, d_model), bf16 zeros, or with
    ``seed`` normal draws of a generator seeded with it."""
    tokens = (torch.arange(b * prompt_len, device=device)
              .reshape(b, prompt_len) % cfg.vocab_size).to(torch.int32)
    out = {"tokens": tokens}
    gen = (torch.Generator(device=device).manual_seed(seed)
           if seed is not None else None)
    for key, n, on in (("embeds", cfg.num_image_tokens, cfg.embeds_input),
                       ("enc_frames", cfg.encoder_seq,
                        cfg.is_encoder_decoder)):
        if not on:
            continue
        shape = (b, n, cfg.d_model)
        x = (torch.randn(shape, generator=gen, device=device)
             if gen is not None else torch.zeros(shape, device=device))
        out[key] = x.to(torch.bfloat16)
    return out


def parse_trace(spec: str, default_len: int) -> list:
    """Each entry: ``b`` (a group of b at the default prompt length) or
    ``b:p`` (a group of b requests with prompt length p)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            b, p = part.split(":")
            out.append((int(b), int(p)))
        else:
            out.append((int(part), default_len))
    return out


def print_telemetry(stats) -> None:
    print("-- scheduler telemetry --")
    for k, v in stats.rows():
        print(f"  {k:20s} {v}")


def parse_overrides(text: str) -> dict:
    out = {}
    for part in text.split(","):
        k, _, v = part.strip().partition("=")
        if k:
            out[k] = int(v)
    return out


def config_for(arch: str, *, reduced: bool, override: str = ""):
    """``arch``'s config: the reduced one with the overrides applied
    through ``reduced()``, or the published one with the overrides
    replacing its fields (``num_layers=3``: full width, cut depth)."""
    if reduced:
        cfg = get_reduced_config(arch)
        return cfg.reduced(**parse_overrides(override)) if override else cfg
    return dataclasses.replace(get_config(arch), **parse_overrides(override))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma-separated int config overrides: with "
                         "--reduced applied with reduced() (e.g. "
                         "d_model=512), else to the published config (e.g. "
                         "num_layers=3: full width, cut depth)")
    ap.add_argument("--trace", default="4",
                    help="comma-separated request groups: sizes (1,3,4) or "
                         "b:prompt_len pairs (2:9,3:30); mixed lengths run "
                         "the continuous-batching scheduler")
    ap.add_argument("--queue", action="store_true",
                    help="run the continuous-batching scheduler even for a "
                         "uniform-length trace")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="open-loop front end: requests arrive as a Poisson "
                         "process at --rate on the virtual clock")
    ap.add_argument("--rate", type=float, default=25.0,
                    help="offered load for --async, requests/s")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="--async admission-control bound (backpressure)")
    ap.add_argument("--prefill-budget", type=int, default=32,
                    help="--async prompt tokens admissible per decode step "
                         "(0 = unbounded)")
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
    ap.add_argument("--find-db", default="",
                    help="attach a fleet find-db artifact: sets "
                         "REPRO_TORCH_FIND_DB so the registry overlays the "
                         "exported plans at load")
    ap.add_argument("--health", action="store_true",
                    help="print the engine's health report after serving "
                         "and exit 1 if any ladder demotion fired")
    ap.add_argument("--mesh", default="",
                    help="serve tensor-parallel on this mesh, e.g. model=2 "
                         "or data=2,model=2 (launch one process a rank "
                         "with torchrun)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.core.install import parse_mesh
        from repro_torch.launch.mesh import make_mesh
        desc = parse_mesh(args.mesh)
        mesh = make_mesh(tuple(desc.shape.values()), desc.axis_names,
                         device=args.device)
    with (open(os.devnull, "w") if mesh is not None and mesh.rank
          else contextlib.nullcontext(sys.stdout)) as out, \
            contextlib.redirect_stdout(out):
        try:
            _serve(args, mesh)
        finally:
            if mesh is not None:
                mesh.close()


def _serve(args, mesh) -> None:
    logging.basicConfig(level=logging.INFO if mesh is None or not mesh.rank
                        else logging.WARNING)
    if args.find_db:
        from repro_torch.tuning.find_db import attach
        attach(args.find_db)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = config_for(args.arch, reduced=args.reduced, override=args.override)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    # on a mesh each leaf is cut to the rank's piece as it is drawn
    with (init_pieces(mesh, cfg) if mesh is not None
          else contextlib.nullcontext()):
        params, axes = model.init(gen)

    trace = parse_trace(args.trace, args.prompt_len)
    max_batch = args.max_batch or max(b for b, _ in trace)
    max_prompt = max(p for _, p in trace)
    ragged = args.queue or len({p for _, p in trace}) > 1
    if args.async_mode or ragged:
        # global-clock capacity: the base length bucket, every prompt
        # bucket below it, and every decode step
        total_steps = sum(b * args.steps for b, _ in trace)
        max_len = args.max_len or (2 * max_prompt + total_steps + 8)
    else:
        image = cfg.num_image_tokens if cfg.embeds_input else 0
        max_len = args.max_len or (image + max_prompt + args.steps + 8)
    eng = Engine(model, params, axes, max_len=max_len, max_batch=max_batch,
                 max_prompt=max_prompt, prepack=not args.no_prepack,
                 background_tune=args.background_tune, device=device,
                 mesh=mesh)
    del params
    if mesh is not None:
        print(f"mesh {dict(mesh.shape)} backend={mesh.backend} "
              f"graphed={eng.programs.stats()['graphed']}")
    print(f"buckets={eng.buckets} length_buckets={eng.grid.length} "
          f"packed_leaves={len(eng.pack_report)} "
          f"param_count={param_count(model)} "
          f"active_param_count={active_param_count(model)} "
          f"layers={cfg.num_layers} device={device}")
    if args.precompile:
        rows = eng.precompile()
        st = eng.programs.stats()
        print(f"precompiled {len(rows)} cells ({st['captured']} captured, "
              f"{st['eager']} eager) in {st['capture_s']:.2f}s, "
              f"pool_bytes={st['pool_bytes']}")
    loaded = eng.programs.stats()
    if args.async_mode:
        serve_async(eng, cfg, trace, args)
    elif ragged:
        rng = np.random.default_rng(0)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=p),
                        max_new_tokens=args.steps, rid=f"g{i}r{j}")
                for i, (b, p) in enumerate(trace) for j in range(b)]
        results, stats = eng.serve_queue(reqs)
        for r in results:
            print(f"req {str(r.rid):8s} prompt={r.prompt_len:4d} "
                  f"lb={r.length_bucket:4d} admitted@{r.admitted_at} "
                  f"done@{r.finished_at} waited={r.queue_steps} "
                  f"tokens={r.tokens[:8].tolist()}"
                  f"{'...' if len(r.tokens) > 8 else ''}")
        print_telemetry(stats)
    else:
        for b, p in trace:
            res = eng.generate(make_group(cfg, b, p, device),
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
    if mesh is not None:
        print("collectives of one decode call: "
              + json.dumps(eng.collectives("decode")))
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
    if args.health:
        hr = eng.health_report()
        print("-- health report --")
        print(json.dumps(hr, indent=2, default=str))
        if not hr["healthy"]:
            raise SystemExit(f"--health: {hr['degradations']['total']} "
                             f"degradation(s) fired: serving ran off the "
                             f"ladder, not the plan")


def serve_async(eng, cfg, trace, args) -> None:
    """The trace as a seeded Poisson arrival process through the
    open-loop front end on the virtual clock: one row per stream, the
    TTFT percentiles and the scheduler telemetry."""
    from repro_torch.serve.clock import VirtualClock
    from repro_torch.serve.frontend import AsyncEngine

    rng = np.random.default_rng(0)
    reqs, arrival = [], 0.0
    for i, (b, p) in enumerate(trace):
        for j in range(b):
            arrival += float(rng.exponential(1.0 / args.rate))
            reqs.append(Request(
                tokens=rng.integers(0, cfg.vocab_size, size=p),
                max_new_tokens=args.steps, rid=f"g{i}r{j}",
                arrival_time=arrival, priority=i % 3,
                tenant=f"tenant{j % 2}"))
    afe = AsyncEngine(eng, queue_limit=args.queue_limit,
                      prefill_budget=args.prefill_budget or None,
                      clock=VirtualClock())
    streams, stats = afe.simulate(reqs)
    for s in streams:
        state = ("REJECTED" if s.rejected
                 else "ok" if s.completed else "truncated")
        ttft = f"{s.ttft * 1e3:7.2f}ms" if s.ttft is not None else "      -"
        print(f"req {str(s.rid):8s} tier={s.priority} "
              f"tenant={s.tenant:8s} arrive={s.arrival_time:7.3f}s "
              f"ttft={ttft} tokens={len(s.tokens):3d} {state}")
    ttfts = np.asarray([s.ttft for s in streams if s.ttft is not None])
    if ttfts.size:
        print(f"-- offered load {args.rate:g} req/s (virtual clock) --")
        print(f"  ttft p50/p95/p99: {np.percentile(ttfts, 50) * 1e3:.2f} / "
              f"{np.percentile(ttfts, 95) * 1e3:.2f} / "
              f"{np.percentile(ttfts, 99) * 1e3:.2f} ms")
    print_telemetry(stats)


if __name__ == "__main__":
    main()
