"""Cold start of the port's engine: cells captured on first traffic
against the grid captured at load.

    PYTHONPATH=src python -m repro_torch.launch.cold_start \
        --arch qwen1_5_4b --max-batch 2 --max-prompt 16
    PYTHONPATH=src python -m repro_torch.launch.cold_start --reduced \
        --device cpu

The port of the reference's ``benchmarks/cold_start.py`` (which stays as
it is).  Two fresh engines of the same model (seeded random weights)
serve the same first traffic — one aligned group and one ragged pair:

* **capture at first traffic** — no precompile: every cell the traffic
  needs is captured (warm-up + capture) inside its request's timed
  window;
* **precompile at load** — :meth:`Engine.precompile` captures the whole
  grid first (timed apart); the traffic then captures nothing (checked).

Rows: engine start seconds, first-traffic wall seconds of each engine,
the precompile seconds and cell count, and one row per cell with its
capture seconds, launches per call and graph-pool bytes, from
``ProgramStore.report()``.  There is no "warm restart from disk" row,
unlike the reference's: a CUDA graph cannot outlive its process, so a
restarted engine captures its grid again (``serve/programs.py``).  Real
wall clock by design (the object under test is capture time); on the
CPU the cells are eager and no time is a device time.  ``--json`` writes
the rows to a file.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine, resolve_device


def build(cfg, device, *, max_batch: int, max_prompt: int, max_len: int):
    """A fresh engine; returns (engine, start seconds)."""
    model = build_model(cfg)
    t0 = time.perf_counter()
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, axes, max_len=max_len, max_batch=max_batch,
                 max_prompt=max_prompt, device=device)
    sync(device)
    return eng, time.perf_counter() - t0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_traffic(cfg, eng) -> float:
    """One aligned group (max batch x the shortest length bucket, 3
    steps) and one ragged pair (2 steps); returns the wall seconds."""
    g = torch.Generator().manual_seed(0)
    lens = eng.grid.length
    t0 = time.perf_counter()
    eng.generate({"tokens": torch.randint(
        0, cfg.vocab_size, (eng.max_batch, lens[0]), generator=g,
        dtype=torch.int32)}, steps=3)
    eng.serve([{"tokens": torch.randint(0, cfg.vocab_size, (n,), generator=g,
                                        dtype=torch.int32)}
               for n in (max(1, lens[0] - 3), max(1, lens[-1] - 5))], steps=2)
    sync(eng.device)
    return time.perf_counter() - t0


def run(cfg, device, *, max_batch: int, max_prompt: int,
        max_len: int) -> list:
    rows = []
    eng, start_s = build(cfg, device, max_batch=max_batch,
                         max_prompt=max_prompt, max_len=max_len)
    rows.append({"row": "engine_start_s", "value": start_s})
    wall = first_traffic(cfg, eng)
    st = eng.programs.stats()
    rows.append({"row": "capture_at_first_traffic_s", "value": wall,
                 "cells": st["programs"], "captured": st["captured"],
                 "eager": st["eager"], "capture_s": st["capture_s"],
                 "pool_bytes": st["pool_bytes"]})
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()

    eng, start_s = build(cfg, device, max_batch=max_batch,
                         max_prompt=max_prompt, max_len=max_len)
    t0 = time.perf_counter()
    grid = eng.precompile()
    sync(device)
    pre_s = time.perf_counter() - t0
    loaded = eng.programs.stats()
    rows.append({"row": "precompile_at_load_s", "value": pre_s,
                 "cells": len(grid), "capture_s": loaded["capture_s"],
                 "pool_bytes": loaded["pool_bytes"], "start_s": start_s})
    wall = first_traffic(cfg, eng)
    st = eng.programs.stats()
    cold = (st["captured"] + st["eager"]) - (loaded["captured"]
                                             + loaded["eager"])
    if cold:
        raise AssertionError(f"cold_start: traffic acquired {cold} cells "
                             f"after the grid was precompiled")
    rows.append({"row": "first_traffic_after_precompile_s", "value": wall,
                 "cold_cells": cold, "reused": st["reused"]})
    rows.append({"row": "warm_restart_from_disk", "value": None,
                 "why": "a CUDA graph cannot outlive its process: a "
                        "restarted engine captures its grid at load"})
    for p in sorted(eng.programs.report(), key=lambda r: r["key"]):
        rows.append({"row": "cell", **p})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="", help="write the rows here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if device.type == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    rows = run(cfg, device, max_batch=args.max_batch,
               max_prompt=args.max_prompt, max_len=args.max_len)
    for r in rows:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "layers": cfg.num_layers,
                       "device": str(device), "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
