"""Profile the port's decode step, or one prefill, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode --layers 4
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch glm4_9b --layers 40 --batch 1 --prompt-len 2048 --prefill
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch glm4_9b --layers 40 --batch 1 --graphs

Builds ``--arch`` at full width (depth cut to ``--layers``), bf16, seeded
random weights, packs it through ``Engine``, prefills one group and then
times ``--steps`` decode steps (or, with ``--prefill``, one prefill of
the group) twice: by the host clock (one ``cuda.synchronize`` at the end,
no profiler), then under ``torch.profiler`` (CPU and CUDA activities).
The steps run as the engine's serving cells (``serve/programs.py``):
eagerly, or with ``--graphs`` as replays of their captured CUDA graphs.
Prints the card (``nvidia-smi`` name and power limit), the wall time per
step, the device time per step summed over CUDA kernels and split by
kernel family (skinny-A, tall-A, pack, flash attention, the rest; in an
eager run of an MoE model also ``moe_experts``, the routed and shared
experts' GEMMs, and ``moe_dispatch``, the routing, sort, dispatch and
combine, both split out of the rest by the profiler ranges of
``models/moe.py``; of an SSM or hybrid model ``ssm_conv``, the causal
conv, ``ssm_scan``, the chunked scan at prefill, and ``ssm_state``, the
state update at decode, from the ranges of ``models/mamba2.py``), the
host's kernel launch calls per step (``cudaLaunchKernel`` and the
cluster launches, ``cudaLaunchKernelExC``), its graph launches
(``cudaGraphLaunch``), the kernels the device ran per step, and the
``key_averages`` tables.  A wall time well above the device time means
the host bounds the step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.core.linear import serving_ctx
from repro_torch.launch.serve import make_group
from repro_torch.models.mamba2 import CONV_RANGE, SCAN_RANGE, STATE_RANGE
from repro_torch.models.moe import DISPATCH_RANGE, EXPERTS_RANGE
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine
from repro_torch.serve.programs import ProgramStore


# kernel family -> substrings of the CUDA kernel names (csrc/*.cu)
FAMILIES = {"skinny": ("skinny",), "tall": ("tall_kernel", "tall_wgmma"),
            "pack": ("pack_kernel", "pack_tma_kernel", "pack_vec_kernel"),
            "flash": ("flash",)}
# families read from the profiler ranges the model code opens
# (models/moe.py, models/mamba2.py): the kernels launched inside each,
# library GEMMs and elementwise kernels that no name tells apart from the
# rest
RANGES = (EXPERTS_RANGE, DISPATCH_RANGE, CONV_RANGE, SCAN_RANGE, STATE_RANGE)


def range_device_ms(prof, name: str) -> float:
    """Device ms of the kernels launched inside every ``name`` range of an
    eager run (the kernels of a graph replay belong to its launch, not to
    the ranges, so a graphed run reads 0)."""
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def profile_steps(eng, batch: dict, *, steps: int, graphs: bool,
                  prefill: bool = False) -> tuple:
    """Wall and device time per step of ``eng``'s decode cell (or its
    prefill cell) on ``batch``, through the engine's store (``graphs``)
    or an eager store of the same model.  The group is prefilled before
    each run, so the cache never passes the prompt plus ``steps``.
    Returns (summary dict, the profiler's ``key_averages``)."""
    store = (eng.programs if graphs
             else ProgramStore(eng.model, device=eng.device, capture=False))
    b, width = batch["tokens"].shape
    cell = store.static_batch(batch)
    for k, v in batch.items():          # tokens, and embeds / frames
        cell[k].copy_(v)
    cache = store.static_cache(b, eng.max_len)
    tok = store.static_tokens(b)
    with torch.inference_mode(), serving_ctx():
        pprog = store.program("prefill", (eng.params, cell, cache),
                              bucket=b, tokens=width)

        def start():
            logits, _ = pprog.fn(eng.params, cell, cache)
            tok.copy_(logits[:, -1].argmax(-1, keepdim=True))
            return logits

        start()
        dprog = store.program("decode", (eng.params, cache, tok), bucket=b,
                              tokens=1)
        n = 1 if prefill else steps

        def run():
            if prefill:
                start()
            else:
                for _ in range(n):
                    logits, _ = dprog.fn(eng.params, cache, tok)
                    tok.copy_(logits[:, -1].argmax(-1, keepdim=True))
            torch.cuda.synchronize()

        start()
        run()                                   # warm
        start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) / n
        start()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    ka = prof.key_averages()
    # the ranges' own device-side annotations are not kernels
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and e.key not in RANGES]
    calls = {k: sum(e.count for e in ka if e.key == k)
             for k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cudaGraphLaunch")}
    families = {f: 0.0 for f in FAMILIES}
    families["other"] = 0.0
    for e in kernels:
        fam = next((f for f, keys in FAMILIES.items()
                    if any(k in e.key for k in keys)), "other")
        families[fam] += e.self_device_time_total / 1e3 / n
    # the ranges hold library and elementwise kernels only, which the
    # names put under "other"; an eager run splits them out of it
    if not graphs:
        for r in RANGES:
            families[r] = range_device_ms(prof, r) / n
            families["other"] -= families[r]
    return {
        "step": "prefill" if prefill else "decode", "graphs": graphs,
        "batch": b, "prompt_len": width, "steps": n,
        "wall_ms_per_step": 1e3 * wall,
        "device_ms_per_step": sum(e.self_device_time_total for e in kernels)
        / 1e3 / n,
        "device_ms_per_step_by_family": families,
        "cuda_launches_per_step": (calls["cudaLaunchKernel"]
                                   + calls["cudaLaunchKernelExC"]) / n,
        "graph_launches_per_step": calls["cudaGraphLaunch"] / n,
        "kernels_per_step": sum(e.count for e in kernels) / n}, ka


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--prefill", action="store_true",
                    help="profile one prefill instead of the decode steps")
    ap.add_argument("--graphs", action="store_true",
                    help="replay the captured CUDA graphs of the cells")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0))
    max_len = args.prompt_len + args.steps + 8
    eng = Engine(model, params, axes, max_len=max_len, max_batch=args.batch,
                 max_prompt=args.prompt_len, device="cuda")
    del params
    batch = make_group(cfg, args.batch, args.prompt_len, "cuda")
    summary, ka = profile_steps(eng, batch, steps=args.steps,
                                graphs=args.graphs, prefill=args.prefill)
    print(json.dumps({"arch": args.arch, "layers": args.layers, **summary}))
    print(ka.table(sort_by="cpu_time_total", row_limit=25,
                   max_name_column_width=50))
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15,
                   max_name_column_width=50))


if __name__ == "__main__":
    main()
