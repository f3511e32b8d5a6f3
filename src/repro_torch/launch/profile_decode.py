"""Profile the port's decode step, or one prefill, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode --layers 4
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch glm4_9b --layers 40 --batch 1 --prompt-len 2048 --prefill

Builds ``--arch`` at full width (depth cut to ``--layers``), bf16, seeded
random weights, packs it through ``Engine``, prefills one group and then
times ``--steps`` decode steps (or, with ``--prefill``, one prefill of
the group) twice: by the host clock (one ``cuda.synchronize`` at the end,
no profiler), then under ``torch.profiler`` (CPU and CUDA activities).
Prints the card (``nvidia-smi`` name and power limit), the wall time per
step, the device time per step summed over CUDA kernels and split by
kernel family (skinny-A, tall-A, pack, flash attention, the rest), the
kernel launches per step (``cudaLaunchKernel`` and the cluster launches,
``cudaLaunchKernelExC``), and the ``key_averages`` tables.  A wall time
well above the device time means the host bounds the step.
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
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine


# kernel family -> substrings of the CUDA kernel names (csrc/*.cu)
FAMILIES = {"skinny": ("skinny",), "tall": ("tall_kernel", "tall_wgmma"),
            "pack": ("pack_kernel", "pack_tma_kernel", "pack_vec_kernel"),
            "flash": ("flash",)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--prefill", action="store_true",
                    help="profile one prefill instead of the decode steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0))
    max_len = args.prompt_len + 2 * args.steps + 8
    eng = Engine(model, params, axes, max_len=max_len, max_batch=args.batch,
                 max_prompt=args.prompt_len, device="cuda")
    del params
    batch = make_group(cfg, args.batch, args.prompt_len, "cuda")
    eng.generate(batch, args.steps)                     # warm-up
    with torch.inference_mode(), serving_ctx():
        cache = model.init_cache(args.batch, max_len, "cuda")
        logits, cache = model.prefill(eng.params, batch, cache)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        steps = 1 if args.prefill else args.steps

        def run():
            for _ in range(steps):
                if args.prefill:
                    model.prefill(eng.params, batch, cache)
                else:
                    model.decode_step(eng.params, cache, tok)
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    families = {f: 0.0 for f in FAMILIES}
    families["other"] = 0.0
    for e in kernels:
        fam = next((f for f, keys in FAMILIES.items()
                    if any(k in e.key for k in keys)), "other")
        families[fam] += e.self_device_time_total / 1e3 / steps
    print(json.dumps({
        "arch": args.arch, "layers": args.layers, "batch": args.batch,
        "prompt_len": args.prompt_len,
        "phase": "prefill" if args.prefill else "decode", "steps": steps,
        "wall_ms_per_step": 1e3 * wall,
        "device_ms_per_step": sum(e.self_device_time_total for e in kernels)
        / 1e3 / steps,
        "device_ms_per_step_by_family": families,
        "cuda_launches_per_step": launches / steps}))
    print(ka.table(sort_by="cpu_time_total", row_limit=25,
                   max_name_column_width=50))
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15,
                   max_name_column_width=50))


if __name__ == "__main__":
    main()
