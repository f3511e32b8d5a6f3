"""The share of a conventional call spent packing, against the skinny
width N: the paper's Fig. 5 on the port.

    PYTHONPATH=src python3 -m repro_torch.launch.packing_fraction \\
        [--device cuda] [--paper] [--iters 5] [--json PATH]

The port of the reference's ``benchmarks/packing_fraction.py``: a
conventional GEMM packs A (the large operand) on every call, so with a
small N the pack is not amortized.  The pack of A into 256 x 256 blocks
(``kernels/ops.py::pack_blocks``: ``csrc/pack_blocks.cu`` on the card,
materialized as a conventional library must) and the GEMM
(``torch.matmul``, TF32 off) are timed apart, with the evaluator's timing
(CUDA events after an L2 flush; the host clock on the CPU), and each N
prints ``pack_share = t_pack / (t_pack + t_comp)``.  The workload is
``configs/tsmm_paper.py``'s ``BENCH_WORKLOAD`` (``--paper``:
``PAPER_WORKLOAD``).  Writes the rows as JSON to
``build/bench/packing_fraction.json`` (or ``--json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.configs.tsmm_paper import (BENCH_WORKLOAD, PAPER_WORKLOAD,
                                            TSMMWorkload)
from repro_torch.launch.prepack_vs_conventional import (ROOT, best_s,
                                                        pack_fn, pack_share)

DEFAULT_JSON = ROOT / "build" / "bench" / "packing_fraction.json"


def run(workload: TSMMWorkload = BENCH_WORKLOAD, device="cuda", *,
        iters: int = 5, json_path=DEFAULT_JSON) -> list:
    from repro_torch.serve.engine import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    m, k = workload.M, workload.K
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=device)
    t_pack = best_s(pack_fn(a), device, iters)
    rows = []
    for n in workload.n_sweep:
        b = torch.randn((k, n), generator=g, device=device)
        t_comp = best_s(lambda: torch.matmul(a, b), device, iters)
        rows.append({"n": n, "M": m, "K": k,
                     "us": (t_pack + t_comp) * 1e6,
                     "pack_ms": t_pack * 1e3, "gemm_ms": t_comp * 1e3,
                     "pack_share": pack_share(t_pack, t_comp)})
        print(json.dumps(rows[-1]), flush=True)
    if json_path:
        out = Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "bench": "packing_fraction", "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "workload": dataclasses.asdict(workload), "rows": rows},
            indent=1))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paper", action="store_true",
                    help="PAPER_WORKLOAD (A 25600 x 25600) in place of "
                         "BENCH_WORKLOAD (2048 x 2048)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="where the rows go (empty: nowhere)")
    args = ap.parse_args(argv)
    run(PAPER_WORKLOAD if args.paper else BENCH_WORKLOAD, args.device,
        iters=args.iters, json_path=args.json or None)


if __name__ == "__main__":
    main()
