"""Pre-pack TSMM vs conventional (pack-every-call) GEMM under data reuse:
the paper's Figs. 6/7 on the port.

    PYTHONPATH=src python3 -m repro_torch.launch.prepack_vs_conventional \\
        [--device cuda] [--paper] [--iters 5] [--json PATH]

The port of the reference's ``benchmarks/prepack_vs_conventional.py`` on
``configs/tsmm_paper.py``'s workload (``BENCH_WORKLOAD``; ``--paper``:
``PAPER_WORKLOAD``, A 25600 x 25600 fp32).  With the input reused across
``repeats`` calls, pre-packing amortizes the pack while the conventional
implementation pays it on every call.  For each N of the sweep, three
rows, each in µs a call, GFLOP/s and its speedup over the conventional
row:

* ``conventional`` — the pack of A into 256 x 256 blocks
  (``kernels/ops.py::pack_blocks``: ``csrc/pack_blocks.cu`` on the card)
  plus the GEMM, on every call;
* ``prepack`` — the same GEMM plus pack / ``repeats``: the reference's
  comparison, which isolates the per-call pack.  The GEMM is the plain
  product (``torch.matmul``), as the reference's ``jnp.dot``;
* ``planned`` — the port's runtime stage on A packed once: the problem
  ``Problem(M, K, N, "float32")`` planned by the measured tournament for
  a caller that packs A once (``HwSpec.pack_once``), A packed once at the
  plan's blocks, the plan's tall kernel replayed ``repeats`` times
  (CUDA events around the pack and the replays, over ``repeats``).  The
  row carries the plan, the launch counter of its kernel
  (``kernels/gen.py::tall_steps``), its kernel's own time after an L2 flush
  (``kernel_ms``), the least time the card could take for the product
  (``bound_ms``: A, B and C over 3.35 TB/s against 2·M·K·N over the
  67 TFLOP/s fp32 peak) and ``library_ms`` (``torch.matmul``).  Its
  output is held to ``torch.matmul`` within ``f32_tol``.

Timing is the evaluator's (``core/evaluator.py::time_samples``: CUDA
events around each call after an L2 flush; on the CPU the host clock),
the minimum over ``--iters`` calls, with TF32 off.  The port's kernels
take no float64: the paper's DTSMM is not run.  Writes the rows as JSON
to ``build/bench/prepack_vs_conventional.json`` (or ``--json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.tsmm_paper import (BENCH_WORKLOAD, PAPER_WORKLOAD,
                                            TSMMWorkload)
from repro_torch.core.hw import H100

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_JSON = ROOT / "build" / "bench" / "prepack_vs_conventional.json"

PACK_BLOCK = 256          # the conventional path's pack blocks (reference)
# fp32 outputs: two summation orders over K unit-scale terms differ by up
# to ~5 * 2^-24 * K (a 5-sigma random walk of roundings), so the usual
# 1e-4 + 1e-4 |ref| grows with K past 256 terms
F32_TOL = 1e-4
F32_TOL_TERMS = 256


def f32_tol(k: int) -> float:
    """atol = rtol of an fp32 product over ``k`` terms against another
    summation order."""
    return F32_TOL * max(1.0, k / F32_TOL_TERMS)


def gflops(m: int, k: int, n: int, seconds: float) -> float:
    return 2 * m * k * n * 1e-9 / seconds


def speedup(t_conv: float, t_other: float) -> float:
    """The conventional row's time over another row's (the reference's
    ``t_conv / amort_pre``)."""
    return t_conv / t_other


def pack_share(t_pack: float, t_comp: float) -> float:
    """The share of a conventional call spent packing (the paper's Fig. 5,
    the reference's ``t_pack / (t_pack + t_comp)``)."""
    return t_pack / (t_pack + t_comp)


def amortized(t_comp: float, t_pack: float, repeats: int) -> float:
    """Seconds a call when one pack serves ``repeats`` calls."""
    return t_comp + t_pack / repeats


def bound_ms(m: int, k: int, n: int) -> tuple:
    """(bound_ms, bound_by) of an fp32 (m, k) x (k, n) product on the
    H100: each input read once and the output written once over HBM
    (3.35 TB/s), against the operations over the fp32 SIMT peak (67
    TFLOP/s)."""
    t_bytes = 4 * (m * k + k * n + m * n) / H100.hbm_bw
    t_ops = 2 * m * k * n / H100.peak_flops("float32")
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def best_s(fn, device, iters: int) -> float:
    """The evaluator's estimator: the fastest of ``iters`` timed calls."""
    from repro_torch.core.evaluator import time_samples
    return float(np.min(time_samples(fn, warmup=2, iters=iters,
                                     device=device)))


def pack_fn(a):
    from repro_torch.kernels import ops
    return lambda: ops.pack_blocks(a, PACK_BLOCK, PACK_BLOCK)


def plan_packed_once(m: int, k: int, n: int, device, *, top_k: int = 3,
                     iters: int = 5):
    """The measured tournament's plan of ``Problem(m, k, n, "float32")``
    for a caller that packs A once (``HwSpec.pack_once``), its records in
    a registry of its own so they never answer a serving lookup."""
    from repro_torch.core.autotuner import (candidate_blocks,
                                            dedupe_short_list,
                                            measure_short_list)
    from repro_torch.core.hw import for_device
    from repro_torch.core.plan import Problem
    from repro_torch.core.registry import Registry

    hw = dataclasses.replace(for_device(device), pack_once=True)
    cands = dedupe_short_list(candidate_blocks(
        Problem(m, k, n, "float32"), hw), hw)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_paper_",
                                     dir=ROOT / "build") as td:
        reg = Registry(plan_path=Path(td) / "plans.json",
                       measure_path=Path(td) / "measurements.json")
        return measure_short_list(cands, top_k=top_k, stable=2, iters=iters,
                                  warmup=2, device=device, hw=hw, reg=reg)


def replay(plan, a, b, repeats: int, device) -> tuple:
    """The runtime stage: pack ``a`` once at the plan's blocks, then run
    the plan's tall kernel on it ``repeats`` times.  Returns (seconds a
    call, pack and replays together over ``repeats``; the first call's
    (M, N) output)."""
    from repro_torch.kernels import ops, variants

    def call(ap):
        return variants.run_tall_a(plan.kernel, ap, b, bm=plan.bm,
                                   bk=plan.bk, packed=True,
                                   schedule=plan.schedule)

    m, n = a.shape[0], b.shape[1]
    out = call(ops.pack_blocks(a, plan.bm, plan.bk))[:m, :n]
    cuda_dev = torch.device(device).type == "cuda"
    if cuda_dev:
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    else:
        t0 = time.perf_counter()
    ap = ops.pack_blocks(a, plan.bm, plan.bk)
    for _ in range(repeats):
        call(ap)
    if cuda_dev:
        e1.record()
        e1.synchronize()
        seconds = e0.elapsed_time(e1) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return seconds / repeats, out


def check_planned(out, want, k: int) -> float:
    """Max |out - want|; raises past ``f32_tol(k)`` (atol and rtol)."""
    tol = f32_tol(k)
    err = (out.float() - want.float()).abs()
    if not bool(torch.all(err <= tol + tol * want.float().abs())):
        raise AssertionError(f"planned output off torch.matmul: max |err| "
                             f"{float(err.max())} past {tol} + {tol} |ref| "
                             f"(K = {k})")
    return float(err.max())


def sweep(workload: TSMMWorkload, device, *, iters: int = 5, top_k: int = 3):
    """Yield one dict per N of ``workload.n_sweep``: the three rows, the
    pack and GEMM seconds, the pack share and the planned row's checks.
    A (M, K) and each B are made on ``device`` from seed 0."""
    from repro_torch.kernels import gen, ops, variants

    device = torch.device(device)
    m, k, reps = workload.M, workload.K, workload.repeats
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=device)
    t_pack = best_s(pack_fn(a), device, iters)
    for n in workload.n_sweep:
        b = torch.randn((k, n), generator=g, device=device)
        t_comp = best_s(lambda: torch.matmul(a, b), device, iters)
        t_conv = t_pack + t_comp
        t_pre = amortized(t_comp, t_pack, reps)
        plan = plan_packed_once(m, k, n, device, top_k=top_k, iters=iters)
        t_plan, out = replay(plan, a, b, reps, device)
        err = check_planned(out, torch.matmul(a, b), k)
        del out
        ap = ops.pack_blocks(a, plan.bm, plan.bk)
        kernel_ms = 1e3 * best_s(
            lambda: variants.run_tall_a(plan.kernel, ap, b, bm=plan.bm,
                                        bk=plan.bk, packed=True,
                                        schedule=plan.schedule),
            device, iters)
        del ap
        bms, by = bound_ms(m, k, n)

        def row(t):
            return {"us": t * 1e6, "gflops": gflops(m, k, n, t),
                    "speedup": speedup(t_conv, t)}

        yield {"n": n, "M": m, "K": k, "repeats": reps,
               "pack_ms": t_pack * 1e3, "gemm_ms": t_comp * 1e3,
               "pack_share": pack_share(t_pack, t_comp),
               "conventional": row(t_conv), "prepack": row(t_pre),
               "planned": {**row(t_plan), "plan": plan.to_json(),
                           "kernel": plan.kernel.key(),
                           "launch": gen.tall_steps(plan.gen_spec(),
                                                    plan.grid[1], True)[0][0],
                           "blocks": [plan.bm, plan.bk, plan.bn],
                           "kernel_ms": kernel_ms, "bound_ms": bms,
                           "bound_by": by, "library_ms": t_comp * 1e3,
                           "max_abs_err": err, "tol": f32_tol(k)}}
        if device.type == "cuda":
            torch.cuda.empty_cache()


def run(workload: TSMMWorkload = BENCH_WORKLOAD, device="cuda", *,
        iters: int = 5, top_k: int = 3, json_path=DEFAULT_JSON) -> list:
    from repro_torch.serve.engine import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for r in sweep(workload, device, iters=iters, top_k=top_k):
        rows.append(r)
        print(json.dumps(r), flush=True)
    if json_path:
        out = Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "bench": "prepack_vs_conventional", "device": str(device),
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
    ap.add_argument("--top-k", type=int, default=3,
                    help="candidates the tournament may time per N")
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="where the rows go (empty: nowhere)")
    args = ap.parse_args(argv)
    run(PAPER_WORKLOAD if args.paper else BENCH_WORKLOAD, args.device,
        iters=args.iters, top_k=args.top_k, json_path=args.json or None)


if __name__ == "__main__":
    main()
