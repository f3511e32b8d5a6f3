"""Time the pack kernel (``csrc/pack_blocks.cu``) over launch plans, on the
card.

    PYTHONPATH=src python -m repro_torch.launch.pack_sweep [--shapes decode]
    PYTHONPATH=<package>/src python src/repro_torch/launch/pack_sweep.py \
        --wrapper-only

At three bf16 packs of GLM-4-9B: its prefill A pack ((2048, 4096) into
(256, 128) blocks), the per-call decode pack of its unpacked wk/wv
((4096, 256) into (256, 128)) and its largest layer-stacked leaf at load
((40, 4096, 13696) into (128, 128), the blocks ``prepack_for`` gives it on
the H100; ``chip_smoke.py``'s ``serve.glm4.load`` line checks that leaf
against ``eng.pack_report``).  For each shape it prints one JSON line per
launch plan: every TMA plan the kernel takes (chunk heights of 8 to 256
rows that divide bm, rings of 2 to 8 stages, 1 to 8 persistent CTAs an
SM, within the SM's shared memory) and every vec plan (128 or 256
threads, 1 to 8 rows a thread), with its device time (``tall_sweep.
device_ms``: an L2 flush and a device-side sleep before each launch),
its share of the bytes bound (the operand read once and the pack written
once over 3.35 TB/s) and whether ``kernels/tsmm.py::pack_plan`` picks it;
each result is checked bit for bit against ``kernels/ref.py::pack_ref``.
Then one line for ``permute(...).contiguous()`` at the same shape
(``library_ms``, a yardstick the port never calls; device and event
time), one for the plain
version and one for the wrapper ``pack_blocks_kernel`` (device time,
event time of one launch after a flush with its host time in it, and at
the decode shape the host microseconds per call: the least of seven runs
of ``--calls`` back-to-back calls, no sync, by the wall clock, each behind
a device-side sleep so the host never waits on the device; the vec and
the TMA design are also
timed so through ``launch_pack``).  ``--wrapper-only`` prints only the
wrapper, library and plain lines and asks nothing of the package but
``pack_blocks_kernel``, so the same script times another version of the
package (``PYTHONPATH`` pointed at it).  Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import torch

from repro_torch.kernels import ref, tsmm
from repro_torch.launch.tall_sweep import device_ms

HBM_BYTES_PER_S = 3.35e12
# name: (L, M, K, bm, bk)
SHAPES = {"prefill": (1, 2048, 4096, 256, 128),
          "decode": (1, 4096, 256, 256, 128),
          "load": (40, 4096, 13696, 128, 128)}


def event_ms(fn, flush, iters: int) -> float:
    """Mean CUDA-event time of one launch after an L2 flush, the host's
    time before the launch included."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def host_us(fn, calls: int, repeats: int = 7) -> float:
    """Host microseconds per call: ``calls`` back-to-back calls, no sync,
    by the wall clock, queued behind a device-side sleep (~0.1 s) so the
    host never waits on the device; the least of ``repeats`` such runs
    (the host's clock is noisy, the least is the call's own cost)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.1 * 2e9))
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, 1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best


def tma_plans(L, m, k, bm, bk, sms):
    """Every TMA plan the kernel takes at this shape (bf16)."""
    box = tsmm.pack_tma_box(k, bk, 2, 16)
    if not box:
        return []
    chunks0 = L * -(-m // bm) * -(-k // bk)
    plans = []
    for rows, stages, per_sm in itertools.product(
            (8, 16, 32, 64, 128, 256), (2, 3, 4, 6, 8), (1, 2, 4, 8)):
        smem = tsmm.pack_tma_smem(rows, bk, 2, stages)
        if (rows not in tsmm.pack_tma_rows(bm) or smem > tsmm.PACK_SMEM_MAX
                or per_sm * smem > 228 * 1024):
            continue
        plans.append(tsmm.PackPlan(
            "tma", rows, min(chunks0 * (bm // rows), per_sm * sms),
            tsmm.PACK_TMA_THREADS, stages, box))
    return plans


def vec_plans(L, m, k, bm, bk):
    """Every vec plan of 128 or 256 threads and 1 to 8 rows a thread."""
    plans = []
    blocks = L * -(-m // bm) * -(-k // bk)
    for threads, per in itertools.product((128, 256), (1, 2, 4, 8)):
        box, ty = tsmm.pack_vec_shape(bk, 2, threads)
        rows = ty * per
        if rows > -(-bm // ty) * ty:
            continue
        plans.append(tsmm.PackPlan("vec", rows, blocks * -(-bm // rows),
                                   threads, 0, box))
    return plans


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="prefill,decode,load")
    ap.add_argument("--wrapper-only", action="store_true")
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pack_sweep: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "package": os.path.dirname(tsmm.__file__),
                      "mode": "wrapper" if args.wrapper_only else "sweep"}),
          flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    for name in args.shapes.split(","):
        L, m, k, bm, bk = SHAPES[name]
        a = torch.randn((L, m, k), generator=g, device=dev).to(bf)
        if L == 1:
            a = a[0]
        nm, nk = -(-m // bm), -(-k // bk)
        want = ref.pack_ref(a, bm, bk)
        moved = 2 * (a.numel() + want.numel())
        bound_ms = 1e3 * moved / HBM_BYTES_PER_S
        iters = 5 if moved > 1e9 else 20
        head = {"shape": name, "L": L, "M": m, "K": k, "bm": bm, "bk": bk,
                "bytes": moved, "bound_ms": bound_ms, "card": smi}

        def emit(line, t):
            print(json.dumps({**head, **line, "device_ms": t,
                              "of_bound": bound_ms / t}), flush=True)

        def check(got, what):
            if not torch.equal(got, want):
                raise AssertionError(f"pack_sweep {name} {what}: not "
                                     f"bit-equal to pack_ref")

        def lib():
            return (a.unflatten(-2, (nm, bm)).unflatten(-1, (nk, bk))
                    .transpose(-3, -2).contiguous())

        check(lib(), "library")
        emit({"plan": "library", "ms": event_ms(lib, flush, iters)},
             device_ms(lib, flush, iters))
        emit({"plan": "plain"},
             device_ms(lambda: ref.pack_ref(a, bm, bk), flush, iters))

        def wrap():
            return tsmm.pack_blocks_kernel(a, bm, bk)

        check(wrap(), "wrapper")
        line = {"plan": "wrapper", "ms": event_ms(wrap, flush, iters)}
        if name == "decode":
            line["host_us"] = host_us(wrap, args.calls)
        emit(line, device_ms(wrap, flush, iters))
        if args.wrapper_only:
            del a, want
            torch.cuda.empty_cache()
            continue
        pick = tsmm.pack_plan(L, m, k, bm, bk, bf, 16, sms)
        # the other design's host cost at the decode shape: the TMA rule's
        # plan with the size threshold set aside
        other = (tsmm.pack_tma_plan(L, m, k, bm, bk, 2, 16, sms)
                 if name == "decode" else None)
        out = torch.empty_like(want)
        best = None
        for p in tma_plans(L, m, k, bm, bk, sms) + vec_plans(L, m, k, bm, bk):
            def run(p=p):
                return tsmm.launch_pack(a, out, bm, bk, 1.0, p)

            out.fill_(float("nan"))
            run()
            check(out, str(p))
            t = device_ms(run, flush, iters)
            line = {"plan": p.design, "rows": p.rows, "stages": p.stages,
                    "grid": p.grid, "threads": p.threads, "box": p.box,
                    "picked": p == pick}
            if name == "decode" and p in (pick, other):
                line["host_us"] = host_us(run, args.calls)
            emit(line, t)
            if best is None or t < best[0]:
                best = (t, p)
        picked_ms = device_ms(lambda: tsmm.launch_pack(a, out, bm, bk, 1.0,
                                                       pick), flush, iters)
        print(json.dumps({**head, "plan": "summary", "picked": str(pick),
                          "picked_ms": picked_ms, "fastest": str(best[1]),
                          "fastest_ms": best[0],
                          "picked_over_fastest": picked_ms / best[0]}),
              flush=True)
        del a, want, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
