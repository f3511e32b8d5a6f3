"""Time the skinny-A kernel (``csrc/tsmm_skinny.cu``) over launch plans,
on the card.

    PYTHONPATH=src python -m repro_torch.launch.skinny_sweep [--only prefill]
    PYTHONPATH=src python -m repro_torch.launch.skinny_sweep --dtype float32 \
        [--wrapper-only]

At the skinny projections of qwen1.5-4b (K, N in (2560, 2560), (2560,
6912), (6912, 2560), (2560, 151936)) and GLM-4-9B ((4096, 4096), (4096,
13696), (13696, 4096), (4096, 151552)), W packed at (128, 128), SiLU
fused: the prefill rows (qwen 1024, GLM 2048) through the wgmma design at
every row tile (64, 128) and ring depth (2 to 6) whose ring holds the
fp32 tile and fits shared memory, and the decode rows
(1 and 4) through the stream design at every cluster (1, 2, 4, 8) and
ring depth (2, 4, 6).  Each result is checked against the plain version
(raises beyond the bf16 tolerance, 1.6e-2 + 1.6e-2 |ref|); each plan
prints one JSON line with its device time (``tall_sweep.device_ms``: an
L2 flush and a device-side sleep before each launch), with
``torch.matmul`` on the natural operands timed the same way and the plan
``kernels/tsmm.py::skinny_plan`` picks marked.

``--dtype float32``: both fp32 designs (``f32``, the TMA-fed FMA
stream; ``tf32x3``, 3xTF32 on wgmma) at m = 1, 4, 16, 32, 64, 256 and
2048 over the calibration gate's fp32 context widths
(``launch/calibration_quality.py``: (K, N) = (4096, 2048) and (8192,
1024)) and qwen1.5-4b's gate / up projection (2560, 6912), W packed at
(128, 128), through the C entry at every plan: ``f32`` at m <= 64 over
its column tiles (32, 64, 128), clusters (1, 2, 4, 8) and rings (4, 8)
on its smallest row tile, ``tf32x3`` over row tiles (16, 64 and the
fewest of at most 128), 64 or 128 W columns and clusters on a ring of 4,
and the pick.  Each plan's output is held to the plain version within
1e-4 + 1e-4 |ref| (raises beyond it) and printed with its device time, its
bound at the design's data-sheet rate (bytes over 3.35 TB/s against
2 m K N over 67 TFLOP/s of FMA or 495 / 3 of 3xTF32) and the plan
``skinny_plan`` picks marked; each (m, K, N) also prints
``torch.matmul`` (TF32 off) on the natural operands, and each (K, N) the
crossover the sweep finds: the smallest m at which the fastest
``tf32x3`` plan beats the fastest ``f32`` one.  ``--wrapper-only`` times
only ``tsmm_skinny_a`` at the same points, with the design it ran, so a
parent checkout's package can be timed the same way (``PYTHONPATH=
<parent>/src python3 src/repro_torch/launch/skinny_sweep.py --dtype
float32 --wrapper-only``).  Needs a CUDA card; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from repro_torch.kernels import cuda, ops, tsmm
from repro_torch.launch.tall_sweep import TOL, device_ms

SHAPES = {"qwen1_5_4b": (1024, ((2560, 2560), (2560, 6912), (6912, 2560),
                                (2560, 151936))),
          "glm4_9b": (2048, ((4096, 4096), (4096, 13696), (13696, 4096),
                             (4096, 151552)))}
DECODE_M = (1, 4)


# the fp32 sweep's (K, N): the calibration gate's fp32 skinny context
# widths and qwen1.5-4b's gate / up projection; its rows
FP32_SHAPES = ((4096, 2048), (8192, 1024), (2560, 6912))
FP32_M = (1, 4, 16, 32, 64, 256, 2048)
F32_TOL = 1e-4


def fp32_plans(m: int, k: int, n: int, pick) -> list:
    """Every fp32 plan the sweep times at (m, k, n), W packed at 128 x
    128: ``f32`` (m <= 64) over column tiles, clusters and rings 4 / 8 on
    its smallest row tile; ``tf32x3`` over row tiles (16, 64 and the
    fewest of at most 128), 64 / 128 W columns and clusters on a ring of
    4; and the pick.  Each ring fits shared memory."""
    plans = []
    if m <= 64:
        for nt in (32, 64, 128):
            bm = max(8, 512 // nt, 1 << (m - 1).bit_length())
            plans += [tsmm.SkinnyPlan("f32", bm, nt, c, st)
                      for c in (1, 2, 4, 8) for st in (4, 8)
                      if k // 32 >= c]
    top = -(-m // (8 * -(-m // 128))) * 8
    rows = {r for r in (16, 64) if r < top} | {top}
    plans += [tsmm.SkinnyPlan("tf32x3", bm, nt, c, 4)
              for bm in sorted(rows) for nt in (64, 128) for c in (1, 2, 4, 8)]
    plans = [p for p in plans if tsmm.skinny_smem(p) <= tsmm.SKINNY_SMEM_MAX]
    return plans if pick in plans else plans + [pick]


def fp32_operands(g, dev, m, k, n):
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    wp = ops.pack_blocks(w, 128, 128)
    want = tsmm._torch_skinny(x, wp, None, None, natural=False, splits=1,
                              mode=tsmm.EPILOGUE)
    return x, w, wp, want


def check_fp32(got, want, what) -> float:
    err = (got - want).abs()
    if bool((err > F32_TOL + F32_TOL * want.abs()).any()):
        raise AssertionError(f"skinny_sweep fp32 {what}: max |err| "
                             f"{float(err.max())}")
    return float(err.max())


def sweep_fp32_wrapper(dev, flush) -> None:
    """``tsmm_skinny_a`` (whatever design the package runs) and
    ``torch.matmul`` at every fp32 point; public names only, so it times
    a parent checkout's package too."""
    from repro_torch.launch.prepack_vs_conventional import bound_ms
    g = torch.Generator(device=dev).manual_seed(0)
    for k, n in FP32_SHAPES:
        for m in FP32_M:
            x, w, wp, want = fp32_operands(g, dev, m, k, n)
            before = dict(cuda.design_launches)
            got = tsmm.tsmm_skinny_a(x, wp)
            ran = sorted(d for d, v in cuda.design_launches.items()
                         if v != before.get(d, 0))
            print(json.dumps({
                "dtype": "float32", "m": m, "K": k, "N": n,
                "plan": "wrapper", "design": ran,
                "max_abs_err": check_fp32(got, want, (m, k, n)),
                "device_ms": device_ms(lambda: tsmm.tsmm_skinny_a(x, wp),
                                       flush, iters=10),
                "library_ms": device_ms(lambda: torch.matmul(x, w), flush,
                                        iters=10),
                "bound_ms": bound_ms(m, k, n)[0]}), flush=True)
            del x, w, wp, want, got
        torch.cuda.empty_cache()


def sweep_fp32(lib, dev, sms, flush) -> None:
    """Every plan of both fp32 designs at every fp32 point, through the
    C entry, against torch.matmul; the crossover of each (K, N)."""
    from repro_torch.core.hw import H100
    from repro_torch.core.smem_model import peak_rate
    from repro_torch.launch.prepack_vs_conventional import bound_ms
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for k, n in FP32_SHAPES:
        best = {}
        for m in FP32_M:
            x, w, wp, want = fp32_operands(g, dev, m, k, n)
            pick = tsmm.skinny_plan(m, k, n, dtype=torch.float32,
                                    natural=False, bk=128, bn=128,
                                    mode=tsmm.EPILOGUE, splits=1, kps=k,
                                    sms=sms)
            print(json.dumps({
                "dtype": "float32", "m": m, "K": k, "N": n,
                "plan": "torch.matmul",
                "device_ms": device_ms(lambda: torch.matmul(x, w), flush,
                                       iters=10)}), flush=True)
            out = torch.empty((m, n), device=dev)
            for p in fp32_plans(m, k, n, pick):
                scratch = (torch.empty((2, -(-m // p.bm) * p.bm, k),
                                       device=dev)
                           if p.design == "tf32x3" else None)

                def run(p=p, scratch=scratch):
                    cuda.check(lib.tsmm_skinny_launch(
                        x.data_ptr(), wp.data_ptr(), None, out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), m,
                        k, n, k, 128, 128, 0, 1, tsmm.EPILOGUE, 0, 0,
                        tsmm._SKINNY_DESIGN[p.design], p.bm, p.nt,
                        p.cluster, p.stages, stream), "tsmm_skinny")
                out.zero_()
                run()
                torch.cuda.synchronize()
                err = check_fp32(out, want, (m, k, n, p))
                ms = device_ms(run, flush, iters=10)
                key = (m, p.design)
                best[key] = min(best.get(key, ms), ms)
                print(json.dumps({
                    "dtype": "float32", "m": m, "K": k, "N": n,
                    "design": p.design, "bm": p.bm, "nt": p.nt,
                    "cluster": p.cluster, "stages": p.stages,
                    "ctas": tsmm.grid_ctas(p, m, n, 1), "picked": p == pick,
                    "max_abs_err": err, "device_ms": ms,
                    "bound_ms": bound_ms(m, k, n,
                                         peak_rate(p, "float32", H100))[0],
                    "bound_ms_fma": bound_ms(m, k, n)[0]}), flush=True)
                del scratch
            del x, w, wp, want, out
            torch.cuda.empty_cache()
        cross = next((m for m in FP32_M if (m, "tf32x3") in best
                      and best[(m, "tf32x3")] < best.get((m, "f32"),
                                                         float("inf"))),
                     None)
        print(json.dumps({"dtype": "float32", "K": k, "N": n,
                          "crossover_m": cross,
                          "fastest": {f"{m}/{d}": v
                                      for (m, d), v in best.items()}}),
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("prefill", "decode"), default=None)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--wrapper-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("skinny_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda.load()["tsmm_skinny"]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    if args.dtype == "float32":
        if args.wrapper_only:
            sweep_fp32_wrapper(dev, flush)
        else:
            sweep_fp32(lib, dev, sms, flush)
        return
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    bk = bn = 128
    for arch, (prefill_m, shapes) in SHAPES.items():
        for k, n in shapes:
            w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(bf)
            wp = ops.pack_blocks(w, bk, bn)
            bias = (0.1 * torch.randn((n,), generator=g, device=dev)).to(bf)
            ms = {"prefill": (prefill_m,), "decode": DECODE_M}
            for phase in ("prefill", "decode"):
                if args.only not in (None, phase):
                    continue
                for m in ms[phase]:
                    x = torch.randn((m, k), generator=g, device=dev).to(bf)
                    want = tsmm._torch_skinny(x, wp, bias, "silu",
                                              natural=False, splits=1,
                                              mode=tsmm.EPILOGUE)
                    pick = tsmm.skinny_plan(
                        m, k, n, dtype=bf, natural=False, bk=bk, bn=bn,
                        mode=tsmm.EPILOGUE, splits=1, kps=k, sms=sms)
                    print(json.dumps({
                        "arch": arch, "m": m, "K": k, "N": n,
                        "plan": "torch.matmul",
                        "device_ms": device_ms(lambda: torch.matmul(x, w),
                                               flush)}), flush=True)
                    out = torch.empty((m, n), dtype=bf, device=dev)
                    if phase == "prefill":
                        plans = [tsmm.SkinnyPlan("wgmma", bm, 128, 1, st)
                                 for bm, st in itertools.product(
                                     (64, 128), (2, 3, 4, 5, 6))
                                 if st * (bm + 128) * 128 >= bm * 136 * 4]
                    else:
                        plans = [tsmm.SkinnyPlan("stream", 8, tsmm.SKINNY_NT,
                                                 c, st)
                                 for c, st in itertools.product(
                                     (1, 2, 4, 8), (2, 4, 6))]
                    for p in plans:
                        def run(p=p):
                            cuda.check(lib.tsmm_skinny_launch(
                                x.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), None, m, k, n, k, bk, bn, 0, 1,
                                tsmm.EPILOGUE, 2, 1,
                                tsmm._SKINNY_DESIGN[p.design], p.bm, p.nt,
                                p.cluster, p.stages, stream), "tsmm_skinny")
                        out.zero_()
                        run()
                        torch.cuda.synchronize()
                        diff = (out.float() - want.float()).abs()
                        err = float(diff.max())
                        if bool((diff > TOL + TOL * want.float().abs()).any()):
                            raise AssertionError(f"skinny_sweep {arch} m={m} "
                                                 f"K={k} N={n} {p}: max "
                                                 f"|err| {err}")
                        ctas = (-(-m // p.bm) * (n // p.nt) * p.cluster)
                        print(json.dumps({
                            "arch": arch, "m": m, "K": k, "N": n,
                            "design": p.design, "bm": p.bm,
                            "cluster": p.cluster, "stages": p.stages,
                            "ctas": ctas, "picked": p == pick,
                            "max_abs_err": err,
                            "device_ms": device_ms(run, flush)}), flush=True)
                    del x, want, out
            del w, wp, bias
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
