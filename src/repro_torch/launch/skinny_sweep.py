"""Time the bf16 skinny-A kernel (``csrc/tsmm_skinny.cu``) over launch
plans, on the card.

    PYTHONPATH=src python -m repro_torch.launch.skinny_sweep [--only prefill]
    PYTHONPATH=src python -m repro_torch.launch.skinny_sweep --dtype float32

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

``--dtype float32``: the fp32 design (SIMT) as it stands, at the
calibration gate's fp32 context shapes (``launch/calibration_quality.py``:
(m, K, N) = (16, 4096, 2048) and (32, 8192, 1024), W packed at (128,
128)), through ``tsmm_skinny_a`` against ``torch.matmul`` (TF32 off) on
the natural operands, each beside its bound (bytes over 3.35 TB/s
against 2 m K N over the 67 TFLOP/s of fp32 FMA); a result off the plain
version by more than 1e-4 + 1e-4 |ref| raises.  Needs a CUDA card; exits
non-zero without one.
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


# the calibration gate's fp32 skinny context problems (m, K, N)
FP32_SHAPES = ((16, 4096, 2048), (32, 8192, 1024))
F32_TOL = 1e-4


def sweep_fp32(dev, sms, flush) -> None:
    """The fp32 skinny design at ``FP32_SHAPES`` against torch.matmul."""
    from repro_torch.launch.prepack_vs_conventional import bound_ms
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in FP32_SHAPES:
        x = torch.randn((m, k), generator=g, device=dev)
        w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
        wp = ops.pack_blocks(w, 128, 128)
        want = tsmm._torch_skinny(x, wp, None, None, natural=False, splits=1,
                                  mode=tsmm.EPILOGUE)
        got = tsmm.tsmm_skinny_a(x, wp)
        err = (got - want).abs()
        if bool((err > F32_TOL + F32_TOL * want.abs()).any()):
            raise AssertionError(f"skinny_sweep fp32 ({m}, {k}, {n}): max "
                                 f"|err| {float(err.max())}")
        pick = tsmm.skinny_plan(m, k, n, dtype=torch.float32, natural=False,
                                bk=128, bn=128, mode=tsmm.EPILOGUE, splits=1,
                                kps=k, sms=sms)
        bms, by = bound_ms(m, k, n)
        print(json.dumps({
            "dtype": "float32", "m": m, "K": k, "N": n,
            "design": pick.design, "bm": pick.bm, "nt": pick.nt,
            "ctas": -(-m // pick.bm) * (n // pick.nt),
            "max_abs_err": float(err.max()),
            "device_ms": device_ms(lambda: tsmm.tsmm_skinny_a(x, wp), flush),
            "library_ms": device_ms(lambda: torch.matmul(x, w), flush),
            "bound_ms": bms, "bound_by": by}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("prefill", "decode"), default=None)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("skinny_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda.load()["tsmm_skinny"]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    if args.dtype == "float32":
        sweep_fp32(dev, sms, flush)
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
                                out.data_ptr(), m, k, n, k, bk, bn, 0, 1,
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
