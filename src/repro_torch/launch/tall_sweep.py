"""Time the tall-A kernel's designs (``csrc/tsmm_tall.cu``) over launch
plans, on the card.

    PYTHONPATH=src python -m repro_torch.launch.tall_sweep [--m 2048,4096]
    PYTHONPATH=src python -m repro_torch.launch.tall_sweep --dtype float32

bf16 (the default): for each m at GLM-4-9B's K/V projection (K 4096, N
256, bias fused) the wgmma design at every cluster size (1, 2, 4, 8) and
ring depth (3 to 5) it takes; a result off the plain version by more
than the bf16 tolerance (1.6e-2 + 1.6e-2 |ref|) raises.

float32: at the paper's shape (``configs/tsmm_paper.py``: A 25600 x
25600, natural, the N of its sweep) both fp32 designs, ``f32`` (FMA
tiles: every column tile of 8-64 that holds N, or 64-column tiles past
64) and ``tf32x3`` (3xTF32 on wgmma: N rounded up to 8 in the fewest
equal tiles of up to 128 columns, and in one more), each at row tiles
64 and 128 and the ring
depths that fit shared memory; a result off ``torch.matmul`` (TF32 off)
by more than the K-scaled fp32 tolerance of the paper tool
(``prepack_vs_conventional.f32_tol``) raises.  After each N a line with
the fastest plan of each design; last, the crossover: the smallest N of
the sweep from which on ``tf32x3``'s fastest plan beats ``f32``'s
(``kernels/tsmm.py::TALL_F32_CROSSOVER`` is set from it).

Each plan prints one JSON line with its device time: CUDA events around
one launch after an L2 flush, with a device-side sleep queued first so
the host's enqueue time is hidden (``device_ms``).  ``torch.matmul`` on
the same operands is timed the same way, and the plan
``kernels/tsmm.py::tall_plan`` picks is marked.  Needs a CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import torch

from repro_torch.kernels import cuda, tsmm

TOL = 1.6e-2    # bf16 output: atol and rtol against the plain version


def device_ms(fn, flush, iters: int = 20) -> float:
    """Mean device time of ``fn`` (ms) over ``iters`` launches, each after
    an L2 flush and behind a sleep long enough to hide its host time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(4 * host_s, 1e-4) * 2e9)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def sweep_bf16(ms, lib, dev, sms, flush) -> None:
    """The wgmma design at GLM-4-9B's K/V shape for each m of ``ms``."""
    g = torch.Generator(device=dev).manual_seed(0)
    k, n = 4096, 256
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    bias = (0.1 * torch.randn((n,), generator=g, device=dev)).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for m in ms:
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        want = tsmm._torch_tall(a, b, bias, None, mode=tsmm.EPILOGUE,
                                splits=1, k0=0, k1=k, out=None)
        pick = tsmm.tall_plan(m, k, n, dtype=torch.bfloat16, packed=False,
                              pbm=0, pbk=0, mode=tsmm.EPILOGUE, splits=1,
                              kps=k, sms=sms)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        print(json.dumps({"m": m, "K": k, "N": n, "plan": "torch.matmul",
                          "device_ms": device_ms(lambda: torch.matmul(a, b),
                                                 flush)}), flush=True)
        for cluster, stages in itertools.product((1, 2, 4, 8), (3, 4, 5)):
            def launch():
                return lib.tsmm_tall_launch(
                    a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), None, m, k, n, 0, 0, 0, 0, k, 1,
                    tsmm._TALL_DESIGN["wgmma"], tsmm.TALL_BM, tsmm.TALL_NT,
                    cluster, stages, tsmm.EPILOGUE, 0, 1, stream)

            def run():
                cuda.check(launch(), "tsmm_tall")
            out.zero_()
            run()
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            if bool((diff > TOL + TOL * want.float().abs()).any()):
                raise AssertionError(f"tall_sweep m={m} cluster={cluster} "
                                     f"stages={stages}: max |err| {err}")
            print(json.dumps({
                "m": m, "K": k, "N": n, "nt": tsmm.TALL_NT,
                "cluster": cluster, "stages": stages,
                "ctas": -(-m // tsmm.TALL_BM) * (n // tsmm.TALL_NT) * cluster,
                "picked": (cluster, stages) == (pick.cluster, pick.stages),
                "max_abs_err": err, "device_ms": device_ms(run, flush)}),
                flush=True)


def fp32_plans(n: int) -> list:
    """Every (design, bm, nt, stages) the sweep times at N = ``n``: the
    column tiles of each design (f32: each of 8-64 that holds N, or 64
    past 64; tf32x3: N rounded up to 8 in the fewest equal tiles of at
    most 128 columns, and in one tile more), row tiles 64 and 128, the
    ring depths that fit."""
    w = tsmm.tall_width(n, torch.float32)
    out = []
    f32_nt = [t for t in tsmm.TALL_F32_NT if t >= min(w, 64)]
    tiles = -(-w // tsmm.TALL_X3_NT)
    x3_nt = sorted({tsmm.tall_width(-(-w // t), torch.float32)
                    for t in (tiles, tiles + 1)})
    for design, nts, depths in (("f32", f32_nt, (2, 4, 6)),
                                ("tf32x3", x3_nt, (2, 3, 4))):
        for nt, bm, stages in itertools.product(nts, (64, 128), depths):
            plan = tsmm.TallPlan(design, bm, nt, 1, stages)
            if tsmm.tall_smem(plan) <= tsmm.TALL_SMEM_MAX:
                out.append(plan)
    return out


def sweep_fp32(m, k, ns, lib, dev, sms, flush, iters: int = 5) -> dict:
    """Both fp32 designs at (m, k) for each N of ``ns``; returns {N:
    {design: fastest device ms}}."""
    from repro_torch.core.hw import H100
    from repro_torch.core.smem_model import peak_rate
    from repro_torch.launch.prepack_vs_conventional import bound_ms, f32_tol
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    tol = f32_tol(k)
    best = {}
    for n in ns:
        b = torch.randn((k, n), generator=g, device=dev)
        want = torch.matmul(a, b)
        lib_ms = device_ms(lambda: torch.matmul(a, b), flush, iters)
        pick = tsmm.tall_plan(m, k, n, dtype=torch.float32, packed=False,
                              pbm=0, pbk=0, mode=tsmm.EPILOGUE, splits=1,
                              kps=k, sms=sms)
        print(json.dumps({"dtype": "float32", "M": m, "K": k, "N": n,
                          "plan": "torch.matmul", "device_ms": lib_ms}),
              flush=True)
        out = torch.empty((m, n), device=dev)
        best[n] = {}
        for p in fp32_plans(n):
            np_ = -(-n // p.nt) * p.nt
            scratch = (torch.empty((2, np_, k), device=dev)
                       if p.design == "tf32x3" else None)

            def run(p=p, scratch=scratch):
                cuda.check(lib.tsmm_tall_launch(
                    a.data_ptr(), b.data_ptr(), None, out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), m, k, n,
                    0, 0, 0, 0, k, 1, tsmm._TALL_DESIGN[p.design], p.bm,
                    p.nt, 1, p.stages, tsmm.EPILOGUE, 0, 0, stream),
                    "tsmm_tall")
            out.zero_()
            run()
            torch.cuda.synchronize()
            diff = (out - want).abs()
            err = float(diff.max())
            if bool((diff > tol + tol * want.abs()).any()):
                raise AssertionError(f"tall_sweep fp32 N={n} {p}: max |err| "
                                     f"{err} past {tol} + {tol} |ref|")
            ms = device_ms(run, flush, iters)
            best[n][p.design] = min(best[n].get(p.design, ms), ms)
            print(json.dumps({
                "dtype": "float32", "M": m, "K": k, "N": n,
                "design": p.design, "bm": p.bm, "nt": p.nt,
                "stages": p.stages,
                "ctas": -(-m // p.bm) * -(-n // p.nt),
                "smem": tsmm.tall_smem(p), "picked": p == pick,
                "max_abs_err": err, "device_ms": ms,
                "tflops": 2 * m * k * n / ms * 1e-9,
                "bound_ms": bound_ms(m, k, n,
                                     peak_rate(p, "float32", H100))[0],
                "library_ms": lib_ms}), flush=True)
            del scratch
        print(json.dumps({"dtype": "float32", "M": m, "K": k, "N": n,
                          "fastest_ms": best[n], "library_ms": lib_ms,
                          "pick": [pick.design, pick.bm, pick.nt,
                                   pick.stages]}), flush=True)
        del b, want
    return best


def crossover(best: dict):
    """The smallest N of the sweep from which on tf32x3's fastest plan
    beats f32's at every larger N (None if it never does)."""
    ns = sorted(best)
    for i, n in enumerate(ns):
        if all(best[x]["tf32x3"] < best[x]["f32"] for x in ns[i:]):
            return n
    return None


def main(argv=None) -> None:
    from repro_torch.configs.tsmm_paper import PAPER_WORKLOAD
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--m", default="2048,4096",
                    help="bf16: the rows of A to sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tall_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda.load()["tsmm_tall"]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    if args.dtype == "bfloat16":
        sweep_bf16([int(x) for x in args.m.split(",")], lib, dev, sms, flush)
        return
    best = sweep_fp32(PAPER_WORKLOAD.M, PAPER_WORKLOAD.K,
                      PAPER_WORKLOAD.n_sweep, lib, dev, sms, flush)
    print(json.dumps({"dtype": "float32", "crossover": crossover(best),
                      "fastest_ms": best,
                      "TALL_F32_CROSSOVER": tsmm.TALL_F32_CROSSOVER}),
          flush=True)


if __name__ == "__main__":
    main()
