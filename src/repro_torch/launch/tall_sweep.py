"""Time the bf16 tall-A wgmma kernel (``csrc/tsmm_tall.cu``) over launch
plans, on the card.

    PYTHONPATH=src python -m repro_torch.launch.tall_sweep [--m 2048,4096]

For each m at GLM-4-9B's K/V projection (K 4096, N 256, bias fused) it
runs every cluster size (1, 2, 4, 8) and ring depth (3 to 5) the kernel
takes, raises if a result is off the plain version by more than the bf16
tolerance (1.6e-2 + 1.6e-2 |ref|), and prints one JSON
line per plan with its device time: CUDA events around one launch after
an L2 flush, with a device-side sleep queued first so the host's enqueue
time is hidden (``device_ms``).  ``torch.matmul`` on the same operands is
timed the same way, and the plan ``kernels/tsmm.py::tall_plan`` picks is
marked.  Needs a CUDA card; exits non-zero without one.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", default="2048,4096")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tall_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda.load()["tsmm_tall"]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    k, n = 4096, 256
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    bias = (0.1 * torch.randn((n,), generator=g, device=dev)).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for m in (int(x) for x in args.m.split(",")):
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
                    out.data_ptr(), m, k, n, 0, 0, 0, 0, k, 1, tsmm.TALL_BM,
                    tsmm.TALL_NT, cluster, stages, tsmm.EPILOGUE, 0, 1,
                    stream)

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


if __name__ == "__main__":
    main()
