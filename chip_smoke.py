#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and the CUDA toolkit.  Phases, each
printing one JSON line:

1. env      — torch / CUDA versions and the card (``nvidia-smi`` name and
              power limit, also printed raw on a line of its own);
2. build    — nvcc builds every kernel from ``src/repro_torch/csrc``;
3. kernels  — each kernel of the main path at the main path's shapes
              against its plain PyTorch version on the same inputs (max
              error within the stated tolerance), with kernel, plain and
              library times (CUDA events, L2 flushed before each launch)
              and the least time the card could take (``bound_ms``);
4. parity   — qwen1.5-4b at full width, 2 layers, float32: one 256-token
              request, prefill + 4 decode steps on the card (kernels)
              against the port on the CPU (plain versions) with the same
              packed weights;
5. serve    — qwen1.5-4b at full width and full depth (40 layers), bf16,
              seeded random weights, through ``Engine(max_batch=4)``:
              request groups of 1, 3 and 4 with 256-token prompts and 16
              greedy steps.  Launch counts are zeroed just before and read
              just after; every kernel of the path must have launched.

Then the ``kernels`` summary line and, last, the ``{"ok": true, ...}``
line.  Any failure raises and exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's published peaks (H100 SXM data sheet, dense): the bound_ms
# rates.  Every kernel of the path runs in bf16 here.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# bf16 outputs: the kernel and its plain version accumulate in fp32 in
# different orders, then round once to bf16 (8 significant bits): allow
# two bf16 ulps of the value's magnitude
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# fp32 partial sums (k-split mode): reassociation over K <= 6912 terms
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# parity: fp32 logits through 2 layers and a 2560-deep head, card vs CPU
PARITY_RTOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def within(got, want, rtol, atol) -> tuple:
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    return ok, float(err.max())


class Timer:
    """CUDA-event timing of single launches, each after an L2 flush (a
    256 MB write), so every launch finds its operands in HBM as the main
    path does; returns the mean of ``iters`` launches after ``warmup``."""

    def __init__(self):
        import torch
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters=5, warmup=1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / iters


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "sm_count": props.multi_processor_count,
          "smem_per_block_optin": props.shared_memory_per_block_optin})
    # fp32 products stay fp32 (no TF32) in every plain and library call
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import cuda
    t0 = time.perf_counter()
    cuda.load()
    rep = cuda.build_report
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in rep.get("ptxas", {}).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": rep.get("built", []), "ptxas": regs})


def bound(moved_bytes, flops) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over the bf16 tensor-core peak."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(timer):
    """Every skinny mode at the main path's shapes, and flash attention."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gen, ops, tsmm
    from repro_torch.kernels.flash_attention import (_torch_attention,
                                                     flash_attention)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    cases = []
    worst = {}
    shapes = [(2560, 2560), (2560, 6912), (6912, 2560), (2560, 151936)]
    for k, n in shapes:
        w = (torch.randn((k, n), generator=g, device="cuda")
             / k ** 0.5).to(bf)
        bias = (0.1 * torch.randn((n,), generator=g, device="cuda")).to(bf)
        bk, bn = 128, 128
        wp = ops.pack_blocks(w, bk, bn)
        for m in (1, 4, 1024):
            x = torch.randn((m, k), generator=g, device="cuda").to(bf)
            modes = {
                # name: (kernel counter, kernel call, plain call, tol)
                "baseline": ("tsmm_skinny_a",
                             lambda: tsmm.tsmm_skinny_a(x, wp, bias, act="silu"),
                             lambda: tsmm._torch_skinny(
                                 x, wp, bias, "silu", natural=False, splits=1,
                                 mode=tsmm.EPILOGUE), BF16_TOL),
                "natural": ("skinny_kinner",
                            lambda: gen._skinny_kinner(
                                x, w, bias, bk=bk, bn=bn, act="silu",
                                natural=True, resident=False, revisit=False),
                            lambda: tsmm._torch_skinny(
                                x, w, bias, "silu", natural=True, splits=1,
                                mode=tsmm.EPILOGUE), BF16_TOL),
                "resident": ("skinny_kinner",
                             lambda: gen._skinny_kinner(
                                 x, wp, bias, bk=bk, bn=bn, act="silu",
                                 natural=False, resident=True, revisit=False),
                             lambda: tsmm._torch_skinny(
                                 x, wp, bias, "silu", natural=False, splits=1,
                                 mode=tsmm.EPILOGUE), BF16_TOL),
                "revisit": ("skinny_kinner",
                            lambda: gen._skinny_kinner(
                                x, wp, bias, bk=bk, bn=bn, act="silu",
                                natural=False, resident=False, revisit=True),
                            lambda: tsmm._torch_skinny(
                                x, wp, None, None, natural=False, splits=1,
                                mode=tsmm.RAW_F32)[0], F32_TOL),
                "split_epi": ("skinny_kinner",
                              lambda: gen._skinny_kinner(
                                  x, wp, None, bk=bk, bn=bn, act=None,
                                  natural=False, resident=False,
                                  revisit=False),
                              lambda: tsmm._torch_skinny(
                                  x, wp, None, None, natural=False, splits=1,
                                  mode=tsmm.EPILOGUE), BF16_TOL),
            }
            # the splits that cut the K-block count evenly (the planner's
            # gate): 8 divides no path shape's count at bk=128
            for s in (2, 4, 8):
                if (k // bk) % s:
                    continue
                modes[f"ksplit{s}"] = (
                    "skinny_ksplit",
                    lambda s=s: gen._skinny_ksplit(x, wp, bk=bk, bn=bn,
                                                   splits=s, natural=False,
                                                   resident=False),
                    lambda s=s: tsmm._torch_skinny(
                        x, wp, None, None, natural=False, splits=s,
                        mode=tsmm.RAW_F32), F32_TOL)
            for mode, (name, kern, plain, tol) in modes.items():
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                ok, err = within(got, want, **tol)
                if not ok:
                    raise AssertionError(
                        f"{name}/{mode} m={m} K={k} N={n}: max |err| {err} "
                        f"outside {tol}")
                worst[name] = max(worst.get(name, 0.0), err)
                iters = 2 if m * n > 4 * 151936 else 5
                ms = timer(kern, iters=iters)
                plain_ms = timer(plain, iters=iters)
                lib_ms = timer(lambda: torch.matmul(x, w), iters=iters)
                # each input read once (bf16 X, W, bias), the output written
                # once (bf16, or the fp32 raw / partial sums)
                moved = (2 * (m * k + k * n + n)
                         + got.numel() * got.element_size())
                bound_ms, bound_by = bound(moved, 2 * m * k * n)
                cases.append({"kernel": name, "mode": mode, "m": m, "K": k,
                              "N": n, "max_abs_err": err, "tol": tol,
                              "ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by})
            del x
        del w, wp, bias
        torch.cuda.empty_cache()

    b, h, s, d = 4, 20, 256, 128
    q, kk, v = (torch.randn((b, s, h, d), generator=g, device="cuda").to(bf)
                for _ in range(3))
    got = flash_attention(q, kk, v, causal=True)
    want = _torch_attention(q, kk, v, causal=True)
    torch.cuda.synchronize()
    ok, err = within(got, want, **BF16_TOL)
    if not ok:
        raise AssertionError(f"flash_attention: max |err| {err} outside "
                             f"{BF16_TOL}")
    worst["flash_attention"] = err
    # QK^T and PV over the causal triangle (diagonal included); q, k, v
    # read once, the output written once
    bound_ms, bound_by = bound(4 * b * s * h * d * 2,
                               4 * b * h * d * (s * (s + 1) // 2))
    cases.append({
        "kernel": "flash_attention", "mode": "causal", "B": b, "H": h,
        "S": s, "D": d, "max_abs_err": err, "tol": BF16_TOL,
        "ms": timer(lambda: flash_attention(q, kk, v, causal=True)),
        "plain_ms": timer(lambda: _torch_attention(q, kk, v, causal=True)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by})
    for c in cases:
        emit({"phase": "kernels", **c})
    return cases, worst


def phase_parity():
    """Full width, 2 layers, fp32: card (kernels) vs CPU (plain versions)
    on the same packed weights and the same token stream."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.linear import serving_ctx
    from repro_torch.models.param import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import pack_tree_for_serving

    cfg = dataclasses.replace(get_config("qwen1_5_4b"), num_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(0))
    packed, report = pack_tree_for_serving(params, axes, (1,))
    del params
    prompt = ((torch.arange(256) * 7 + 3) % cfg.vocab_size).to(torch.int32)
    steps, max_len = 4, 256 + 8

    def run(params, device, feed=None):
        out, toks = [], []
        with torch.inference_mode(), serving_ctx():
            cache = model.init_cache(1, max_len, device)
            logits, cache = model.prefill(
                params, {"tokens": prompt[None].to(device)}, cache)
            out.append(logits[:, -1].float().cpu())
            for i in range(steps):
                tok = (feed[i] if feed is not None
                       else int(out[-1].argmax(dim=-1)[0]))
                toks.append(tok)
                t = torch.tensor([[tok]], dtype=torch.int32, device=device)
                logits, cache = model.decode_step(params, cache, t)
                out.append(logits[:, -1].float().cpu())
        return out, toks

    t0 = time.perf_counter()
    ref, toks = run(packed, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    gpu_params = tree_map(lambda t: t.to("cuda"), packed)
    t0 = time.perf_counter()
    got, _ = run(gpu_params, torch.device("cuda"), feed=toks)
    gpu_s = time.perf_counter() - t0
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scale = max(1.0, max(float(r.abs().max()) for r in ref))
    tol = PARITY_RTOL * scale
    emit({"phase": "parity", "layers": cfg.num_layers, "dtype": cfg.dtype,
          "prompt": 256, "decode_steps": steps,
          "packed_leaves": len(report), "max_abs_err_per_step": errs,
          "tol": tol, "tol_rule": f"{PARITY_RTOL} * max(1, max|logit|)",
          "cpu_s": cpu_s, "gpu_s": gpu_s})
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError("parity: non-finite logits on the card")
    if max(errs) > tol:
        raise AssertionError(f"parity: max |err| {max(errs)} > {tol}")


def phase_serve():
    import torch
    from collections import Counter

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import make_group
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine

    cfg = get_config("qwen1_5_4b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompt, steps = 256, 16
    eng = Engine(model, params, axes, max_len=prompt + steps + 8,
                 max_batch=4, max_prompt=prompt, device="cuda")
    del params
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    variants = Counter(eng.variant_report().values())
    emit({"phase": "serve.load", "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "packed_leaves": len(eng.pack_report), "buckets": eng.buckets,
          "variants": dict(sorted(variants.items())), "load_s": load_s,
          "mem_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    if len(eng.pack_report) != 8:
        raise AssertionError(f"expected 8 packed leaves, got "
                             f"{sorted(eng.pack_report)}")
    cuda.reset_launches()
    first = []
    for b in (1, 3, 4):
        res = eng.generate(make_group(cfg, b, prompt, "cuda"), steps=steps)
        toks = res.tokens
        if (toks.shape != (b, steps) or not torch.isfinite(res.logits_last).all()
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
            raise AssertionError(f"serve b={b}: bad output {tuple(toks.shape)}")
        first.append(toks[0].tolist())
        emit({"phase": "serve", "group": b, "buckets": res.buckets,
              "prefill_s": res.prefill_s, "per_token_s": res.per_token_s,
              "tokens[0]": toks[0].tolist()})
    launches = dict(cuda.launches)
    emit({"phase": "serve.launches", "launches": launches,
          "tokens0_equal_across_groups": all(t == first[0] for t in first)})
    missing = [k for k in ("tsmm_skinny_a", "skinny_kinner", "skinny_ksplit",
                           "flash_attention") if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    return launches


def main():
    phase_env()
    import torch
    phase_build()
    timer = Timer()
    cases, worst = phase_kernels(timer)
    phase_parity()
    launches = phase_serve()
    replaces = {
        "tsmm_skinny_a": ("src/repro_torch/csrc/tsmm_skinny.cu",
                          "src/repro/kernels/tsmm.py:295", "baseline", 6912, 1024),
        "skinny_kinner": ("src/repro_torch/csrc/tsmm_skinny.cu",
                          "src/repro/kernels/gen.py:310", "resident", 151936, 4),
        "skinny_ksplit": ("src/repro_torch/csrc/tsmm_skinny.cu",
                          "src/repro/kernels/gen.py:374", "ksplit2", 6912, 4),
    }
    tol = (f"every case: |err| <= atol + rtol*|plain|, bf16 outputs "
           f"{BF16_TOL}, fp32 raw/partial outputs {F32_TOL}")
    line = []
    for name, (src, rep, mode, n, m) in replaces.items():
        c = next(c for c in cases if c["kernel"] == name and c["mode"] == mode
                 and c["N"] == n and c["m"] == m and c["K"] == 2560)
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches.get(name, 0),
                     "max_abs_err": worst[name], "tol": tol, "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"],
                     "shape": f"m={m} K=2560 N={n} {mode}"})
    c = next(c for c in cases if c["kernel"] == "flash_attention")
    line.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:76",
                 "launches": launches.get("flash_attention", 0),
                 "max_abs_err": worst["flash_attention"], "tol": tol,
                 "ms": c["ms"],
                 "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                 "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                 "shape": "B=4 H=20 S=256 D=128 causal"})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
