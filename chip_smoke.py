#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and the CUDA toolkit.  Phases, each
printing JSON lines:

1. env        — torch / CUDA versions and the card (``nvidia-smi`` name
                and power limit, also printed raw on a line of its own);
2. build      — nvcc builds every kernel from ``src/repro_torch/csrc``;
                ``cuobjdump -sass`` counts each library's tensor-core
                (``HGMMA``) and TMA (``UTMALDG``/``UTMASTG``/``UBLKCP``)
                instructions; the bf16 skinny (wgmma and stream), tall
                and flash kernels and the fp32 skinny and tall 3xTF32
                kernels must have wgmma and a TMA load, the fp32 skinny
                and tall FMA kernels a TMA load, the pack kernel's TMA
                design a TMA load and a TMA or bulk store;
3. install    — the install-time stage at full width into a temporary
                plan cache (``repro_torch.core.install``): ``--measure``
                for qwen1.5-4b (buckets 1, 2, 4; prompts to 256),
                GLM-4-9B (buckets 1, 2; prompts to 2048), OLMoE-1B-7B
                (buckets 1, 2, 4; prompts to 256), DeepSeek-V2 (its
                published widths, MLA's five projections among them;
                buckets 1, 2; prompts to 512), Mamba2-780m (buckets 1, 2,
                4; prompts to 256), Zamba2-2.7B (its shared block's
                2 x d_model-wide projections among them; buckets 1, 2;
                prompts to 2048), h2o-danube-1.8b (buckets 1, 2; prompts
                to 4352), the LLaVA-NeXT backbone (buckets 1, 2; prompts
                to 192 after its 2880 image embeddings), whisper-base
                (buckets 1, 2, 4; prompts to 256, its encoder's rows
                too) and llama3-405b (buckets 1, 2; prompts to 512),
                every candidate
                timed on the hand-written kernels and held to the serving
                path; ``--calibrate``; ``--check`` (zero misses, then every
                sampled grammar point and schedule through the CUDA
                kernels against their plain versions, fp32 and bf16).
                Prints the records, the fit, the Spearman rank correlation
                of model and measurement per problem before and after the
                fit, and GLM-4-9B's K/V model pick against the measured
                winner.  The pack cases of the kernels phase then take the
                layouts the installed plans give GLM-4-9B and
                DeepSeek-V2's ``wo``;
3a. gate      — the calibration gate on the card: ``launch/
                calibration_quality.py``'s ``run`` as the tool runs it; its
                assert (the calibrated model ranks the gate problems'
                short lists better than the data-sheet model) must hold;
                its fp32 skinny context problems run the fp32 skinny
                designs;
3b. paper     — the paper's experiment at its full size
                (``configs/tsmm_paper.py``'s ``PAPER_WORKLOAD``: A 25600 x
                25600 fp32 made on the card from a seeded generator, N
                over 4-240, 200 reuses) through
                ``launch/prepack_vs_conventional.py``: one line per N with
                the conventional (pack every call + GEMM), pre-pack (GEMM
                + pack / 200) and planned rows (the tournament's pack-once
                plan, A packed once, its fp32 tall kernel replayed 200
                times on the design of its N, ``f32`` or ``tf32x3``; its
                output held to ``torch.matmul`` within the K-scaled fp32
                tolerance) and the pack share; then the pack
                of one A at 256 x 256 blocks (2.62 GB, past 2^31 bytes)
                bit-equal to ``pack_ref`` and back through ``unpack_ref``,
                with its times.  The phase frees its memory and prints its
                seconds;
4. kernels    — each kernel at the main paths' shapes (the skinny
                projections of qwen1.5-4b and GLM-4-9B at decode and
                prefill, OLMoE-1B-7B's attention projections and head,
                DeepSeek-V2's MLA projections, dense first-layer MLP
                and head, Mamba2-780m's and Zamba2-2.7B's projections
                and heads, GLM-4-9B's tall K/V
                projections, the pack at
                GLM-4-9B's three pack shapes (its prefill activations,
                the per-call decode pack of wk/wv, its largest leaf at
                load) and at DeepSeek-V2's largest leaf at load, flash
                attention at qwen's, OLMoE's and GLM-4-9B's
                prefill, GLM-4-9B's at both of its groups, at
                Zamba2-2.7B's head dim 80, at whisper-base's decoder (D
                64, 4 x 256) and at the LLaVA-NeXT backbone's 3072
                positions (32 on 8 heads), every bf16 case on the wgmma
                design; the skinny-A kernel with bias + GELU at
                whisper-base's w_in (m 4 and 4 x 1500); llama3-405b's
                head (16384 x 128256, 4.2 GB packed: past 2^31 bytes)
                and w_down (K 53248) packed as serve.llama3 packs them,
                bit-equal to ``pack_ref``, with ``tsmm_skinny_a`` and the
                resident k-inner kernel on the head at m 1 and 2, the
                k-split kernel (2 splits) on w_down at m 1 and 2 and
                ``tsmm_skinny_a`` at m 1, 2, 512; and the three skinny-A
                functions in fp32 at m = 1-2048 over the gate's two fp32
                context widths, qwen1.5-4b's gate / up projection and
                the fp32 parity paths' largest K, on ``f32`` or
                ``tf32x3``: packed and natural W, bias and each
                activation, raw sums and k-splits 2 and 4, within
                ``F32_TOL``, beside ``torch.matmul`` with TF32 off)
                against its plain PyTorch version
                on the same inputs (max error within the stated
                tolerance; the pack bit-equal), with the design that ran
                it, kernel, plain and library times (CUDA events, L2
                flushed before each launch) and ``device_ms`` (the host's
                time hidden) and the least time the card could take
                (``bound_ms``);
5. tall       — ``tsmm_dot`` at GLM-4-9B's wk shape, m = 2048 and 4096
                (its two groups' prefill, which the plan runs on 4- and
                2-CTA clusters) and 8192 (no cluster),
                once per tall family through an explicit plan (natural
                and packed baseline, B-resident, revisit, k-split,
                k-outer), each against the plain product; each family's
                counter must rise;
6. parity     — qwen1.5-4b at full width (1 x 256 tokens), a
                GLM-shaped config (d_model 1024, 8 heads on 2 KV heads of
                128, 2 x 1024 tokens, so wk/wv take the tall path),
                OLMoE-1B-7B at full width (1 x 256) and DeepSeek-V2 at
                full width but 16 routed experts (1 x 128; the cut is on
                the line), both MoE drop-free (capacity factor 8), 2
                layers, Mamba2-780m at full width (2 layers, 1 x 256) and
                Zamba2-2.7B at full width (12 layers: two groups, so the
                shared block serves two K/V caches; 1 x 256, flash's
                SIMT kernel at D 80), h2o-danube-1.8b at full width (2
                layers, its window cut to 256 under a 384-token prompt:
                the prefill rolls), the LLaVA-NeXT backbone at full width
                (2 layers, 64 image embeddings + 64 tokens), whisper-base
                whole (1500 frames, 4 decoder tokens) and llama3-405b's
                reduced config widened so every leaf packs (each cut on
                its line), float32: prefill + 4 decode steps
                on the card (kernels) against the port on the CPU (plain
                versions) with the same packed weights; every skinny
                launch on ``f32`` (decode) or ``tf32x3`` (prefill), and
                both designs run;
7. serve      — qwen1.5-4b at full width, 20 of its 40 layers, bf16,
                seeded random weights, through ``Engine(max_batch=4)``:
                request groups of 1, 3 and 4 with 256-token prompts and 16
                greedy steps;
8. serve.glm4 — GLM-4-9B at full width and full depth (40 layers), bf16,
                seeded random weights, ``Engine(max_batch=2)``: groups of 1
                and 2 with 2048-token prompts and 8 greedy steps; its
                unpacked wk/wv run the tall-A kernel at prefill;
9. queue.parity — continuous batching (``Engine.serve_queue``) from 2
                slots at qwen1.5-4b's widths, 2 layers, float32: the
                reference test's ragged queue, later requests joining a
                running batch; each stream's tokens against its solo
                ``generate`` (a token that differs must be a near-tie:
                the logits it was chosen from agree with the solo run's
                within ``F32_TOL`` and the two tokens' logits are within
                it); every skinny launch on ``f32`` or ``tf32x3``;
10. queue     — qwen1.5-4b at full width, 20 layers, bf16, on a queue
                engine of its own (4 slots, prompts to 256, ``max_len`` by
                the ragged rule, its 57 cells captured at load): 16
                ragged requests (the continuous-batching tool's lengths
                scaled into 5-256 tokens, budgets 2-16) through
                ``serve_queue`` eagerly and then graphed (the main path):
                tokens bit-equal, launches equal, 0 cells captured by
                traffic, 0 registry misses; the telemetry, admission and
                step wall times, the comparison against aligned groups
                (``launch/continuous_batching.py``) and the profile of
                one step (the bucket-4 decode cell on the queue engine's
                cache);
11. queue.frontend — on the same engine: ``AsyncEngine.simulate`` on a
                virtual clock (all arrivals at 0) must serve
                ``serve_queue``'s tokens; then ``AsyncEngine.run()`` on
                the real clock under a producer submitting a seeded
                Poisson trace of the 16 requests at half the request rate
                the queue sustained: TTFT and queue delay percentiles,
                every stream completed, none rejected;
12. serve.olmoe — OLMoE-1B-7B at its published dims, 8 of its 16 layers (64
                experts, top-8), bf16, seeded random weights,
                ``Engine(max_batch=4)``: groups of 1, 3 and 4 with
                256-token prompts and 16 greedy steps; prints
                ``param_count`` / ``active_param_count`` and the profile
                of a bucket-4 step with the ``moe_experts`` and
                ``moe_dispatch`` families;
13. queue.olmoe — OLMoE-1B-7B (8 layers) on a queue engine of its own (4
                slots): 8 ragged requests through ``serve_queue`` eagerly
                and then graphed: tokens bit-equal, 0 cells captured by
                traffic, 0 misses;
14. serve.deepseek — DeepSeek-V2 at its published widths cut to 3 layers
                (the dense first layer and 2 MoE layers of 160 experts,
                top-6, 2 shared; the cut is on the line), bf16,
                ``Engine(max_batch=2)``: groups of 1 and 2 with 512-token
                prompts and 8 steps.  MLA's prefill runs the chunked body
                (``flash_attention`` must not launch; the body is timed
                apart at the 2 x 512 group beside its bound and SDPA, and
                held to SDPA), its decode the absorbed form over the
                compressed cache;
15. serve.mamba2 — Mamba2-780m at full width, 24 of its 48 layers, bf16,
                ``Engine(max_batch=4)``: groups of 1, 3 and 4 with
                256-token prompts and 16 steps; every Mamba leaf, and the
                tied head as a packed copy of the table's transpose, packed
                at load; no pack launch and no flash launch on the path;
16. serve.zamba2 — Zamba2-2.7B at full width, 24 of its 54 Mamba2
                layers (the shared attention + MLP block applied 4
                times), bf16,
                ``Engine(max_batch=2)``: groups of 1 and 2 with 2048-token
                prompts and 8 steps; every leaf packed at load, no pack
                launch on the path, and the 2048-token prefill cells
                launch flash at D 80.  Both SSM paths also print the
                eager profile of one prefill (the ``ssm_conv``,
                ``ssm_scan`` and ``ssm_state`` families);
17. serve.danube — h2o-danube-1.8b whole (24 layers, window 4096), bf16,
                ``Engine(max_batch=2)`` whose length grid holds exactly
                its two prompts: groups of 1 and 2 at 4352 tokens (the
                prefill rolls past the window) and at 4088 (the graphed
                decode crosses slot 4095 -> 0 at position 4096, checked
                on each bucket's cache), 16 steps; windowed attention
                takes the chunked body: flash must not launch;
18. serve.llava — the LLaVA-NeXT Mistral-7B backbone whole (32 layers),
                groups of 1 and 2 with 2880 seeded image embeddings and
                192 tokens (3072 positions: flash at D 128 on 32 query /
                8 KV heads), 16 steps;
19. serve.whisper — whisper-base whole (6 + 6 layers), groups of 1, 3
                and 4 with 1500 seeded frames and 256-token decoder
                prompts (flash at D 64), 16 steps; every projection and
                the tied head (zero-padded) packed at load; the skinny-A
                kernel's bias + GELU epilogue counted on the graphed
                groups (``cuda.epilogue_launches``): every encoder and
                decoder layer's MLP of each prefill, and no epilogue
                other than bias + GELU;
20. serve.llama3 — llama3-405b at its published widths cut to 2 layers
                (12.8 GB of layers, 8.4 GB of embedding and head), groups
                of 1 and 2 with 512-token prompts, 8 steps, flash at D
                128;
21. resilience — the kernel ladder (``core/tsmm.py``) on qwen1.5-4b at
                full width, 2 layers, float32 (the parity phase's cut), one
                group of 2 x 64 tokens and 4 steps, each engine fresh:
                healthy; then with ``kernels.lower.skinny`` and
                ``kernels.lower.tall`` armed to raise (rung 2: the plain
                versions on the card; its logits within ``F32_TOL`` of the
                healthy run's, no kernel launched at all,
                ``kernel.variant`` >= 1, ``health_report()`` not
                healthy); then with ``kernels.xla.*`` armed too (rung 3:
                ``torch.matmul``, within ``F32_TOL``, no kernel
                launched); the breaker pinning its fallback
                after K failures of ``tsmm_dot`` on the card; and, disarmed,
                a fresh engine healthy again.  Logits, not tokens, are
                compared: where a token differs, the logits it was chosen
                from must agree within ``F32_TOL`` and the two tokens'
                logits be within it (a near-tie);
22. fleet     — the tuning fleet (``tuning/``, ``launch/tune_service.py``)
                on a fleet directory of its own: an engine (qwen1.5-4b at
                full width, 2 layers, bf16, no install, no background
                tuner) flushes its registry misses to the miss log;
                ``tune_service harvest``; ``work --workers 2`` on the card
                (two fresh interpreters sharing the card), every job
                completed exactly once; ``export`` of a find-db; a fresh
                engine on an empty plan cache with the find-db attached
                serves with 0 registry misses.  Prints the jobs, seconds
                and jobs per minute.

The serve and queue paths of qwen1.5-4b, OLMoE-1B-7B, Mamba2-780m and
Zamba2-2.7B run at half their depth (``HALF_DEPTH``), so that with
the paths of h2o-danube-1.8b, LLaVA-NeXT, whisper-base and llama3-405b
the script stays well inside its time limit (each of the four fits the
card whole; the cut only shortens the run: about 190 s on an H100,
every width and kernel shape as at full depth).
Every serve and queue path (7-20) must end with a healthy engine:
``Engine.health_report()`` with 0 degradations (no ladder demotion) and
no armed failpoint (the ``.health`` lines; each serve line prints its
engine's ``degradations``).  The script refuses to start with
``REPRO_TORCH_FAILPOINTS`` set.

The serve paths (7, 8, 12, 14, 15, 16, 17-20) run one table-driven phase
(``phase_serve`` over ``SERVE``), each with its own checks as hooks.
Every serve phase starts on the registry the install phase wrote and must
make zero registry misses over load, precompile, prefill and decode.
Each captures its engine's whole grid at load (``Engine.precompile``:
one CUDA graph per decode bucket and per (bucket x length) prefill, and
for the ragged families (not the SSM family or the hybrid) the prefill
with pad and the scheduler's one-row admission ``prefill_row`` per
(bucket x length); the ``programs`` line: cells, capture seconds, graph
pool bytes, and the cells captured by traffic, which must be 0), then
serves every group twice: eagerly (an eager ``ProgramStore``, the same
cells without graphs) and graphed (the main path).  The graphed tokens
and last logits must be bit-equal to the eager ones (same kernels, same
launch order), and so must the launch counts (a replay adds what its
capture recorded).  Each prints ``prefill_s`` and ``per_token_s`` of
both runs, and a ``profile`` of one decode step (qwen1.5-4b bucket 4,
GLM-4-9B batch 1) with and without graphs: wall ms, device ms, host
launch calls and kernels per step (``launch/profile_decode.py``).

Each path (install, paper, serve, serve.glm4, queue, serve.olmoe,
queue.olmoe, serve.deepseek, serve.mamba2, serve.zamba2, serve.danube,
serve.llava, serve.whisper, serve.llama3) zeroes the
launch counts
just before it (on the serve paths: before the graphed groups; on the
queue path: before the graphed queue) and reads them just after; every kernel of the path must have
launched (on the serve paths: the baseline, flash and the kernel of every
variant the installed plans stamp; on the queue path: the variant
stamped for the slot bucket and the installed plan of every admission's
length bucket; on the install path: every TSMM kernel), and every bf16
skinny-A launch must have run the wgmma or the stream design, every
bf16 tall-A and flash launch the wgmma design and every pack launch (at
load and at decode) the TMA or the vec design (``cuda.design_launches``).
Then the ``kernels`` summary line (each kernel's launches on the serve
path that runs it, or on the install path where the measured plans keep
it off both; ``launches_by_path`` adds the paper, queue, MoE and SSM
paths' and the four of the rest of the zoo; flash's row carries its
D = 80, D = 64 and 3072-position cases with their launches on
serve.zamba2, serve.whisper and serve.llava; the skinny-A row its bias
+ GELU cases with its bias + GELU epilogue launches on serve.whisper;
the skinny rows and the pack row llama3-405b's head and w_down cases
with their launches on serve.llama3; each tall row the paper's planned rows it ran and the fp32
rows at N = 4, 32, 128, 240 (``f32`` or ``tf32x3``: ms, device_ms, the
bound at the design's rate beside the FMA bound, torch.matmul), each
skinny row its ``fp32_skinny`` cases and its fp32 launches on the
install, gate, parity and queue.parity paths, and the pack row its case
at the paper's shape) and,
last, the ``{"ok": true, ...}`` line.  Any failure
raises and exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# fp32 outputs (k-split partials, raw and accumulated sums): reassociation
# over K <= 6912 terms
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


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, else the copy Triton's package carries."""
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(path):
        return path
    import importlib.util
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        path = os.path.join(os.path.dirname(spec.origin), "backends", "nvidia",
                            "bin", "cuobjdump")
        if os.path.exists(path):
            return path
    raise RuntimeError("no cuobjdump: cannot check the kernels' SASS")


# the SASS instructions that show a kernel uses the tensor cores' wgmma,
# TMA loads, TMA tile stores and bulk copies
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP")
# the Hopper kernels of each library that must carry wgmma and a TMA load
# (the bf16 designs, and the fp32 skinny-A and tall-A 3xTF32 designs)
WGMMA_KERNELS = {"tsmm_skinny": ("skinny_wgmma_kernel", "skinny_stream_kernel",
                                 "skinny_tf32x3_kernel"),
                 "tsmm_tall": ("tall_wgmma_kernel", "tall_tf32x3_kernel"),
                 "flash_attention": ("flash_wgmma",)}
# the FMA kernels fed by TMA that must carry a TMA load (fp32 skinny-A's
# few-row and tall-A's narrow-N designs)
TMA_LOAD_KERNELS = {"tsmm_tall": ("tall_f32_kernel",),
                    "tsmm_skinny": ("skinny_f32_kernel",)}
# the TMA kernels that must carry a TMA load and a TMA or bulk store
TMA_COPY_KERNELS = {"pack_blocks": ("pack_tma_kernel",)}
# the designs an fp32 path may run: FMA (skinny-A's and tall-A's f32,
# flash's SIMT kernel) and skinny-A's and tall-A's 3xTF32; every fp32
# skinny-A launch runs one of FP32_SKINNY_DESIGNS
FP32_SKINNY_DESIGNS = {"skinny_f32", "skinny_tf32x3"}
FP32_TALL_DESIGNS = {"tall_f32", "tall_tf32x3"}
FP32_DESIGNS = FP32_SKINNY_DESIGNS | FP32_TALL_DESIGNS | {"flash_simt"}


def sass_counts(lib_path: str) -> dict:
    """{function name: {op: count}} over the SASS of one library."""
    text = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None:
            for op in SASS_OPS:
                if op in line:
                    funcs[cur][op] += 1
    return funcs


def phase_build():
    from repro_torch.kernels import cuda
    t0 = time.perf_counter()
    cuda.load()
    rep = cuda.build_report
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in rep.get("ptxas", {}).items()}
    sass = {}
    for name in cuda.SOURCES:
        funcs = sass_counts(os.path.join(rep["dir"], f"lib{name}.so"))
        total = {op: sum(f[op] for f in funcs.values()) for op in SASS_OPS}
        sass[name] = total
        for kern in WGMMA_KERNELS.get(name, ()):
            mine = [f for fn, f in funcs.items() if kern in fn]
            sass[name][kern] = mine
            if not mine or not all(f["HGMMA"] and (f["UTMALDG"] or f["UBLKCP"])
                                   for f in mine):
                raise AssertionError(f"{name}: the wgmma kernel {kern} has no "
                                     f"HGMMA or no TMA load in its SASS: "
                                     f"{funcs}")
        for kern in TMA_LOAD_KERNELS.get(name, ()):
            mine = [f for fn, f in funcs.items() if kern in fn]
            sass[name][kern] = mine
            if not mine or not all(f["UTMALDG"] for f in mine):
                raise AssertionError(f"{name}: the kernel {kern} has no TMA "
                                     f"load in its SASS: {funcs}")
        for kern in TMA_COPY_KERNELS.get(name, ()):
            mine = [f for fn, f in funcs.items() if kern in fn]
            sass[name][kern] = mine
            if not mine or not all(f["UTMALDG"] and (f["UTMASTG"] or f["UBLKCP"])
                                   for f in mine):
                raise AssertionError(f"{name}: the kernel {kern} has no TMA "
                                     f"load or no TMA / bulk store in its "
                                     f"SASS: {funcs}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": rep.get("built", []), "ptxas": regs, "sass": sass})


class Designs:
    """The designs (``cuda.design_launches``) a call ran: ``with
    Designs() as d: ...`` then ``d.ran``."""

    def __enter__(self):
        from repro_torch.kernels import cuda
        self.cuda = cuda
        self.before = dict(cuda.design_launches)
        return self

    def __exit__(self, *exc):
        self.ran = {k: v - self.before.get(k, 0)
                    for k, v in self.cuda.design_launches.items()
                    if v != self.before.get(k, 0)}


def design_of(ran: dict) -> str:
    """The one design a kernel call ran (``skinny_stream`` -> ``stream``)."""
    if len(ran) != 1:
        raise AssertionError(f"a kernel call ran designs {ran}, not one")
    return next(iter(ran)).split("_", 1)[1]


def check_wgmma(path: str, launches: dict, designs: dict) -> None:
    """Every bf16 skinny-A launch of a serve path ran the wgmma or the
    stream design, and every tall-A and flash launch the wgmma design."""
    skinny = sum(launches.get(k, 0) for k in SKINNY)
    tall = sum(launches.get(k, 0) for k in TALL)
    want = {"skinny": skinny, "tall_wgmma": tall,
            "flash_wgmma": launches.get("flash_attention", 0)}
    got = {"skinny": designs.get("skinny_wgmma", 0)
           + designs.get("skinny_stream", 0),
           **{k: designs.get(k, 0) for k in ("tall_wgmma", "flash_wgmma")}}
    fp32 = {k: designs[k] for k in FP32_DESIGNS if designs.get(k)}
    if got != want or fp32:
        raise AssertionError(f"{path}: design launches {designs} do not put "
                             f"every skinny launch on wgmma / stream and "
                             f"every tall / flash launch on wgmma ({want})")


def check_pack(path: str, launches: dict, designs: dict) -> None:
    """Every pack_blocks launch of a serve path ran a Hopper pack design
    (TMA or vec) and none another (the per-element SIMT kernel is gone)."""
    packs = {k: v for k, v in designs.items() if k.startswith("pack_")}
    if (sum(packs.values()) != launches.get("pack_blocks", 0)
            or set(packs) - {"pack_tma", "pack_vec"}):
        raise AssertionError(f"{path}: pack designs {packs} do not cover "
                             f"its {launches.get('pack_blocks', 0)} pack "
                             f"launches with the TMA and vec designs")


# the fp32 skinny-A design launches of each path that runs them (install,
# gate, the parity phases, queue.parity) and, on the fp32-only paths (the
# parity phases, queue.parity), each skinny kernel's launches, for the
# kernels line
FP32_PATHS = {}
# each serve path's fused-epilogue launches on its graphed groups
# (``cuda.epilogue_launches``: kernel/epilogue -> launches)
EPILOGUES = {}


def check_fp32(path: str, launches: dict, designs: dict) -> None:
    """An fp32 path ran fp32 designs only, every skinny-A launch on
    ``f32`` or ``tf32x3``; its skinny design launches go to
    ``FP32_PATHS``."""
    skinny = sum(launches.get(k, 0) for k in SKINNY)
    ran = {k: v for k, v in designs.items() if k in FP32_SKINNY_DESIGNS}
    FP32_PATHS[path] = {"designs": ran,
                        "launches": {k: launches.get(k, 0) for k in SKINNY}}
    if (set(designs) - FP32_DESIGNS - {"pack_tma", "pack_vec"}
            or sum(ran.values()) != skinny):
        raise AssertionError(f"{path}: fp32 design launches {designs} do "
                             f"not put its {skinny} skinny launches on "
                             f"{sorted(FP32_SKINNY_DESIGNS)} and nothing on "
                             f"a bf16 design")
    check_pack(path, launches, designs)


def bound(moved_bytes, flops) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over the bf16 tensor-core peak."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# skinny-A (K, N) projections and the m each is checked at: qwen1.5-4b's
# (decode batches 1 and 4, a 4 x 256-token prefill) and GLM-4-9B's (decode
# batches 1 and 2, a 2048-token prefill; its wk/wv are skinny only at
# decode, where they run the k-split kernel at 8 splits)
SKINNY_SHAPES = (
    [(k, n, (1, 4, 1024))
     for k, n in ((2560, 2560), (2560, 6912), (6912, 2560), (2560, 151936))]
    + [(k, n, (1, 2, 2048))
       for k, n in ((4096, 4096), (4096, 13696), (13696, 4096),
                    (4096, 151552))]
    + [(4096, 256, (1, 2))]
    # OLMoE-1B-7B's attention projections and head (decode batches 1 and
    # 4, a 4 x 256-token prefill)
    + [(k, n, (1, 4, 1024)) for k, n in ((2048, 2048), (2048, 50304))]
    # DeepSeek-V2's MLA projections wq_a, wq_b, wkv_a (576 wide: its
    # packed blocks are zero-padded to 640), wkv_b and wo, its dense first
    # layer's MLP (w_gate / w_up, w_down) and its head (decode batches 1
    # and 2, a 2 x 512-token prefill)
    + [(k, n, (1, 2, 1024))
       for k, n in ((5120, 1536), (1536, 24576), (5120, 576), (512, 32768),
                    (16384, 5120), (5120, 12288), (12288, 5120),
                    (5120, 102400))]
    # Mamba2-780m's w_in (6448 wide: zero-padded to whole blocks, packed
    # only), w_out and tied head (50280 wide, padded too; decode batches 1
    # and 4, a 4 x 256-token prefill)
    + [(k, n, (1, 4, 1024))
       for k, n in ((1536, 6448), (3072, 1536), (1536, 50280))]
    # Zamba2-2.7B's w_in (10448 wide, padded), w_out and the shared block's
    # wq / wk / wv (both (5120, 2560)), wo, w_gate / w_up and w_down, and
    # its head (decode batches 1 and 2, a 2048-token prefill)
    + [(k, n, (1, 2, 2048))
       for k, n in ((2560, 10448), (5120, 2560), (2560, 2560),
                    (5120, 10240), (10240, 2560), (2560, 32000))])


def phase_kernels(timer):
    """Every skinny mode at the main paths' shapes, every tall mode at
    GLM-4-9B's K/V projection, the pack at GLM-4-9B's three pack shapes,
    and flash attention."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gen, ops, tsmm
    from repro_torch.kernels.flash_attention import (_torch_attention,
                                                     flash_attention)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    cases = []
    worst = {}
    for k, n, ms in SKINNY_SHAPES:
        w = (torch.randn((k, n), generator=g, device="cuda")
             / k ** 0.5).to(bf)
        bk, bn = 128, 128
        wp = ops.pack_blocks(w, bk, bn)      # zero-padded to whole blocks
        bias = (0.1 * torch.randn((wp.shape[1] * bn,), generator=g,
                                  device="cuda")).to(bf)
        for m in ms:
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
            # the natural layout takes N in whole 128-column tiles
            # (``skinny_plan``), so wkv_a (576 wide) runs packed only, as
            # on its path
            if n % bn:
                del modes["natural"]
            # the splits that cut the K-block count evenly (the planner's
            # gate): none for GLM-4-9B's w_down, whose 107 blocks are prime
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
                with Designs() as d:
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
                device_ms = timer(kern, iters=iters, device=True)
                plain_ms = timer(plain, iters=iters)
                lib_ms = timer(lambda: torch.matmul(x, w), iters=iters)
                # each input read once (bf16 X, W, bias), the output written
                # once (bf16, or the fp32 raw / partial sums)
                moved = (2 * (m * k + k * n + n)
                         + got.numel() * got.element_size())
                bound_ms, bound_by = bound(moved, 2 * m * k * n)
                cases.append({"kernel": name, "mode": mode,
                              "design": design_of(d.ran), "m": m, "K": k,
                              "N": n, "max_abs_err": err, "tol": tol,
                              "ms": ms, "device_ms": device_ms,
                              "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by})
            del x
        del w, wp, bias
        torch.cuda.empty_cache()

    cases += gelu_cases(timer, g, worst)
    cases += llama3_cases(timer, g, worst)
    cases += skinny_fp32_cases(timer, g, worst)
    cases += tall_cases(timer, g, worst)
    cases += pack_cases(timer, g, worst)

    # qwen1.5-4b's prefill (4 x 256 tokens, 20 MHA heads), GLM-4-9B's
    # (1 and 2 x 2048 tokens, 32 query heads on 2 KV heads), OLMoE-1B-7B's
    # (4 x 256 tokens, 16 MHA heads), all at D 128, Zamba2-2.7B's shared
    # block (1 x 2048 tokens, 32 MHA heads of 80), whisper-base's decoder
    # (4 x 256 tokens, 8 MHA heads of 64) and LLaVA-NeXT's backbone (1 x
    # 3072 positions, 32 query heads on 8 KV heads of 128)
    for b, s, h, kh, d in ((4, 256, 20, 20, 128), (1, 2048, 32, 2, 128),
                           (2, 2048, 32, 2, 128), (4, 256, 16, 16, 128),
                           (1, 2048, 32, 32, 80), (4, 256, 8, 8, 64),
                           (1, 3072, 32, 8, 128)):
        q = torch.randn((b, s, h, d), generator=g, device="cuda").to(bf)
        kk, v = (torch.randn((b, s, kh, d), generator=g, device="cuda").to(bf)
                 for _ in range(2))
        with Designs() as dz:
            got = flash_attention(q, kk, v, causal=True)
        want = _torch_attention(q, kk, v, causal=True)
        torch.cuda.synchronize()
        ok, err = within(got, want, **BF16_TOL)
        if not ok:
            raise AssertionError(f"flash_attention S={s} H={h} KH={kh}: max "
                                 f"|err| {err} outside {BF16_TOL}")
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
        if design_of(dz.ran) != "wgmma":
            raise AssertionError(f"flash_attention D={d} in bf16 ran "
                                 f"{dz.ran}, not the wgmma design")
        # the library call takes the KV heads repeated to H (outside the
        # timed call)
        kr, vr = (t.repeat_interleave(h // kh, dim=2).transpose(1, 2)
                  for t in (kk, v))
        # QK^T and PV over the causal triangle (diagonal included); q, k,
        # v read once, the output written once
        bound_ms, bound_by = bound(2 * (2 * b * s * h * d + 2 * b * s * kh * d),
                                   4 * b * h * d * (s * (s + 1) // 2))
        cases.append({
            "kernel": "flash_attention", "mode": "causal",
            "design": design_of(dz.ran), "B": b, "H": h,
            "KH": kh, "S": s, "D": d, "max_abs_err": err, "tol": BF16_TOL,
            "ms": timer(lambda: flash_attention(q, kk, v, causal=True)),
            "device_ms": timer(lambda: flash_attention(q, kk, v, causal=True),
                               device=True),
            "plain_ms": timer(lambda: _torch_attention(q, kk, v,
                                                       causal=True)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kr, vr, is_causal=True)),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del q, kk, v, kr, vr, got, want
        torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", **c})
    return cases, worst


# whisper-base's MLP in-projection w_in (K 512, N 2048) at decode batch 4
# and its encoder's 4 x 1500 frames: the skinny-A kernel with bias and
# tanh-GELU in its epilogue, the first serve path's GELU
GELU_SHAPE = (512, 2048, (4, 4 * 1500))


def gelu_cases(timer, g, worst):
    """``tsmm_skinny_a`` with bias + GELU fused at ``GELU_SHAPE`` against
    its plain version (bias and GELU on the fp32 sums, one cast)."""
    import torch
    from repro_torch.kernels import ops, tsmm
    k, n, ms = GELU_SHAPE
    bf = torch.bfloat16
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(bf)
    wp = ops.pack_blocks(w, 128, 128)
    bias = (0.1 * torch.randn((n,), generator=g, device="cuda")).to(bf)
    out = []
    for m in ms:
        x = torch.randn((m, k), generator=g, device="cuda").to(bf)

        def kern():
            return tsmm.tsmm_skinny_a(x, wp, bias, act="gelu")

        def plain():
            return tsmm._torch_skinny(x, wp, bias, "gelu", natural=False,
                                      splits=1, mode=tsmm.EPILOGUE)

        with Designs() as d:
            got = kern()
        want = plain()
        torch.cuda.synchronize()
        ok, err = within(got, want, **BF16_TOL)
        if not ok:
            raise AssertionError(f"tsmm_skinny_a bias+gelu m={m}: max |err| "
                                 f"{err} outside {BF16_TOL}")
        worst["tsmm_skinny_a"] = max(worst.get("tsmm_skinny_a", 0.0), err)
        bound_ms, bound_by = bound(2 * (m * k + k * n + n + m * n),
                                   2 * m * k * n)
        out.append({"kernel": "tsmm_skinny_a", "mode": "bias_gelu",
                    "design": design_of(d.ran), "m": m, "K": k, "N": n,
                    "max_abs_err": err, "tol": BF16_TOL, "ms": timer(kern),
                    "device_ms": timer(kern, device=True),
                    "plain_ms": timer(plain),
                    # the product alone: no one library call adds the bias
                    # and the GELU
                    "library_ms": timer(lambda: torch.matmul(x, w)),
                    "library_call": "torch.matmul", "bound_ms": bound_ms,
                    "bound_by": bound_by})
        del x
    del w, wp, bias
    torch.cuda.empty_cache()
    return out


# llama3-405b's widest packed leaves as serve.llama3 packs them: the head
# (K 16384, N 128256, one (16384, 128) block a column tile: 4.2 GB bf16,
# past 2^31 bytes) and w_down (K 53248 in 26 blocks of 2048, N 16384), its
# one k-split point (2 splits of 416 64-deep stages each, cut unevenly over
# a cluster), each at the rows the path gives it
LLAMA3_LEAVES = {"head": (16384, 128256, 16384, 128, (1, 2)),
                 "w_down": (53248, 16384, 2048, 128, (1, 2, 512))}


def llama3_cases(timer, g, worst):
    """llama3-405b's head and w_down at full width: the pack at load
    bit-equal to ``pack_ref``; ``tsmm_skinny_a`` and the resident
    ``_skinny_kinner`` on the packed head at m 1 and 2, ``_skinny_ksplit``
    (2 splits) on w_down at m 1 and 2 and ``tsmm_skinny_a`` at its decode
    and 512-token prefill rows, each against ``tsmm._torch_skinny``."""
    import torch
    from repro_torch.kernels import gen, ref, tsmm
    bf = torch.bfloat16
    out = []
    for leaf, (k, n, bk, bn, ms) in LLAMA3_LEAVES.items():
        w = (torch.randn((k, n), generator=g, device="cuda")
             / k ** 0.5).to(bf)
        with Designs() as d:
            wp = tsmm.pack_blocks_kernel(w, bk, bn)
        want = ref.pack_ref(w, bk, bn)
        torch.cuda.synchronize()
        if not torch.equal(wp, want):
            raise AssertionError(f"pack_blocks llama3 {leaf} {(k, n)} by "
                                 f"({bk}, {bn}): not bit-equal to pack_ref")
        del want
        torch.cuda.empty_cache()
        bound_ms, bound_by = bound(2 * 2 * k * n, 0)
        out.append({"kernel": "pack_blocks", "mode": f"llama3_{leaf}",
                    "leaf": leaf, "design": design_of(d.ran), "M": k,
                    "K": n, "bm": bk,
                    "bk": bn, "bytes": 2 * k * n, "max_abs_err": 0.0,
                    "tol": "bit-equal",
                    "ms": timer(lambda: tsmm.pack_blocks_kernel(w, bk, bn),
                                iters=2),
                    "device_ms": timer(
                        lambda: tsmm.pack_blocks_kernel(w, bk, bn), iters=2,
                        device=True),
                    "plain_ms": timer(lambda: ref.pack_ref(w, bk, bn),
                                      iters=2),
                    # the same re-tile as one PyTorch copy (the blocks
                    # divide the leaf)
                    "library_ms": timer(lambda: w.unflatten(
                        0, (k // bk, bk)).unflatten(-1, (n // bn, bn))
                        .transpose(1, 2).contiguous(), iters=2),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        torch.cuda.empty_cache()
        for m in ms:
            x = torch.randn((m, k), generator=g, device="cuda").to(bf)
            funcs = {"baseline": (
                "tsmm_skinny_a", lambda: tsmm.tsmm_skinny_a(x, wp),
                lambda: tsmm._torch_skinny(x, wp, None, None, natural=False,
                                           splits=1, mode=tsmm.EPILOGUE),
                BF16_TOL)}
            if leaf == "head":
                funcs["resident"] = (
                    "skinny_kinner", lambda: gen._skinny_kinner(
                        x, wp, None, bk=bk, bn=bn, act=None, natural=False,
                        resident=True, revisit=False),
                    funcs["baseline"][2], BF16_TOL)
            elif m <= 2:
                funcs = {"ksplit2": (
                    "skinny_ksplit", lambda: gen._skinny_ksplit(
                        x, wp, bk=bk, bn=bn, splits=2, natural=False,
                        resident=True),
                    lambda: tsmm._torch_skinny(
                        x, wp, None, None, natural=False, splits=2,
                        mode=tsmm.RAW_F32), F32_TOL), **funcs}
            for mode, (name, kern, plain, tol) in funcs.items():
                with Designs() as d:
                    got = kern()
                want = plain()
                torch.cuda.synchronize()
                ok, err = within(got, want, **tol)
                if not ok:
                    raise AssertionError(
                        f"{name}/{mode} llama3 {leaf} m={m} K={k} N={n}: "
                        f"max |err| {err} outside {tol}")
                worst[name] = max(worst.get(name, 0.0), err)
                moved = 2 * (m * k + k * n) + got.numel() * got.element_size()
                bound_ms, bound_by = bound(moved, 2 * m * k * n)
                del got, want
                out.append({"kernel": name, "mode": mode, "leaf": leaf,
                            "design": design_of(d.ran), "m": m, "K": k,
                            "N": n, "bk": bk, "bn": bn, "max_abs_err": err,
                            "tol": tol, "ms": timer(kern, iters=3),
                            "device_ms": timer(kern, iters=3, device=True),
                            "plain_ms": timer(plain, iters=2),
                            "library_ms": timer(lambda: torch.matmul(x, w),
                                                iters=3),
                            "bound_ms": bound_ms, "bound_by": bound_by})
            del x
        del w, wp
        torch.cuda.empty_cache()
    return out


# fp32 skinny-A (K, N) and the m each is checked at: the calibration
# gate's two fp32 context widths and qwen1.5-4b's gate / up projection at
# decode and prefill rows around the designs' crossover, and the largest
# K of the fp32 parity paths (DeepSeek-V2's MLA wo) at its decode and
# prefill rows
FP32_SKINNY_SHAPES = (
    [(k, n, (1, 4, 16, 32, 64, 256, 2048))
     for k, n in ((4096, 2048), (8192, 1024), (2560, 6912))]
    + [(16384, 5120, (1, 128))])


def skinny_fp32_cases(timer, g, worst):
    """The three skinny-A functions in fp32 at ``FP32_SKINNY_SHAPES``:
    packed and natural W, mode 0 with bias and each activation, mode 1
    raw and at splits 2 and 4, each against its plain version at
    ``F32_TOL`` and timed beside ``torch.matmul`` (TF32 off) and its bound
    at the design's data-sheet rate (FMA 67 TFLOP/s for ``f32``, 495 / 3
    for ``tf32x3``) with the FMA bound beside it."""
    import torch
    from repro_torch.core.hw import H100
    from repro_torch.core.smem_model import peak_rate
    from repro_torch.kernels import gen, ops, tsmm

    cases = []
    for k, n, ms in FP32_SKINNY_SHAPES:
        w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
        bk = bn = 128
        wp = ops.pack_blocks(w, bk, bn)
        bias = 0.1 * torch.randn((n,), generator=g, device="cuda")
        for m in ms:
            x = torch.randn((m, k), generator=g, device="cuda")

            def plain(wq, b, act, natural=False, splits=1, mode=tsmm.EPILOGUE):
                return lambda: tsmm._torch_skinny(
                    x, wq, b, act, natural=natural, splits=splits, mode=mode)

            modes = {
                # name: (kernel counter, kernel call, plain call)
                "baseline": ("tsmm_skinny_a",
                             lambda: tsmm.tsmm_skinny_a(x, wp, bias, act="silu"),
                             plain(wp, bias, "silu")),
                "natural": ("skinny_kinner",
                            lambda: gen._skinny_kinner(
                                x, w, bias, bk=bk, bn=bn, act="gelu",
                                natural=True, resident=False, revisit=False),
                            plain(w, bias, "gelu", natural=True)),
                "resident": ("skinny_kinner",
                             lambda: gen._skinny_kinner(
                                 x, wp, bias, bk=bk, bn=bn, act="relu",
                                 natural=False, resident=True, revisit=False),
                             plain(wp, bias, "relu")),
                "split_epi": ("skinny_kinner",
                              lambda: gen._skinny_kinner(
                                  x, wp, None, bk=bk, bn=bn, act=None,
                                  natural=False, resident=False,
                                  revisit=False),
                              plain(wp, None, None)),
                "revisit": ("skinny_kinner",
                            lambda: gen._skinny_kinner(
                                x, wp, None, bk=bk, bn=bn, act=None,
                                natural=False, resident=False, revisit=True),
                            lambda: tsmm._torch_skinny(
                                x, wp, None, None, natural=False, splits=1,
                                mode=tsmm.RAW_F32)[0]),
            }
            for sp in (2, 4):
                modes[f"ksplit{sp}"] = (
                    "skinny_ksplit",
                    lambda sp=sp: gen._skinny_ksplit(
                        x, wp, bk=bk, bn=bn, splits=sp, natural=False,
                        resident=False),
                    plain(wp, None, None, splits=sp, mode=tsmm.RAW_F32))
            iters = 3 if m * n >= 256 * 6912 else 5
            for mode, (name, kern, plainf) in modes.items():
                with Designs() as d:
                    got = kern()
                want = plainf()
                torch.cuda.synchronize()
                ok, err = within(got, want, **F32_TOL)
                design = design_of(d.ran)
                if not ok or f"skinny_{design}" not in FP32_SKINNY_DESIGNS:
                    raise AssertionError(
                        f"{name}/{mode} fp32 m={m} K={k} N={n} ({design}): "
                        f"max |err| {err} outside {F32_TOL}")
                worst[f"{name}.fp32"] = max(worst.get(f"{name}.fp32", 0.0),
                                            err)
                splits = int(mode[6:]) if mode.startswith("ksplit") else 1
                lp = tsmm.skinny_plan(
                    m, k, n, dtype=torch.float32, natural=mode == "natural",
                    bk=bk, bn=bn, mode=tsmm.RAW_F32 if splits > 1
                    else tsmm.EPILOGUE, splits=splits, kps=k // splits,
                    sms=torch.cuda.get_device_properties(0)
                    .multi_processor_count)
                # each input read once (fp32 X, W, bias), the output written
                # once (fp32 sums, or the partial slabs)
                moved = 4 * (m * k + k * n + n) + got.numel() * 4
                t_ops = 2 * m * k * n / peak_rate(lp, "float32", H100)
                t_bytes = moved / HBM_BYTES_PER_S
                cases.append({
                    "kernel": name, "mode": mode, "dtype": "float32",
                    "design": design, "launch_plan": dataclasses.asdict(lp),
                    "m": m, "K": k, "N": n, "max_abs_err": err,
                    "tol": F32_TOL, "ms": timer(kern, iters=iters),
                    "device_ms": timer(kern, iters=iters, device=True),
                    "plain_ms": timer(plainf, iters=iters),
                    "library_ms": timer(lambda: torch.matmul(x, w),
                                        iters=iters),
                    "bound_ms": 1e3 * max(t_ops, t_bytes),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bound_ms_fma": 1e3 * max(
                        t_bytes, 2 * m * k * n / H100.peak_flops("float32"))})
                del got, want
            del x
        del w, wp, bias
        torch.cuda.empty_cache()
    return cases


GLM_KV = (2048, 4096, 256)     # GLM-4-9B's wk/wv at a 2048-token prefill


def tall_cases(timer, g, worst):
    """Every tall mode at GLM-4-9B's K/V projection at prefill, (m, K, N)
    = (2048, 4096, 256), bf16, with its bias: each against its plain
    version on the same inputs."""
    import torch
    from repro_torch.kernels import gen, tsmm

    bf = torch.bfloat16
    m, k, n = GLM_KV
    bk, pbm = 128, 256
    a = torch.randn((m, k), generator=g, device="cuda").to(bf)
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(bf)
    bias = (0.1 * torch.randn((n,), generator=g, device="cuda")).to(bf)
    ap = tsmm.pack_blocks_kernel(a, pbm, bk)

    def plain(x, mode, bias=None, splits=1):
        return tsmm._torch_tall(x, w, bias, None, mode=mode, splits=splits,
                                k0=0, k1=k, out=None)

    def plain_kouter():
        acc = torch.zeros((m, n), dtype=torch.float32, device="cuda")
        for k0 in range(0, k, bk):
            tsmm._torch_tall(a, w, None, None, mode=tsmm.ACCUM_F32, splits=1,
                             k0=k0, k1=k0 + bk, out=acc)
        return acc

    def plain_revisit():
        return tsmm._torch_tall(
            a, w, bias, None, mode=tsmm.ACCUM_F32, splits=1, k0=0, k1=k,
            out=torch.zeros((m, n), dtype=torch.float32, device="cuda"))

    modes = {
        # name: (kernel counter, kernel call, plain call, tol)
        "baseline": ("tsmm_tall_a",
                     lambda: tsmm.tsmm_tall_a(a, w, bias, bm=m, bk=bk),
                     lambda: plain(a, tsmm.EPILOGUE, bias), BF16_TOL),
        "packed": ("tsmm_packed_a",
                   lambda: tsmm.tsmm_packed_a(ap, w, bias),
                   lambda: plain(ap, tsmm.EPILOGUE, bias), BF16_TOL),
        "resident": ("tall_kinner",
                     lambda: gen._tall_kinner(
                         a, w, bias, bm=m, bk=bk, act=None, packed=False,
                         resident=True, revisit=False),
                     lambda: plain(a, tsmm.EPILOGUE, bias), BF16_TOL),
        "revisit": ("tall_kinner",
                    lambda: gen._tall_kinner(
                        a, w, bias, bm=m, bk=bk, act=None, packed=False,
                        resident=False, revisit=True),
                    plain_revisit, F32_TOL),
        "ksplit2": ("tall_ksplit",
                    lambda: gen._tall_ksplit(a, w, bm=m, bk=bk, splits=2,
                                             packed=False, resident=False),
                    lambda: plain(a, tsmm.RAW_F32, splits=2), F32_TOL),
        "kouter": ("tall_kouter",
                   lambda: gen._tall_kouter(a, w, bm=m, bk=bk, packed=False),
                   plain_kouter, F32_TOL),
    }
    cases = []
    for mode, (name, kern, plainf, tol) in modes.items():
        with Designs() as d:
            got = kern()
        want = plainf()
        torch.cuda.synchronize()
        ok, err = within(got, want, **tol)
        if not ok:
            raise AssertionError(f"{name}/{mode} {GLM_KV}: max |err| {err} "
                                 f"outside {tol}")
        worst[name] = max(worst.get(name, 0.0), err)
        # each input read once (bf16 A, B, bias), the output written once
        # (bf16, or the fp32 sums / partial slabs)
        bound_ms, bound_by = bound(
            2 * (m * k + k * n + n) + got.numel() * got.element_size(),
            2 * m * k * n)
        cases.append({"kernel": name, "mode": mode, "design": design_of(d.ran),
                      "m": m, "K": k, "N": n,
                      "max_abs_err": err, "tol": tol, "ms": timer(kern),
                      "device_ms": timer(kern, device=True),
                      "plain_ms": timer(plainf),
                      "library_ms": timer(lambda: torch.matmul(a, w)),
                      "bound_ms": bound_ms, "bound_by": bound_by})
        del got, want
    return cases


# the pack's three shapes on GLM-4-9B's path, bf16, (L, M, K, bm, bk): its
# prefill activations for a packed tall plan, the per-call decode pack of
# its unpacked wk/wv, and its largest layer-stacked leaf at load at the
# blocks prepack_for gives it (the serve.glm4 path checks it against
# eng.pack_report); and DeepSeek-V2's largest layer-stacked leaf at load,
# MLA's wo (16384, 5120) on the 2 MoE layers of its serve path (the
# serve.deepseek path checks it)
PACK_SHAPES = {"prefill": (1, 2048, 4096, 256, 128),
               "decode": (1, 4096, 256, 256, 128),
               "load": (40, 4096, 13696, 128, 128),
               "load.deepseek": (2, 16384, 5120, 16384, 128)}


def pack_cases(timer, g, worst):
    """The pack kernel at ``PACK_SHAPES``, bit-equal to its plain version
    on the same inputs, with the design that ran it."""
    import torch
    from repro_torch.kernels import ref, tsmm

    cases = []
    for mode, (L, m, k, bm, bk) in PACK_SHAPES.items():
        a = torch.randn((L, m, k) if L > 1 else (m, k), generator=g,
                        device="cuda").to(torch.bfloat16)
        with Designs() as d:
            got = tsmm.pack_blocks_kernel(a, bm, bk)
        want = ref.pack_ref(a, bm, bk)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pack_blocks/{mode} {(L, m, k)} by "
                                 f"({bm}, {bk}): not bit-equal to pack_ref")
        del got, want
        worst["pack_blocks"] = 0.0          # bit-equal

        def kern():
            return tsmm.pack_blocks_kernel(a, bm, bk)

        def plain():
            return ref.pack_ref(a, bm, bk)

        def lib():
            # one PyTorch copy computes the same re-tile (the shapes divide
            # the blocks)
            return (a.unflatten(-2, (m // bm, bm)).unflatten(-1, (k // bk, bk))
                    .transpose(-3, -2).contiguous())

        # read once, written once (no padding at these shapes)
        bound_ms, bound_by = bound(2 * 2 * L * m * k, 0)
        iters = 3 if L > 1 else 5
        cases.append({"kernel": "pack_blocks", "mode": mode,
                      "design": design_of(d.ran), "L": L, "M": m, "K": k,
                      "bm": bm, "bk": bk, "max_abs_err": 0.0,
                      "tol": "bit-equal", "ms": timer(kern, iters=iters),
                      "device_ms": timer(kern, iters=iters, device=True),
                      "plain_ms": timer(plain, iters=iters),
                      "library_ms": timer(lib, iters=iters),
                      "bound_ms": bound_ms, "bound_by": bound_by})
        del a
        torch.cuda.empty_cache()
    return cases


def phase_tall(timer):
    """``tsmm_dot`` through an explicit plan of every tall family at
    GLM-4-9B's wk shape; each result against the plain product, each
    family's counter must rise."""
    import torch
    from repro_torch.core.plan import Plan, Problem
    from repro_torch.core.tsmm import tsmm_dot
    from repro_torch.kernels import cuda, ref, tsmm
    from repro_torch.kernels.variants import KernelSpec

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    _, k, n = GLM_KV
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(bf)
    bias = (0.1 * torch.randn((n,), generator=g, device="cuda")).to(bf)
    families = {
        # family: (plan fields, counters that must rise)
        "baseline": (dict(prepack=False), ("tsmm_tall_a",)),
        "baseline_prepack": (dict(prepack=True),
                             ("pack_blocks", "tsmm_packed_a")),
        "b_resident": (dict(prepack=False,
                            kernel=KernelSpec.make("b_resident")),
                       ("tall_kinner",)),
        "revisit": (dict(prepack=False,
                         kernel=KernelSpec.make("gen", acc="revisit")),
                    ("tall_kinner",)),
        "ksplit": (dict(prepack=False,
                        kernel=KernelSpec.make("ksplit", splits=2)),
                   ("tall_ksplit",)),
        "kmajor": (dict(prepack=False, kernel=KernelSpec.make("kmajor")),
                   ("tall_kouter",)),
    }
    counts = {}
    for m in (2048, 4096, 8192):
        a = torch.randn((m, k), generator=g, device="cuda").to(bf)
        want = ref.tsmm_ref(a, w, bias=bias)
        # the wgmma launch plan of a one-launch epilogue at this m
        epi_plan = tsmm.tall_plan(
            m, k, n, dtype=bf, packed=False, pbm=0, pbk=0,
            mode=tsmm.EPILOGUE, splits=1, kps=k,
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
        for fam, (fields, names) in families.items():
            plan = Plan(Problem(m, k, n, "bfloat16"), "tall_a", bm=256,
                        bk=128, bn=n, **fields)
            cuda.reset_launches()
            got = tsmm_dot(a, w, bias=bias, plan=plan)
            rose = {c: cuda.launches[c] for c in names}
            designs = dict(cuda.design_launches)
            torch.cuda.synchronize()
            ok, err = within(got, want, **BF16_TOL)
            ms = timer(lambda: tsmm_dot(a, w, bias=bias, plan=plan), iters=3)
            emit({"phase": "tall", "family": fam, "m": m, "K": k, "N": n,
                  "kernel": plan.kernel.key(), "prepack": plan.prepack,
                  "epilogue_plan": dataclasses.asdict(epi_plan),
                  "launches": rose, "design_launches": designs,
                  "max_abs_err": err, "tol": BF16_TOL, "ms": ms})
            if not ok or got.shape != (m, n) or got.dtype != bf:
                raise AssertionError(f"tall {fam} m={m}: max |err| {err} "
                                     f"outside {BF16_TOL}")
            tall_n = sum(v for c, v in rose.items() if c in TALL)
            tall_designs = {k: v for k, v in designs.items()
                            if not k.startswith("pack_")}
            if tall_designs != {"tall_wgmma": tall_n}:
                raise AssertionError(f"tall {fam} m={m}: designs {designs}, "
                                     f"{tall_n} tall launches")
            check_pack(f"tall {fam} m={m}", rose, designs)
            if not all(rose.values()):
                raise AssertionError(f"tall {fam} m={m}: no launch of "
                                     f"{[c for c, v in rose.items() if not v]}")
            for c, v in rose.items():
                counts[c] = counts.get(c, 0) + v
        del a, want
    return counts


# the install phase's sweeps: (arch, largest batch bucket, largest prompt
# bucket), the shapes the serve phases then serve
INSTALL = (("qwen1_5_4b", 4, 256), ("glm4_9b", 2, 2048),
           ("olmoe_1b_7b", 4, 256), ("deepseek_v2_236b", 2, 512),
           ("mamba2_780m", 4, 256), ("zamba2_2_7b", 2, 2048),
           ("h2o_danube_1_8b", 2, 4352), ("llava_next_mistral_7b", 2, 192),
           ("whisper_base", 4, 256), ("llama3_405b", 2, 512))
# GLM-4-9B's K/V projection at its two prefill token counts
GLM_KV_PREFILL = ((2048, 4096, 256), (4096, 4096, 256))


def phase_install():
    """``repro_torch.core.install`` as a user runs it, on the card:
    ``--measure`` per model, ``--calibrate``, ``--check``.  Returns the
    phase's launch counts."""
    import torch
    from repro_torch.core import install, registry
    from repro_torch.core.autotuner import candidate_blocks, dedupe_short_list
    from repro_torch.core.evaluator import measure_plan
    from repro_torch.core.hw import for_device
    from repro_torch.core.plan import Problem
    from repro_torch.core.smem_model import launch_key
    from repro_torch.kernels import cuda
    from repro_torch.launch.calibration_quality import rank_quality

    hw = for_device("cuda")
    cuda.reset_launches()
    t0 = time.perf_counter()
    per_model, by_arch = {}, {}
    for arch, max_batch, max_prompt in INSTALL:
        argv = ["--archs", arch, "--max-batch", str(max_batch),
                "--max-prompt", str(max_prompt), "--device", "cuda"]
        before = {id(r) for r in registry.measurements("cuda")}
        res = install.main(argv + ["--measure"])
        by_arch[arch] = [r for r in registry.measurements("cuda")
                         if id(r) not in before]
        per_model[arch] = {"plans": res["plans"],
                           "records": len(by_arch[arch]),
                           "seconds": res["seconds"][arch], "argv": argv}
    measure_s = time.perf_counter() - t0
    records = registry.measurements("cuda")
    bad = [r for r in records if r.impl != "cuda"]
    if not records or bad:
        raise AssertionError(f"install: {len(records)} records, {len(bad)} "
                             f"not timed on the cuda path")
    # every record's candidate passed parity_check before it was timed (a
    # failure raises out of the sweep); each problem times each of its
    # launches once
    by_problem = {}
    for r in records:
        by_problem.setdefault(r.plan.problem.key(), []).append(r)
    launches_timed = {(pk, launch_key(r.plan, hw))
                      for pk, rs in by_problem.items() for r in rs}
    if len(launches_timed) != len(records):
        raise AssertionError(f"install: {len(records)} records for "
                             f"{len(launches_timed)} distinct launches")
    for arch, recs in by_arch.items():
        emit({"phase": "install.records", "arch": arch, "records": [
            {"problem": r.plan.problem.key(), "kernel": r.plan.kernel.key(),
             "schedule": r.plan.schedule.key(),
             "blocks": [r.plan.bm, r.plan.bk, r.plan.bn],
             "prepack": r.plan.prepack, "ms": r.seconds * 1e3,
             "dispersion": r.dispersion, "model_ms": r.plan.score * 1e3}
            for r in recs]})

    t1 = time.perf_counter()
    hw_cal = None
    for arch, _, _ in INSTALL:
        hw_cal = install.main(per_model[arch]["argv"] + ["--calibrate"])["hw"]
    calibrate_s = time.perf_counter() - t1
    if not hw_cal.calibrated:
        raise AssertionError("install --calibrate fitted nothing")

    # mean per-problem Spearman of the model against the measurements
    _, rho0 = rank_quality(list(by_problem.items()), hw)
    _, rho1 = rank_quality(list(by_problem.items()), hw_cal)

    # GLM-4-9B's K/V at prefill: the model's pick (nominal spec) against
    # the tournament's winner, each with its time
    kv = []
    for m, k, n in GLM_KV_PREFILL:
        prob = Problem(m, k, n, "bfloat16")
        pick = dedupe_short_list(candidate_blocks(prob, hw), hw)[0]
        pick_key = launch_key(pick, hw)
        rec = next((r for r in by_problem.get(prob.key(), [])
                    if launch_key(r.plan, hw) == pick_key), None)
        if rec is None:
            rec = measure_plan(pick, "cuda", source="chip_smoke")
        won = registry.peek(prob.key(), "cuda")
        if won is None or won.chosen_by != "measured":
            raise AssertionError(f"install: no measured plan for {prob}")
        kv.append({"problem": prob.key(), "model_pick": str(pick),
                   "model_pick_ms": rec.seconds * 1e3,
                   "measured_winner": str(won), "winner_ms": won.score * 1e3,
                   "winner_launches": repr(launch_key(won, hw))})

    t2 = time.perf_counter()
    checks = {}
    for arch, _, _ in INSTALL:
        checks[arch] = install.main(per_model[arch]["argv"] + ["--check"])
    check_s = time.perf_counter() - t2
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    designs = dict(cuda.design_launches)
    absent = [k for k in (*SKINNY, *TALL, "pack_blocks")
              if not launches.get(k)]
    emit({"phase": "install", "seconds": time.perf_counter() - t0,
          "measure_s": measure_s, "calibrate_s": calibrate_s,
          "check_s": check_s, "models": per_model,
          "problems": len(by_problem), "records": len(records),
          "distinct_launches_timed": len(launches_timed),
          "hbm_efficiency": hw_cal.hbm_efficiency,
          "mxu_efficiency": hw_cal.mxu_efficiency,
          "grid_overhead_s": hw_cal.grid_overhead_s,
          "spearman_per_problem_before": rho0,
          "spearman_per_problem_after": rho1, "glm_kv": kv,
          "check": {a: {"stats": c["stats"], "grammar": c["grammar"]}
                    for a, c in checks.items()},
          "launches": launches, "design_launches": designs})
    if absent:
        raise AssertionError(f"install: no launch of {absent}")
    FP32_PATHS["install"] = {"designs": {k: v for k, v in designs.items()
                                         if k in FP32_SKINNY_DESIGNS}}
    return launches


def phase_gate():
    """The calibration gate on the card: ``launch/calibration_quality.py``
    as its tool runs it (its own plan and measurement cache), whose assert
    must hold: the calibrated model ranks the gate problems' short lists
    better than the data-sheet model.  A failure raises out of the run."""
    from repro_torch.core import registry
    from repro_torch.launch import calibration_quality
    # the tool's miss-path demo swaps the cache paths and clears the
    # in-memory registry when it is done: the install phase's plans and
    # measurements must be on disk first
    registry.flush()
    t0 = time.perf_counter()
    with Designs() as d:
        blob = calibration_quality.run(
            device="cuda",
            json_path=os.path.join(ROOT, "build", "bench",
                                   "calibration_quality.json"))
    FP32_PATHS["gate"] = {"designs": {k: v for k, v in d.ran.items()
                                      if k in FP32_SKINNY_DESIGNS}}
    emit({"phase": "gate", "seconds": time.perf_counter() - t0,
          "design_launches": d.ran, **blob["rows"]})


def phase_paper(timer):
    """The paper's experiment (its Figs. 5-7) at its full size,
    ``PAPER_WORKLOAD``: A 25600 x 25600 fp32 made on the card from a
    seeded generator, N over the sweep, 200 reuses.  Per N the
    conventional, pre-pack and planned rows of
    ``launch/prepack_vs_conventional.py`` (the planned row: the
    tournament's pack-once plan, A packed once, its tall kernel replayed
    200 times; its output held to ``torch.matmul``) and the pack share.
    Then, outside the path's counts, the pack of one A at the paper's
    blocks (2.62 GB: past 2^31 bytes) against ``pack_ref`` bit for bit,
    with its times.  Returns the path's launch counts, the rows and the
    pack case; frees its memory."""
    import torch
    from repro_torch.configs.tsmm_paper import PAPER_WORKLOAD
    from repro_torch.kernels import cuda, ref
    from repro_torch.launch import prepack_vs_conventional as pvc

    t0 = time.perf_counter()
    cuda.reset_launches()
    rows = []
    for row in pvc.sweep(PAPER_WORKLOAD, "cuda", iters=3, top_k=3):
        rows.append(row)
        emit({"phase": "paper", **row})
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    designs = dict(cuda.design_launches)
    torch.cuda.empty_cache()
    emit({"phase": "paper", "seconds": time.perf_counter() - t0,
          "M": PAPER_WORKLOAD.M, "K": PAPER_WORKLOAD.K,
          "n_sweep": list(PAPER_WORKLOAD.n_sweep),
          "repeats": PAPER_WORKLOAD.repeats, "launches": launches,
          "design_launches": designs})
    if [r["n"] for r in rows] != list(PAPER_WORKLOAD.n_sweep):
        raise AssertionError(f"paper: rows for {[r['n'] for r in rows]}")
    tall = sum(launches.get(k, 0) for k in TALL)
    ran = {k: v for k, v in designs.items() if not k.startswith("pack_")}
    if (not tall or set(ran) - FP32_TALL_DESIGNS
            or sum(ran.values()) != tall):
        raise AssertionError(f"paper: {tall} tall launches ran {designs}, "
                             f"not every one on the fp32 designs "
                             f"{sorted(FP32_TALL_DESIGNS)}")
    check_pack("paper", launches, designs)
    if not launches.get("pack_blocks"):
        raise AssertionError("paper: no pack launch")

    m, k, blk = PAPER_WORKLOAD.M, PAPER_WORKLOAD.K, pvc.PACK_BLOCK
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((m, k), generator=g, device="cuda")
    kern = pvc.pack_fn(a)
    with Designs() as d:
        got = kern()
    if not torch.equal(got, ref.pack_ref(a, blk, blk)) or \
            not torch.equal(ref.unpack_ref(got, m, k), a):
        raise AssertionError(f"pack_blocks ({m}, {k}) fp32 by ({blk}, {blk}): "
                             f"not bit-equal to pack_ref / unpack_ref")
    del got
    torch.cuda.empty_cache()

    def lib():
        return (a.unflatten(0, (m // blk, blk)).unflatten(-1, (k // blk, blk))
                .transpose(1, 2).contiguous())

    bound_ms, bound_by = bound(2 * 4 * m * k, 0)
    pack = {"kernel": "pack_blocks", "mode": "paper",
            "design": design_of(d.ran), "M": m, "K": k, "bm": blk, "bk": blk, "dtype": "float32",
            "max_abs_err": 0.0, "tol": "bit-equal",
            "ms": timer(kern, iters=3), "device_ms": timer(kern, iters=3,
                                                           device=True),
            "plain_ms": timer(lambda: ref.pack_ref(a, blk, blk), iters=3),
            "library_ms": timer(lib, iters=3),
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "paper.pack", **pack})
    del a
    torch.cuda.empty_cache()
    return launches, designs, rows, pack


# the paper's N at which the kernels line shows the fp32 tall designs
PAPER_FP32_N = (4, 32, 128, 240)


def set_pack_shapes():
    """Point ``PACK_SHAPES``' load and decode cases at the layouts the
    installed plans give GLM-4-9B: its largest layer-stacked leaf (w_gate,
    (4096, 13696), at the blocks ``prepack_for`` picks) and the per-call
    pack of its K/V weight at decode batch 1 (where its plan packs); and
    the DeepSeek-V2 load case at the blocks its wo is packed in."""
    from repro_torch.core import registry
    from repro_torch.core.plan import Problem
    from repro_torch.core.tsmm import prepack_blocks
    for case, (L, k, n), what in (
            ("load", (40, 4096, 13696), "GLM-4-9B's w_gate"),
            ("load.deepseek", (2, 16384, 5120), "DeepSeek-V2's wo")):
        blocks = prepack_blocks((1, 2), k, n, "bfloat16", device="cuda")
        if blocks is None:
            raise AssertionError(f"{what} would stay unpacked")
        PACK_SHAPES[case] = (L, k, n, *blocks)
    plan = registry.peek(Problem(1, 4096, 256, "bfloat16").key(), "cuda")
    if plan is not None and packs_per_call(plan):
        PACK_SHAPES["decode"] = (1, 4096, 256, plan.bk, plan.bn)


# llama3-405b's reduced config (2 layers, vocab 512, rope theta 500000)
# widened so every leaf reaches 512 and packs
LLAMA3_PARITY = dict(d_model=1024, num_heads=8, num_kv_heads=4,
                     head_dim=128, d_ff=2048, dtype="float32")
# the GLM-shaped parity config of tests/test_torch_glm4.py (2 layers,
# vocab 512): wk/wv are (1024, 256), so a 2 x 1024-token prefill takes the
# tall-A path
GLM_PARITY = dict(d_model=1024, num_heads=8, num_kv_heads=2, head_dim=128,
                  d_ff=2048, dtype="float32")


def phase_parity(cfg, batch, prompt_len, cut=None):
    """``cfg`` (2 layers, fp32): card (kernels) vs CPU (plain versions) on
    the same packed weights and the same token stream; ``cut`` names how
    ``cfg`` departs from the published config, printed on the line.
    Returns the card run's launch counts."""
    import torch
    from repro_torch.core.linear import serving_ctx
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import make_group
    from repro_torch.models.param import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import pack_tree_for_serving

    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(0))
    packed, report = pack_tree_for_serving(params, axes, (batch,))
    del params
    prompt = ((torch.arange(batch * prompt_len) * 7 + 3)
              % cfg.vocab_size).to(torch.int32).reshape(batch, prompt_len)
    # the model's other inputs (a VLM's image embeddings, an
    # encoder-decoder's frames): seeded, bf16, made once on the host
    inputs = {**make_group(cfg, batch, prompt_len, "cpu", seed=1),
              "tokens": prompt}
    image = cfg.num_image_tokens if cfg.embeds_input else 0
    steps, max_len = 4, image + prompt_len + 8

    def run(params, device, feed=None):
        out, toks = [], []
        with torch.inference_mode(), serving_ctx():
            cache = model.init_cache(batch, max_len, device)
            logits, cache = model.prefill(
                params, {k: v.to(device) for k, v in inputs.items()}, cache)
            out.append(logits[:, -1].float().cpu())
            for i in range(steps):
                tok = (feed[i] if feed is not None
                       else out[-1].argmax(dim=-1).to(torch.int32)[:, None])
                toks.append(tok)
                logits, cache = model.decode_step(params, cache,
                                                  tok.to(device))
                out.append(logits[:, -1].float().cpu())
        return out, toks

    t0 = time.perf_counter()
    ref, toks = run(packed, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    gpu_params = tree_map(lambda t: t.to("cuda"), packed)
    cuda.reset_launches()
    t0 = time.perf_counter()
    got, _ = run(gpu_params, torch.device("cuda"), feed=toks)
    gpu_s = time.perf_counter() - t0
    launches = dict(cuda.launches)
    designs = dict(cuda.design_launches)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scale = max(1.0, max(float(r.abs().max()) for r in ref))
    tol = PARITY_RTOL * scale
    emit({"phase": "parity", "config": cfg.name, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
          "capacity_factor": cfg.capacity_factor, "mla": cfg.use_mla,
          "cut": cut, "layers": cfg.num_layers, "dtype": cfg.dtype,
          "sliding_window": cfg.sliding_window, "image_tokens": image,
          "encoder_layers": cfg.encoder_layers if cfg.is_encoder_decoder
          else 0, "encoder_seq": cfg.encoder_seq if cfg.is_encoder_decoder
          else 0, "batch": batch,
          "prompt": prompt_len, "decode_steps": steps,
          "packed_leaves": len(report), "max_abs_err_per_step": errs,
          "tol": tol, "tol_rule": f"{PARITY_RTOL} * max(1, max|logit|)",
          "cpu_s": cpu_s, "gpu_s": gpu_s, "launches": launches,
          "design_launches": designs})
    check_fp32(f"parity.{cfg.name}", launches, designs)
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"parity {cfg.name}: non-finite logits on the "
                             f"card")
    if max(errs) > tol:
        raise AssertionError(f"parity {cfg.name}: max |err| {max(errs)} > "
                             f"{tol}")
    return launches


def check_group(res, b, steps, vocab):
    """A served group's tokens: (b, steps) in the vocabulary, finite
    logits.  Returns the tokens."""
    import torch
    toks = res.tokens
    if (toks.shape != (b, steps) or not torch.isfinite(res.logits_last).all()
            or int(toks.min()) < 0 or int(toks.max()) >= vocab):
        raise AssertionError(f"serve b={b}: bad output {tuple(toks.shape)}")
    return toks


def phase_serve(path: str) -> tuple:
    """One model through ``Engine`` on the card (bf16, seeded random
    weights on a CUDA generator, at the widths and depth of
    ``SERVE[path]``): its grid captured at load, every group served
    eagerly and then graphed (bit-equal, equal launches), 0 registry
    misses and 0 cells captured by traffic; the baseline skinny-A kernel
    and the kernel of every variant the install stamped must launch, and
    flash exactly where the model's attention takes it; then the path's
    own checks (``SERVE[path]["hooks"]``) and the profile of a decode
    step.  Returns (the graphed groups' launches, the load's launches)."""
    import gc
    from collections import Counter

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import make_group
    from repro_torch.models.registry import (active_param_count,
                                             build_model, param_count)
    from repro_torch.serve.engine import Engine

    spec = SERVE[path]
    hooks = spec["hooks"]
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(spec["arch"]), **spec["cut"])
    model = build_model(cfg)
    prompt, steps = spec["prompt"], spec["steps"]
    prompts = spec.get("prompts", (prompt,))
    image = cfg.num_image_tokens if cfg.embeds_input else 0
    cuda.reset_launches()
    registry.reset_stats()
    t0 = time.perf_counter()
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = Engine(model, params, axes,
                 max_len=image + max(prompts) + steps + 8,
                 max_batch=spec["max_batch"], max_prompt=max(prompts),
                 min_prompt=spec.get("min_prompt", 8), device="cuda")
    del params
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_launches = dict(cuda.launches)
    load_designs = dict(cuda.design_launches)
    emit({"phase": f"{path}.load", "config": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "cut": spec["cut"] or None,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "experts": cfg.num_experts,
          "shared_experts": cfg.num_shared_experts,
          "top_k": cfg.experts_per_token,
          "first_k_dense": cfg.first_k_dense, "mla": cfg.use_mla,
          "ssm_state": cfg.ssm_state, "attn_every": cfg.attn_every,
          "sliding_window": cfg.sliding_window, "image_tokens": image,
          "encoder_layers": cfg.encoder_layers, "encoder_seq":
          cfg.encoder_seq if cfg.is_encoder_decoder else 0,
          "vocab": cfg.vocab_size, "prompts": prompts,
          "length_buckets": eng.grid.length,
          "dtype": cfg.dtype, "packed_leaves": len(eng.pack_report),
          "param_count": param_count(model),
          "active_param_count": active_param_count(model),
          "pack_report": eng.pack_report, "buckets": eng.buckets,
          "variants": dict(sorted(Counter(
              eng.variant_report().values()).items())),
          "schedules": dict(sorted(Counter(
              eng.schedule_report().values()).items())),
          "registry": registry.stats(), "load_s": load_s,
          "load_launches": load_launches, "load_designs": load_designs,
          "mem_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    check_pack(f"{path}.load", load_launches, load_designs)
    if "load" in hooks:
        hooks["load"](path, eng, cfg, load_launches)

    # each group size at each prompt length, in that order; a VLM's image
    # embeddings and an encoder-decoder's frames seeded
    groups = {(b, p): make_group(cfg, b, p, "cuda", seed=0)
              for p in prompts for b in spec["groups"]}
    base, pre = serve_both(eng, groups, steps, path)
    first = {}
    for (b, p), (want, got) in base.items():
        toks = check_group(got, b, steps, cfg.vocab_size)
        first.setdefault(p, []).append(toks[0].tolist())
        extra = (hooks["group"](path, eng, cfg, b, got) if "group" in hooks
                 else {})
        emit({"phase": path, "group": b, "prompt": p, "buckets": got.buckets,
              "prefill_s": got.prefill_s, "per_token_s": got.per_token_s,
              "eager_prefill_s": want.prefill_s,
              "eager_per_token_s": want.per_token_s,
              "compile_s": got.compile_s, "bit_equal_to_eager": True,
              "degradations": eng.degrade.total,
              **extra, "tokens[0]": toks[0].tolist()})
    launches = dict(cuda.launches)
    designs = dict(cuda.design_launches)
    EPILOGUES[path] = dict(cuda.epilogue_launches)
    stats = registry.stats()
    # the baseline (prefills past the buckets) and the kernel of every
    # variant the install stamped; flash where the attention takes it
    need = {"tsmm_skinny_a"} | {skinny_counter(v)
                                for v in eng.variant_report().values()}
    extra, more = (hooks["path"](path, eng, cfg, launches) if "path" in hooks
                   else ({}, set()))
    emit({"phase": f"{path}.launches", "launches": launches,
          "design_launches": designs, "epilogue_launches": EPILOGUES[path],
          "registry": stats,
          "decode_cell_launches": dict(cell_launches(eng, "decode")),
          "tokens0_equal_across_groups": all(
              t == ts[0] for ts in first.values() for t in ts),
          **extra})
    check_programs(path, eng, pre)
    if stats["misses"]:
        raise AssertionError(f"{path}: {stats['misses']} registry misses "
                             f"after the install sweep")
    check_wgmma(path, launches, designs)
    check_pack(path, launches, designs)
    if spec["flash"]:
        need.add("flash_attention")
    elif launches.get("flash_attention", 0):
        raise AssertionError(f"{path}: the flash kernel launched "
                             f"{launches['flash_attention']} times on a "
                             f"path whose attention it does not take")
    missing = sorted(k for k in need | more if launches.get(k, 0) == 0)
    if missing:
        raise AssertionError(f"{path} launched no {missing}")
    profile(path, eng, make_group(cfg, spec["profile_batch"], prompt, "cuda",
                                  seed=0), steps=4)
    if "after" in hooks:
        hooks["after"](path, eng, cfg, base)
    check_healthy(path, eng)
    emit({"phase": f"{path}.seconds", "seconds": time.perf_counter() - t_phase})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, load_launches


def check_healthy(path: str, eng) -> None:
    """The ``.health`` line: the engine's ``health_report()`` must be
    healthy, with 0 degradations and no armed failpoint."""
    hr = eng.health_report()
    emit({"phase": f"{path}.health", "healthy": hr["healthy"],
          "degradations": hr["degradations"]["total"],
          "by_seam": hr["degradations"]["by_seam"],
          "failpoints": hr["failpoints"]})
    if not hr["healthy"] or hr["failpoints"]:
        raise AssertionError(f"{path}: the engine degraded: {hr}")


def serve_both(eng, groups: dict, steps: int, path: str) -> tuple:
    """Capture ``eng``'s grid at load, serve every group eagerly (an eager
    store of the same model) and then graphed, the main path: the launch
    counts are zeroed just before the graphed groups and read by the
    caller just after them.  Raises unless every graphed group's tokens
    and last logits are bit-equal to its eager run's and both runs'
    launch counts are equal.  Returns ({b: (eager result, graphed
    result)}, the precompile's rows, seconds and store stats)."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.serve.programs import ProgramStore
    t0 = time.perf_counter()
    rows = eng.precompile()
    torch.cuda.synchronize()
    pre = {"rows": rows, "seconds": time.perf_counter() - t0,
           "loaded": eng.programs.stats()}
    graphed = eng.programs
    eng.programs = ProgramStore(eng.model, device=eng.device, capture=False)
    out = {}
    cuda.reset_launches()
    try:
        for b, batch in groups.items():
            out[b] = [eng.generate(batch, steps)]
    finally:
        eng.programs = graphed
    torch.cuda.synchronize()
    eager_counts = (dict(cuda.launches), dict(cuda.design_launches),
                    dict(cuda.epilogue_launches))
    cuda.reset_launches()
    for b, batch in groups.items():
        out[b].append(eng.generate(batch, steps))
    torch.cuda.synchronize()
    counts = (dict(cuda.launches), dict(cuda.design_launches),
              dict(cuda.epilogue_launches))
    for b, (want, got) in out.items():
        if not (torch.equal(got.tokens, want.tokens)
                and torch.equal(got.logits_last, want.logits_last)):
            raise AssertionError(f"{path} b={b}: the graphed tokens or "
                                 f"logits differ from the eager run's")
    if counts != eager_counts:
        raise AssertionError(f"{path}: launches under replay {counts} differ "
                             f"from the eager run's {eager_counts}")
    return {b: tuple(v) for b, v in out.items()}, pre


def check_programs(path: str, eng, pre: dict) -> None:
    """The ``programs`` line: the cells captured at load, their capture
    seconds, the shared pool's bytes, and the cells traffic captured
    (must be 0)."""
    from collections import Counter
    st = eng.programs.stats()
    loaded = pre["loaded"]
    traffic = ((st["captured"] + st["eager"])
               - (loaded["captured"] + loaded["eager"]))
    emit({"phase": "programs", "path": path, "cells": len(pre["rows"]),
          "kinds": dict(Counter(r["kind"] + ("+pad" if r["pad"] else "")
                                for r in pre["rows"])),
          "captured": loaded["captured"], "capture_s": loaded["capture_s"],
          "precompile_s": pre["seconds"], "pool_bytes": st["pool_bytes"],
          "captured_by_traffic": traffic, "reused": st["reused"],
          "slowest_cells": sorted(
              ({k: r[k] for k in ("kind", "bucket", "tokens", "pad",
                                  "compile_s")} for r in pre["rows"]),
              key=lambda r: -r["compile_s"])[:3]})
    if traffic or loaded["captured"] != len(pre["rows"]):
        raise AssertionError(f"{path}: {loaded['captured']} of "
                             f"{len(pre['rows'])} cells captured at load, "
                             f"{traffic} by traffic")


def profile(path: str, eng, batch: dict, steps: int) -> None:
    """One ``profile`` line per mode: ``steps`` decode steps of ``batch``
    eagerly and as graph replays (``launch/profile_decode.py``)."""
    from repro_torch.launch.profile_decode import profile_steps
    for graphs in (False, True):
        summary, _ = profile_steps(eng, batch, steps=steps, graphs=graphs)
        emit({"phase": "profile", "path": path, **summary})


def skinny_counter(spec_key: str) -> str:
    """The launch counter a packed weight's stamped variant (its
    ``KernelSpec.key()``, e.g. ``gen[bres=resident]``) runs under."""
    from repro_torch.kernels.variants import from_kernel_spec, parse_spec
    from repro_torch.kernels.variants.grammar import BASELINE_POINT
    g = from_kernel_spec(parse_spec(spec_key.replace("[", ":").rstrip("]")))
    if g == BASELINE_POINT or g.packfuse:
        return "tsmm_skinny_a"
    return "skinny_ksplit" if g.ksplit > 1 else "skinny_kinner"


def packs_per_call(plan) -> bool:
    """Whether ``tsmm_dot`` packs an operand on every call of ``plan``: a
    packed tall A, or a natural skinny weight a non-fusing point packs."""
    if plan.orientation == "tall_a":
        return plan.prepack
    return not plan.prepack and not plan.gen_spec().packfuse


# the launch counters of the three skinny-A and the five tall-A kernels
SKINNY = ("tsmm_skinny_a", "skinny_kinner", "skinny_ksplit")
TALL = ("tsmm_tall_a", "tsmm_packed_a", "tall_kinner", "tall_ksplit",
        "tall_kouter")


def cell_launches(eng, kind: str, tokens: int = 0):
    """The launches of one call of each ``kind`` cell the engine's store
    holds (of ``tokens`` tokens, if given, without pad), summed: recorded
    at capture, a replay launches exactly these."""
    from collections import Counter
    out = Counter()
    for p in eng.programs.programs():
        if (p.kind == kind and (not tokens or p.tokens == tokens)
                and "pad" not in p.args[1]):
            out.update(p.launches)
    return out


def glm_load(path, eng, cfg, load_launches):
    """GLM-4-9B packs every leaf but its (4096, 256) wk / wv at load, and
    the kernels phase's load case is a largest layer-stacked leaf."""
    unpacked_kv = not any(p.endswith(("/wk", "/wv")) for p in eng.pack_report)
    if len(eng.pack_report) != 6 or not unpacked_kv:
        raise AssertionError(f"expected the 6 leaves other than wk/wv "
                             f"packed, got {sorted(eng.pack_report)}")
    if load_launches.get("pack_blocks", 0) == 0:
        raise AssertionError("no pack_blocks launch while packing at load")
    L, m, k, bm, bk = PACK_SHAPES["load"]
    stacked = {s: math.prod(s) for s in eng.pack_report.values()
               if len(s) == 5}
    if stacked.get((L, m // bm, k // bk, bm, bk)) != max(stacked.values()):
        raise AssertionError(f"the timed load case {PACK_SHAPES['load']} "
                             f"is not a largest layer-stacked leaf of "
                             f"{eng.pack_report}")


def glm_kv_plan(eng, cfg, m: int):
    from repro_torch.core import registry
    from repro_torch.core.plan import Problem
    return registry.peek(Problem(m, cfg.d_model, cfg.num_kv_heads
                                 * cfg.head_dim, cfg.dtype).key(), "cuda")


def glm_group(path, eng, cfg, b, res):
    """The tall-A plan of the group's K/V projection at prefill."""
    m = res.buckets[0] * SERVE[path]["prompt"]
    plan = glm_kv_plan(eng, cfg, m)
    if plan is None or plan.orientation != "tall_a":
        raise AssertionError(f"{path}: no tall_a plan for m={m}")
    return {"tall_plan": str(plan)}


def glm_path(path, eng, cfg, launches):
    """A tall-A kernel in the captured 2048-token prefill cells; the pack
    kernel wherever a K/V plan packs per call."""
    prompt = SERVE[path]["prompt"]
    prefill = cell_launches(eng, "prefill", prompt)
    tall_rose = sorted(k for k in TALL if prefill.get(k, 0))
    if not tall_rose:
        raise AssertionError(f"{path} launched no tall-A kernel at prefill")
    kv_plans = [glm_kv_plan(eng, cfg, m)
                for m in (*eng.buckets, *(b * prompt for b in eng.buckets))]
    need = {"pack_blocks"} if any(p is not None and packs_per_call(p)
                                  for p in kv_plans) else set()
    return ({"prefill_launches": dict(prefill),
             "tall_kernels_in_prefill": tall_rose}, need)


def deepseek_load(path, eng, cfg, load_launches):
    """MLA's projections (but wkv_a), the dense first layer's MLP and the
    head are packed; the kernels phase's DeepSeek load case is ``wo``, at
    its blocks, and a largest layer-stacked leaf."""
    absent = [p for p in DEEPSEEK_PACKED if p not in eng.pack_report]
    if absent:
        raise AssertionError(f"{path}: {absent} not packed at load")
    L, m, k, bm, bk = PACK_SHAPES["load.deepseek"]
    stacked = {s: math.prod(s) for s in eng.pack_report.values()
               if len(s) == 5}
    if (tuple(eng.pack_report["layers/attn/wo"])
            != (L, m // bm, k // bk, bm, bk)
            or math.prod((L, m, k)) != max(stacked.values())):
        raise AssertionError(f"the timed load case "
                             f"{PACK_SHAPES['load.deepseek']} is not wo, a "
                             f"largest layer-stacked leaf of "
                             f"{eng.pack_report}")


def deepseek_after(path, eng, cfg, base):
    b, s = SERVE[path]["max_batch"], SERVE[path]["prompt"]
    mla_prefill_attention(path, cfg, b, s, base[(b, s)][1].prefill_s)


def ssm_path(path, eng, cfg, launches):
    """No decode cell packs (every weight the step reads is packed at
    load); the hybrid's 2048-token prefill cells launch flash at its head
    dim (80, the only attention the model has)."""
    decode = cell_launches(eng, "decode")
    if decode.get("pack_blocks", 0) or launches.get("pack_blocks", 0):
        raise AssertionError(f"{path}: pack_blocks launched on the serve "
                             f"path ({launches.get('pack_blocks', 0)}; "
                             f"{decode.get('pack_blocks', 0)} per decode "
                             f"cell call)")
    extra = {"pack_blocks_on_path": launches.get("pack_blocks", 0)}
    if cfg.shared_block:
        extra.update(flash_path(path, eng, cfg, launches)[0])
    return extra, set()


def ssm_after(path, eng, cfg, base):
    """The profile of one prefill of the profiled group, eager (the
    ``ssm_*`` families come from the ranges of an eager run)."""
    from repro_torch.launch.profile_decode import profile_steps
    from repro_torch.launch.serve import make_group
    spec = SERVE[path]
    summary, _ = profile_steps(
        eng, make_group(cfg, spec["profile_batch"], spec["prompt"], "cuda"),
        steps=1, graphs=False, prefill=True)
    emit({"phase": "profile", "path": path, **summary})


def packed_load(path, eng, cfg, load_launches):
    """Every leaf of ``PACKED[path]`` (and nothing else) packed at load."""
    want = PACKED[path]
    absent = [p for p in want if p not in eng.pack_report]
    if absent or len(eng.pack_report) != len(want):
        raise AssertionError(f"{path}: packed {sorted(eng.pack_report)}, "
                             f"want {sorted(want)}")


def flash_path(path, eng, cfg, launches):
    """The path's prefill cells at its prompt launch flash at the model's
    head dim (every launch on the wgmma design: ``check_wgmma``)."""
    prompt = SERVE[path]["prompt"]
    prefill = cell_launches(eng, "prefill", prompt)
    if not prefill.get("flash_attention", 0):
        raise AssertionError(f"{path}: the {prompt}-token prefill cells "
                             f"launched no flash at D = {cfg.head_dim}: "
                             f"{dict(prefill)}")
    return ({"prefill_launches": dict(prefill),
             "flash_head_dim": cfg.head_dim}, set())


def window_path(path, eng, cfg, launches):
    """h2o-danube's rolling cache after the graphed groups: each bucket's
    last group (the shorter prompt, 4088 tokens) decoded past position
    4096, so its graphed decode wrote slot 4095 and then slot 0 (the
    slot computed on the device, on every replay); the longer prompt's
    prefill cell rolled (more positions than slots)."""
    import torch
    spec = SERVE[path]
    short = min(spec["prompts"])
    out = {}
    for bb in eng.buckets:
        cache = eng.programs.static_cache(bb, eng.max_len)
        slots = cache["slot_pos"].shape[0]
        sp = cache["slot_pos"].cpu()
        end = short + spec["steps"]
        wrapped = list(range(slots, end))
        ok = (slots == cfg.sliding_window < max(spec["prompts"])
              and short < slots < end and int(cache["pos"]) == end
              and sp[:end - slots].tolist() == wrapped
              and int(sp[slots - 1]) == slots - 1
              and bool(torch.all(sp[end - slots:short] == torch.arange(
                  end - slots, short))))
        out[bb] = {"slots": slots, "pos": int(cache["pos"]),
                   "slot_pos_head": sp[:end - slots].tolist(),
                   "slot_pos_last": int(sp[slots - 1]), "wrapped": ok}
        if not ok:
            raise AssertionError(f"{path}: bucket {bb}'s cache did not "
                                 f"wrap as a {short}-token prompt + "
                                 f"{spec['steps']} steps must: {out[bb]}")
    return {"window": cfg.sliding_window, "wrap": out}, set()


def encdec_path(path, eng, cfg, launches):
    """whisper-base: flash at D 64 in the decoder's prefill cells, and
    the skinny-A kernel's bias + GELU epilogue on the graphed groups
    (``cuda.epilogue_launches``, zeroed with the other counts): each
    group's prefill fuses it into every encoder layer's and every decoder
    layer's MLP, and its decode steps into every decoder layer's, each a
    ``bias_gelu`` epilogue launch and none an activation without bias."""
    extra, _ = flash_path(path, eng, cfg, launches)
    epi = EPILOGUES[path]
    gelu = sum(v for k, v in epi.items() if k.endswith("/bias_gelu"))
    least = len(SERVE[path]["groups"]) * (cfg.encoder_layers
                                          + cfg.num_layers)
    if gelu < least or any(not k.endswith("/bias_gelu") for k in epi):
        raise AssertionError(f"{path}: fused epilogue launches {epi}, not "
                             f"at least {least} bias + GELU launches and "
                             f"no other")
    extra["gelu_epilogue_launches"] = epi
    return extra, set()


# four models' serve and queue paths at half their depth, so the script
# ends well inside its time limit with the ZOO paths (each model fits
# the card whole; Zamba2 keeps whole groups of 6 Mamba layers)
HALF_DEPTH = {"qwen1_5_4b": {"num_layers": 20},
                 "olmoe_1b_7b": {"num_layers": 8},
                 "mamba2_780m": {"num_layers": 24},
                 "zamba2_2_7b": {"num_layers": 24}}


# the serve paths: (arch, cut of the published config, max batch, prompt,
# decode steps, groups, the profiled batch, whether flash runs, the path's
# own checks).  OLMoE-1B-7B, Mamba2-780m and Zamba2-2.7B whole;
# DeepSeek-V2 at its published widths cut to 3 layers (the dense first
# layer and 2 MoE layers: 160 experts x 3 x 5120 x 1536 bf16 = 7.55 GB a
# layer; 60 do not fit one card)
SERVE = {
    "serve": dict(arch="qwen1_5_4b", cut=HALF_DEPTH["qwen1_5_4b"],
                  max_batch=4, prompt=256,
                  steps=16, groups=(1, 3, 4), profile_batch=4, flash=True,
                  hooks={"load": packed_load}),
    "serve.glm4": dict(arch="glm4_9b", cut={}, max_batch=2, prompt=2048,
                       steps=8, groups=(1, 2), profile_batch=1, flash=True,
                       hooks={"load": glm_load, "group": glm_group,
                              "path": glm_path}),
    "serve.olmoe": dict(arch="olmoe_1b_7b", cut=HALF_DEPTH["olmoe_1b_7b"],
                        max_batch=4, prompt=256,
                        steps=16, groups=(1, 3, 4), profile_batch=4,
                        flash=True, hooks={}),
    "serve.deepseek": dict(arch="deepseek_v2_236b", cut={"num_layers": 3},
                           max_batch=2, prompt=512, steps=8, groups=(1, 2),
                           profile_batch=2, flash=False,
                           hooks={"load": deepseek_load,
                                  "after": deepseek_after}),
    "serve.mamba2": dict(arch="mamba2_780m",
                         cut=HALF_DEPTH["mamba2_780m"], max_batch=4,
                         prompt=256,
                         steps=16, groups=(1, 3, 4), profile_batch=4,
                         flash=False, hooks={"load": packed_load,
                                             "path": ssm_path,
                                             "after": ssm_after}),
    "serve.zamba2": dict(arch="zamba2_2_7b",
                         cut=HALF_DEPTH["zamba2_2_7b"], max_batch=2,
                         prompt=2048, steps=8, groups=(1, 2),
                         profile_batch=1, flash=True,
                         hooks={"load": packed_load, "path": ssm_path,
                                "after": ssm_after}),
    # h2o-danube-1.8b whole: a 4352-token prompt past the 4096 window (the
    # rolled prefill) and a 4088-token one whose decode wraps; the length
    # grid holds exactly those two (min_prompt 4088).  Windowed attention
    # takes the chunked body, as in the reference: no flash
    "serve.danube": dict(arch="h2o_danube_1_8b", cut={}, max_batch=2,
                         prompt=4352, prompts=(4352, 4088), min_prompt=4088,
                         steps=16, groups=(1, 2), profile_batch=1,
                         flash=False, hooks={"load": packed_load,
                                             "path": window_path}),
    # the LLaVA-NeXT backbone whole: 2880 seeded image embeddings + 192
    # tokens = 3072 positions, flash at D 128 on 32 query / 8 KV heads
    "serve.llava": dict(arch="llava_next_mistral_7b", cut={}, max_batch=2,
                        prompt=192, steps=16, groups=(1, 2), profile_batch=1,
                        flash=True, hooks={"load": packed_load,
                                           "path": flash_path}),
    # whisper-base whole: 1500 seeded frames, a 256-token decoder prompt
    # (flash at D 64, causal); the encoder (1500 frames) and the cross
    # attention take the chunked body
    "serve.whisper": dict(arch="whisper_base", cut={}, max_batch=4,
                          prompt=256, steps=16, groups=(1, 3, 4),
                          profile_batch=4, flash=True,
                          hooks={"load": packed_load, "path": encdec_path}),
    # llama3-405b at its published widths cut to 2 layers: 12.8 GB of
    # layers + 8.4 GB of embedding and head (126 layers do not fit a card)
    "serve.llama3": dict(arch="llama3_405b", cut={"num_layers": 2},
                         max_batch=2, prompt=512, steps=8, groups=(1, 2),
                         profile_batch=2, flash=True,
                         hooks={"load": packed_load, "path": flash_path}),
}
# the serve paths of h2o-danube-1.8b, LLaVA-NeXT, whisper-base and
# llama3-405b, in the order they run
ZOO = ("serve.danube", "serve.llava", "serve.whisper", "serve.llama3")
# the leaves each path's engine must pack at load (and no other)
_LM_PACKED = ("layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
              "layers/attn/wo", "layers/mlp/w_gate", "layers/mlp/w_up",
              "layers/mlp/w_down", "embed/head")
_SHARED_PACKED = tuple(
    [f"shared/attn/{w}" for w in ("wq", "wk", "wv", "wo")]
    + [f"shared/mlp/{w}" for w in ("w_gate", "w_up", "w_down")])
PACKED = {
    "serve": _LM_PACKED, "serve.danube": _LM_PACKED,
    "serve.llava": _LM_PACKED, "serve.llama3": _LM_PACKED,
    # every Mamba leaf (w_in zero-padded to whole blocks), the head (a
    # tied one as a packed copy of the table's transpose) and the
    # hybrid's shared block
    "serve.mamba2": ("layers/mamba/w_in", "layers/mamba/w_out",
                     "embed/head"),
    "serve.zamba2": ("mamba_layers/mamba/w_in", "mamba_layers/mamba/w_out",
                     "embed/head") + _SHARED_PACKED,
    # the encoder's and the decoder's every projection and the tied head
    # (51865 wide: zero-padded to whole blocks)
    "serve.whisper": tuple(
        [f"enc_layers/attn/{w}" for w in ("wq", "wk", "wv", "wo")]
        + [f"enc_layers/mlp/{w}" for w in ("w_in", "w_out")]
        + [f"dec_layers/{a}/{w}" for a in ("self_attn", "cross_attn")
           for w in ("wq", "wk", "wv", "wo")]
        + [f"dec_layers/mlp/{w}" for w in ("w_in", "w_out")]
        + ["embed/head"]),
}
# DeepSeek-V2's packed leaves the serve path must hold: MLA's projections
# (but wkv_a, (5120, 576), which no block layout divides: it runs the
# skinny kernels unpacked, on its planned problem), the dense first
# layer's MLP and the head
DEEPSEEK_PACKED = ("layers/attn/wq_a", "layers/attn/wq_b",
                   "layers/attn/wkv_b", "layers/attn/wo", "dense0/attn/wq_a",
                   "dense0/mlp/w_gate", "dense0/mlp/w_up",
                   "dense0/mlp/w_down", "embed/head")


def mla_prefill_attention(path: str, cfg, b: int, s: int, prefill_s: float):
    """The chunked torch body that MLA's prefill attention runs (192-wide
    Q/K against a 128-wide V: no flash design takes it), at the path's
    largest group (``b`` x ``s`` tokens, bf16, every head): its wall and
    device ms beside the FLOP bound, SDPA on the same inputs (held to the
    body within the bf16 tolerance) and the graphed prefill it sits in."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.evaluator import Timer
    from repro_torch.models.attention import chunked_attention

    h, dk, dv = (cfg.num_heads, cfg.head_dim + cfg.rope_head_dim,
                 cfg.v_head_dim)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k = (torch.randn((b, s, h, dk), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=g, device="cuda").to(
        torch.bfloat16)

    def body():
        return chunked_attention(q, k, v, causal=True)

    def lib():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    ok, err = within(body(), lib().transpose(1, 2), **BF16_TOL)
    if not ok:
        raise AssertionError(f"{path}: MLA's chunked prefill attention "
                             f"against SDPA: max |err| {err} outside "
                             f"{BF16_TOL}")
    timer = Timer()
    device_ms = timer(body, device=True)
    # QK^T (dk wide) and PV (dv wide) over the causal triangle; q, k, v
    # read once, the output written once
    bound_ms, bound_by = bound(2 * b * s * h * (2 * dk + 2 * dv),
                               2 * b * h * (dk + dv) * (s * (s + 1) // 2))
    emit({"phase": f"{path}.mla_prefill_attention", "B": b, "S": s, "H": h,
          "dk": dk, "dv": dv, "dtype": "bfloat16", "route": "chunked torch",
          "ms": timer(body), "device_ms": device_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": timer(lib),
          "library_device_ms": timer(lib, device=True),
          "max_abs_err_vs_library": err, "layers": cfg.num_layers,
          "device_ms_per_prefill": device_ms * cfg.num_layers,
          "graphed_prefill_ms": 1e3 * prefill_s})
    del q, k, v
    torch.cuda.empty_cache()


# the reference test's ragged queue, (prompt length, decode budget):
# served from 2 slots, so later requests join a running batch
QUEUE_PARITY_SPEC = ((5, 4), (12, 2), (20, 6), (9, 3), (3, 5))


def queue_logits(eng, reqs, idx: int, d: int):
    """The logits a 2-slot queue of ``reqs`` chose stream ``idx``'s token
    ``d`` from: the queue served again with the store's cells and the
    scheduler's admissions recorded (the stream's row, and every cell's
    last logits row, in order)."""
    import dataclasses as dc

    from repro_torch.serve.scheduler import ContinuousScheduler
    store, rec, rows = eng.programs, [], {}
    program = store.program

    def recorded(kind, args, **kw):
        prog = program(kind, args, **kw)

        def fn(*a):
            out = prog.fn(*a)
            rec.append((kind, out[0][:, -1].float().cpu()))
            return out
        return dc.replace(prog, fn=fn)

    sched = ContinuousScheduler(eng, slots=2)
    admit = sched.admit

    def admit_noting_the_row(req, *a, **k):
        emitted, finished = admit(req, *a, **k)
        rows[req.rid] = (emitted[0][0]["row"], len(rec) - 1)
        return emitted, finished

    sched.admit = admit_noting_the_row
    store.program = recorded
    try:
        sched.run(reqs)
    finally:
        del store.program
    row, at = rows[reqs[idx].rid]
    if d == 0:
        return rec[at][1][0]
    decodes = [lg for kind, lg in rec[at + 1:] if kind == "decode"]
    return decodes[d - 1][row]


def phase_queue_parity(cfg, device="cuda"):
    """``Engine.serve_queue`` from 2 slots (qwen1.5-4b widths, 2 layers,
    fp32): each stream's tokens against its solo ``generate``.  Where a
    token differs, the logits the queue chose it from and the solo run's
    must agree within ``F32_TOL`` and the two tokens' logits must be
    within it too (a near-tie); both are printed.  Returns the queue's
    launch counts."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request

    t0 = time.perf_counter()
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, axes, max_len=128, max_batch=2, max_prompt=32,
                 device=device)
    del params
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32) for n, _ in QUEUE_PARITY_SPEC]
    reqs = [Request(tokens=p, max_new_tokens=m, rid=i)
            for i, (p, (_, m)) in enumerate(zip(prompts, QUEUE_PARITY_SPEC))]
    cuda.reset_launches()
    results, stats = eng.serve_queue(reqs, slots=2)
    launches = dict(cuda.launches)
    designs = dict(cuda.design_launches)
    streams = []
    for i, (r, p) in enumerate(zip(results, prompts)):
        m = reqs[i].max_new_tokens
        solo = eng.generate({"tokens": p[None].to(device)}, steps=m)
        want, got = solo.tokens[0].tolist(), r.tokens.tolist()
        row = {"rid": r.rid, "prompt": len(p), "steps": m,
               "admitted_at": r.admitted_at, "equal": want == got,
               "tokens": got}
        if want != got:
            d = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
            solo_lg = eng.generate({"tokens": p[None].to(device)},
                                   steps=d).logits_last[0, -1].float().cpu()
            queue_lg = queue_logits(eng, reqs, i, d)
            ok, err = within(queue_lg, solo_lg, **F32_TOL)
            gap = float(solo_lg[want[d]] - solo_lg[got[d]])
            qgap = float(queue_lg[got[d]] - queue_lg[want[d]])
            top = float(solo_lg[want[d]].abs())
            near = max(gap, qgap) <= F32_TOL["atol"] + F32_TOL["rtol"] * top
            row.update(first_divergence=d, solo_token=want[d],
                       queue_token=got[d], max_abs_err=err,
                       solo_top2_gap=gap, queue_top2_gap=qgap,
                       near_tie=ok and near)
            emit({"phase": "queue.parity.divergence", **row})
            if not (ok and near):
                raise AssertionError(f"queue.parity: stream {r.rid} diverges "
                                     f"at token {d} without a near-tie: "
                                     f"{row}")
        streams.append(row)
    emit({"phase": "queue.parity", "config": cfg.name, "d_model": cfg.d_model,
          "layers": cfg.num_layers, "dtype": cfg.dtype, "slots": stats.slots,
          "streams": streams, "telemetry": dict(stats.rows()),
          "tol": F32_TOL, "launches": launches, "design_launches": designs,
          "seconds": time.perf_counter() - t0})
    if stats.admitted != stats.completed or stats.completed != len(reqs):
        raise AssertionError(f"queue.parity: {stats.rows()}")
    check_healthy("queue.parity", eng)
    if not max(r.admitted_at for r in results) > min(r.admitted_at
                                                     for r in results):
        raise AssertionError("queue.parity: no request joined a running "
                             "batch")
    check_fp32("queue.parity", launches, designs)
    return launches


# the queue phase's workload: the continuous-batching tool's prompt
# lengths scaled from 5-120 into 5-256 tokens, its budgets from 2-12 into
# 2-16 (launch/continuous_batching.py)
def queue_workload(cfg, n: int = 16) -> list:
    from repro_torch.launch.continuous_batching import (DEFAULT_LENS,
                                                        DEFAULT_STEPS,
                                                        workload)
    lens = tuple(max(5, round(p * 256 / max(DEFAULT_LENS)))
                 for p in DEFAULT_LENS)
    steps = tuple(max(2, round(s * 16 / max(DEFAULT_STEPS)))
                  for s in DEFAULT_STEPS)
    return workload(cfg, n, lens=lens, steps=steps)


def queue_kernels(eng, lengths) -> set:
    """The skinny-A counters the queue path must launch: the variant each
    packed weight has stamped for the slot bucket (every lockstep step)
    and the installed plan of each admission's token count (a
    ``prefill_row`` at length bucket lb is m = lb rows; no plan: the
    baseline), each as the dispatch runs it on the weight's packed k
    blocks (``kernels/gen.py::skinny_steps``: a k-split whose split does
    not divide them is clamped to a divisor, 1 meaning k-inner)."""
    from repro_torch.core import registry
    from repro_torch.core.packing import PackedTensor
    from repro_torch.core.plan import Problem
    from repro_torch.kernels import gen
    from repro_torch.kernels.variants.grammar import BASELINE_POINT
    need = {skinny_counter(v) for key, v in eng.variant_report().items()
            if key.startswith(f"m{eng.max_batch}_")}
    shapes = set()

    def walk(p):
        if isinstance(p, dict):
            for v in p.values():
                walk(v)
        elif isinstance(p, PackedTensor):
            shapes.add((p.shape[-2], p.orig_cols, p.blocks.shape[-4]))

    walk(eng.params)
    for lb in lengths:
        for k, n, nk in shapes:
            plan = registry.peek(Problem(lb, k, n, eng.model.cfg.dtype).key(),
                                 eng.device)
            g = plan.gen_spec() if plan is not None else BASELINE_POINT
            need.add(gen.skinny_steps(g, nk, True)[0][0])
    return need


def timed(fn, into: list):
    """``fn`` with each call's wall seconds appended to ``into`` (each
    admission and step ends in a host read, so the call is synchronous)."""
    def call(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        into.append(time.perf_counter() - t0)
        return out
    return call


def phase_queue(cfg=None, device="cuda", *, n=16, path="queue",
                extras=True):
    """``cfg`` (default qwen1.5-4b) at full width, bf16, on a
    queue engine of its own (4 slots, prompts to 256, ``max_len`` by the
    ragged rule), its grid (``prefill_row`` cells included) captured at
    load: ``n`` ragged requests through ``serve_queue`` on an eager
    store, then graphed (the main path): tokens bit-equal, launch counts
    equal.  With ``extras``, then a timed graphed run (admission and step
    wall times), the continuous-batching comparison against aligned
    groups and the profile of one step.  Returns (the graphed run's
    launches, the load's launches, the engine, the requests, the graphed
    results and stats)."""
    import gc
    import statistics

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.launch import continuous_batching
    from repro_torch.launch.serve import make_group
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore
    from repro_torch.serve.scheduler import ContinuousScheduler

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = cfg or get_config("qwen1_5_4b")
    model = build_model(cfg)
    reqs = queue_workload(cfg, n)
    max_len = continuous_batching.ragged_max_len(reqs)
    registry.reset_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, axes, max_len=max_len, max_batch=4,
                 max_prompt=256, device=device)
    del params
    load_s = time.perf_counter() - t0
    load_launches = dict(cuda.launches)     # the weight pre-pack
    t0 = time.perf_counter()
    rows = eng.precompile()
    pre = {"rows": rows, "seconds": time.perf_counter() - t0,
           "loaded": eng.programs.stats()}
    graphed = eng.programs
    eng.programs = ProgramStore(model, device=eng.device, capture=False)
    cuda.reset_launches()
    try:
        want, wstats = eng.serve_queue(reqs)
    finally:
        eng.programs = graphed
    eager_counts = (dict(cuda.launches), dict(cuda.design_launches))
    cuda.reset_launches()
    got, stats = eng.serve_queue(reqs)             # the main path
    launches, designs = dict(cuda.launches), dict(cuda.design_launches)
    for a, b in zip(got, want):
        if a.tokens.tolist() != b.tokens.tolist() or not a.completed:
            raise AssertionError(f"{path}: request {a.rid}'s graphed tokens "
                                 f"differ from the eager run's")
    if (launches, designs) != eager_counts:
        raise AssertionError(f"{path}: launches under replay "
                             f"{(launches, designs)} differ from the eager "
                             f"run's {eager_counts}")
    reg = registry.stats()
    emit({"phase": path, "config": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "slots": stats.slots,
          "max_len": max_len, "load_s": load_s, "load_launches": load_launches,
          "requests": len(reqs),
          "prompts": [len(r.tokens) for r in reqs],
          "budgets": [r.max_new_tokens for r in reqs],
          "telemetry": dict(stats.rows()),
          "eager_telemetry": dict(wstats.rows()),
          "tokens_per_s": stats.tokens_per_s,
          "eager_tokens_per_s": wstats.tokens_per_s,
          "bit_equal_to_eager": True, "registry": reg,
          "streams": [{"rid": r.rid, "prompt": r.prompt_len,
                       "lb": r.length_bucket, "admitted_at": r.admitted_at,
                       "finished_at": r.finished_at,
                       "queue_steps": r.queue_steps,
                       "tokens": r.tokens.tolist()} for r in got],
          "launches": launches, "design_launches": designs,
          "degradations": eng.degrade.total})
    check_programs(path, eng, pre)
    check_healthy(path, eng)
    if reg["misses"]:
        raise AssertionError(f"{path}: {reg['misses']} registry misses after "
                             f"the install sweep")
    check_wgmma(path, launches, designs)
    need = queue_kernels(eng, sorted({r.length_bucket for r in got}))
    missing = sorted(k for k in need if not launches.get(k))
    if missing:
        raise AssertionError(f"{path} path launched no {missing} ({need})")
    if not extras:
        emit({"phase": f"{path}.seconds",
              "seconds": time.perf_counter() - t_phase})
        return launches, load_launches, eng, reqs, got, stats

    # wall time of each admission (by length bucket) and each step
    sched = ContinuousScheduler(eng)
    adm, steps = [], []
    sched.admit = timed(sched.admit, adm)
    sched.step = timed(sched.step, steps)
    again, _ = sched.run(reqs)
    if [r.tokens.tolist() for r in again] != [r.tokens.tolist() for r in got]:
        raise AssertionError("queue: a second graphed run served other "
                             "tokens")
    by_lb = {}
    for r, sec in zip(again, adm):          # FIFO: admitted in queue order
        by_lb.setdefault(r.length_bucket, []).append(1e3 * sec)
    emit({"phase": "queue.times",
          "prefill_row_ms_by_lb": {lb: statistics.median(v)
                                   for lb, v in sorted(by_lb.items())},
          "step_ms_median": 1e3 * statistics.median(steps),
          "step_ms_min": 1e3 * min(steps), "step_ms_max": 1e3 * max(steps),
          "steps": len(steps), "admissions": len(adm)})
    emit({"phase": "queue.continuous_batching",
          "rows": continuous_batching.compare(eng, reqs, repeats=1)})
    profile("queue", eng, make_group(cfg, 4, 256, device), steps=4)
    check_healthy(path, eng)
    emit({"phase": "queue.seconds", "seconds": time.perf_counter() - t_phase})
    return launches, load_launches, eng, reqs, got, stats


def phase_queue_frontend(eng, reqs, results, stats):
    """The front end on the queue engine: ``simulate`` on a virtual clock
    with every arrival at 0 must serve ``serve_queue``'s tokens; then
    ``run()`` on the real clock under a producer submitting a seeded
    Poisson trace of the same requests at half the request rate the
    queue sustained.  Every stream must complete, none rejected."""
    import asyncio
    import dataclasses as dc

    import numpy as np
    from repro_torch.serve.clock import RealClock, VirtualClock
    from repro_torch.serve.frontend import AsyncEngine

    streams, sim = AsyncEngine(eng, clock=VirtualClock()).simulate(
        [dc.replace(r, arrival_time=0.0) for r in reqs])
    for s, r in zip(streams, results):
        if (s.tokens != r.tokens.tolist() or s.result.admitted_at
                != r.admitted_at or s.result.finished_at != r.finished_at):
            raise AssertionError(f"queue.frontend: simulate served request "
                                 f"{r.rid} otherwise than serve_queue")
    rate = 0.5 * len(reqs) / max(stats.wall_s - stats.compile_s, 1e-9)
    rng = np.random.default_rng(0)
    gaps = rng.exponential(1.0 / rate, size=len(reqs))
    clock = RealClock()
    afe = AsyncEngine(eng, clock=clock)

    async def produce():
        out, t_next = [], clock.now()
        for r, gap in zip(reqs, gaps):
            t_next += float(gap)
            await clock.sleep(max(t_next - clock.now(), 0.0))
            out.append(await afe.submit(
                dc.replace(r, arrival_time=clock.now())))
        afe.request_stop()
        return out

    async def main():
        afe.open()
        loop = asyncio.create_task(afe.run())
        out = await produce()
        await loop
        return out

    t0 = time.perf_counter()
    live = asyncio.run(main())
    wall = time.perf_counter() - t0
    ttft = np.asarray([s.ttft for s in live if s.ttft is not None])
    delay = np.asarray([s.queue_delay for s in live
                        if s.queue_delay is not None])
    st = afe.stats
    emit({"phase": "queue.frontend", "simulate_bit_equal_to_serve_queue": True,
          "simulate_virtual_wall_s": sim.wall_s, "offered_rate_per_s": rate,
          "requests": len(live), "wall_s": wall,
          "completed": sum(s.completed for s in live),
          "rejected": st.rejected,
          "ttft_p50_s": float(np.percentile(ttft, 50)),
          "ttft_p99_s": float(np.percentile(ttft, 99)),
          "queue_delay_p50_s": float(np.percentile(delay, 50)),
          "queue_delay_p99_s": float(np.percentile(delay, 99)),
          "telemetry": dict(st.rows())})
    if st.rejected or not all(s.completed for s in live) or \
            len(ttft) != len(reqs):
        raise AssertionError(f"queue.frontend: {st.rows()}")
    check_healthy("queue.frontend", eng)


RESILIENCE_GROUP = (2, 64, 4)     # batch, prompt tokens, decode steps
SKINNY_FAMILY = ("tsmm_skinny_a", "skinny_kinner", "skinny_ksplit")


def ladder_logits(path: str, healthy, want, eng, group: dict,
                  steps: int) -> tuple:
    """``eng``'s run of ``group`` against the healthy engine's (``want``,
    its result), by logits: with equal tokens the last logits must agree
    within ``F32_TOL``; where a token differs, the logits both chose it
    from (each engine served again up to that token, on its captured
    cells) must agree within it and the two tokens' logits be within it
    (a near-tie).  Returns (the row, the launches of ``eng``'s run)."""
    import torch
    from repro_torch.kernels import cuda
    cuda.reset_launches()
    got = eng.generate(group, steps)
    launches = dict(cuda.launches)
    d = steps
    if not torch.equal(got.tokens, want.tokens):
        diff = (got.tokens != want.tokens).any(dim=0).nonzero()
        d = int(diff[0])
        want, got = healthy.generate(group, d), eng.generate(group, d)
    w, g = want.logits_last[:, -1].float().cpu(), got.logits_last[:, -1]
    ok, err = within(g.float().cpu(), w, **F32_TOL)
    row = {"tokens_equal": d == steps, "compared_at_step": d,
           "max_abs_err": err, "tol": F32_TOL}
    if d < steps:
        wt = w.argmax(-1)
        gt = g.float().cpu().argmax(-1)
        gap = float((w.gather(-1, wt[:, None])
                     - w.gather(-1, gt[:, None])).abs().max())
        row.update(near_tie_gap=gap)
        ok = ok and gap <= F32_TOL["atol"] + F32_TOL["rtol"] * float(
            w.abs().max())
    if not ok:
        raise AssertionError(f"{path}: logits off the healthy run's: {row}")
    return row, launches


def phase_resilience(device="cuda"):
    """The kernel ladder on the card (qwen1.5-4b, full width, 2 layers,
    fp32): healthy; rung 2 (``kernels.lower.*`` raise: the plain
    versions); rung 3 (``kernels.xla.*`` too: ``torch.matmul``); the
    breaker pinning after K failures; disarmed, healthy again.  Each
    engine is fresh, so its cells capture the rung it serves."""
    import gc

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.tsmm import tsmm_dot
    from repro_torch.launch.serve import make_group
    from repro_torch.models.registry import build_model
    from repro_torch.resilience import degrade, failpoints
    from repro_torch.serve.engine import Engine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen1_5_4b"), num_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    b, prompt, steps = RESILIENCE_GROUP
    group = make_group(cfg, b, prompt, device, seed=0)

    def engine():
        return Engine(model, params, axes, max_len=prompt + steps + 8,
                      max_batch=b, max_prompt=prompt, device=device)

    healthy = engine()
    want = healthy.generate(group, steps)
    check_healthy("resilience.healthy", healthy)
    for rung, sites in ((2, ("kernels.lower.skinny", "kernels.lower.tall")),
                        (3, ("kernels.lower.skinny", "kernels.lower.tall",
                             "kernels.xla.skinny", "kernels.xla.tall"))):
        failpoints.configure({site: "raise" for site in sites})
        try:
            eng = engine()
            row, launches = ladder_logits(f"resilience.rung{rung}", healthy,
                                          want, eng, group, steps)
            hr = eng.health_report()
        finally:
            failpoints.reset()
        by_seam = hr["degradations"]["by_seam"]
        row = {**row, "launches": launches, "by_seam": by_seam,
               "healthy": hr["healthy"]}
        emit({"phase": f"resilience.rung{rung}", "armed": sites, **row})
        # no kernel at all: every TSMM family and the per-call pack are
        # laddered, and a 64-token prompt takes no flash kernel
        if (launches or hr["healthy"] or not by_seam.get("kernel.variant")
                or (rung == 3 and not by_seam.get("kernel.xla"))):
            raise AssertionError(f"resilience.rung{rung}: {row}")
        del eng
    # the breaker: K failures of one key pin its fallback
    g = torch.Generator(device=device).manual_seed(1)
    a = torch.randn((2048, 512), generator=g, device=device)
    w = torch.randn((512, 16), generator=g, device=device)
    stats = degrade.DegradeStats(breaker_threshold=2)
    failpoints.configure({"kernels.lower.skinny": "raise",
                          "kernels.lower.tall": "raise"})
    try:
        with degrade.use(stats):
            outs = [tsmm_dot(a, w) for _ in range(4)]
    finally:
        failpoints.reset()
    ok, err = within(outs[-1], a @ w, **F32_TOL)
    br = stats.report()
    emit({"phase": "resilience.breaker", "threshold": 2, "calls": 4,
          "by_seam": br["by_seam"], "open": br["breaker"]["open"],
          "max_abs_err": err})
    if (br["by_seam"] != {"kernel.variant": 2, "kernel.pinned": 2}
            or not br["breaker"]["open"] or not ok):
        raise AssertionError(f"resilience.breaker: {br}")
    again = engine()
    row, launches = ladder_logits("resilience.reset", healthy, want, again,
                                  group, steps)
    check_healthy("resilience.reset", again)
    skinny = sum(launches.get(k, 0) for k in SKINNY_FAMILY)
    emit({"phase": "resilience", "config": cfg.name, "layers": 2,
          "dtype": cfg.dtype, "group": RESILIENCE_GROUP, "reset": row,
          "reset_skinny_launches": skinny,
          "seconds": time.perf_counter() - t0})
    if device == "cuda" and not skinny:
        raise AssertionError("resilience.reset: no skinny-A launch")
    del healthy, again, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


FLEET_WORK = ("--iters", "2", "--warmup", "1", "--top-k", "2", "--stable",
              "1", "--build-k", "2", "--lease-s", "600")


def phase_fleet(device="cuda"):
    """The fleet on a directory of its own: an engine without install or
    background tuner flushes its misses; ``tune_service harvest``, ``work
    --workers 2`` on the card (each job done exactly once), ``export``;
    a fresh engine on an empty plan cache with the find-db attached
    serves with 0 misses."""
    import gc

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import registry
    from repro_torch.launch.serve import make_group
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.tuning.queue import JobQueue

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fleet-", dir=os.path.join(ROOT, "build"))
    fleet = {"REPRO_TORCH_PLAN_CACHE": os.path.join(root, "plans.json"),
             "REPRO_TORCH_MEASURE_CACHE": os.path.join(root, "meas.json"),
             "REPRO_TORCH_MISS_LOG": os.path.join(root, "misses.json"),
             "REPRO_TORCH_TUNE_QUEUE": os.path.join(root, "queue.json")}
    saved = {k: os.environ.get(k) for k in (*fleet, "REPRO_TORCH_FIND_DB")}
    os.environ.update(fleet)
    registry.clear_memory()
    try:
        cfg = dataclasses.replace(get_config("qwen1_5_4b"), num_layers=2)
        model = build_model(cfg)
        params, axes = model.init(
            torch.Generator(device=device).manual_seed(0))
        group = make_group(cfg, 2, 64, device, seed=0)

        def serve():
            eng = Engine(model, params, axes, max_len=80, max_batch=2,
                         max_prompt=64, device=device)
            eng.generate(group, 4)
            return eng

        eng = serve()
        misses = registry.stats()["misses"]
        check_healthy("fleet.engine", eng)
        del eng
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        cli = [sys.executable, "-m", "repro_torch.launch.tune_service"]
        out = subprocess.run(cli + ["harvest"], env=env, capture_output=True,
                             text=True, timeout=300, check=True).stdout
        harvested = json.loads(out.split("harvest: ", 1)[1].splitlines()[0])
        t_work = time.perf_counter()
        res = subprocess.run(cli + ["work", "--workers", "2", "--device",
                                    device, *FLEET_WORK],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        work_s = time.perf_counter() - t_work
        if res.returncode != 0:
            raise AssertionError(f"fleet: work exited {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        workers = [json.loads(line[len("worker: "):])
                   for line in res.stdout.splitlines()
                   if line.startswith("worker: ")]
        jobs = JobQueue().jobs()
        credited = sorted(r[0] for w in workers for r in w["results"])
        once = all(j.state == "done" and [e[0] for e in j.history].count(
            "done") == 1 for j in jobs.values())
        times = [t for j in jobs.values() for ev, _, t in j.history
                 if ev in ("claim", "done")]
        span = max(times) - min(times) if times else 0.0
        fdb = os.path.join(root, "find_db.json")
        subprocess.run(cli + ["export", "--out", fdb], env=env,
                       capture_output=True, text=True, timeout=300,
                       check=True)
        # a fresh host: an empty plan cache, the find-db attached
        os.environ["REPRO_TORCH_PLAN_CACHE"] = os.path.join(root, "host2",
                                                            "plans.json")
        os.environ["REPRO_TORCH_FIND_DB"] = fdb
        registry.clear_memory()
        eng = serve()
        restart = registry.stats()
        check_healthy("fleet.restart", eng)
        del eng, params
        row = {"phase": "fleet", "config": cfg.name, "layers": 2,
               "dtype": cfg.dtype, "engine_misses": misses,
               "harvest": harvested, "jobs": len(jobs), "workers": 2,
               "worker_reports": [{k: w[k] for k in ("worker", "done",
                                                     "failed", "seconds")}
                                  for w in workers],
               "exactly_once": once and credited == sorted(jobs),
               "work_wall_s": work_s, "span_s": span,
               "jobs_per_min": len(jobs) * 60.0 / max(span, 1e-9),
               "restart_registry": restart,
               "seconds": time.perf_counter() - t0}
        emit(row)
        if (not jobs or len(jobs) != harvested["enqueued"]
                or not row["exactly_once"] or restart["misses"]
                or not restart["hits"]):
            raise AssertionError(f"fleet: {row}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        registry.clear_memory()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()



def shape_of(case: dict) -> dict:
    """The shape fields of a kernels case, and its mode."""
    return {**{k: case[k] for k in ("L", "m", "M", "K", "N", "bm", "bk", "B",
                                    "S", "H", "KH", "D") if k in case},
            "mode": case["mode"]}


# name -> (source, replaced TPU kernel file:line); the rows of the
# ``kernels`` line
KERNELS = {
    "tsmm_skinny_a": ("src/repro_torch/csrc/tsmm_skinny.cu",
                      "src/repro/kernels/tsmm.py:295"),
    "skinny_kinner": ("src/repro_torch/csrc/tsmm_skinny.cu",
                      "src/repro/kernels/gen.py:310"),
    "skinny_ksplit": ("src/repro_torch/csrc/tsmm_skinny.cu",
                      "src/repro/kernels/gen.py:374"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:76"),
    "tsmm_tall_a": ("src/repro_torch/csrc/tsmm_tall.cu",
                    "src/repro/kernels/tsmm.py:111"),
    "tsmm_packed_a": ("src/repro_torch/csrc/tsmm_tall.cu",
                      "src/repro/kernels/tsmm.py:181"),
    "tall_kinner": ("src/repro_torch/csrc/tsmm_tall.cu",
                    "src/repro/kernels/gen.py:115"),
    "tall_ksplit": ("src/repro_torch/csrc/tsmm_tall.cu",
                    "src/repro/kernels/gen.py:193"),
    "tall_kouter": ("src/repro_torch/csrc/tsmm_tall.cu",
                    "src/repro/kernels/gen.py:247"),
    "pack_blocks": ("src/repro_torch/csrc/pack_blocks.cu",
                    "src/repro/kernels/tsmm.py:238"),
}


def main():
    if os.environ.get("REPRO_TORCH_FAILPOINTS"):
        raise SystemExit("chip_smoke: refusing to run with "
                         "REPRO_TORCH_FAILPOINTS set: every path must run "
                         "the kernels")
    phase_env()
    # the install phase's plan and measurement cache, inside the checkout
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache = tempfile.mkdtemp(prefix="install-",
                             dir=os.path.join(ROOT, "build"))
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "measurements.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        os.environ[var] = os.path.join(cache, name)
    try:
        run()
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def run():
    import torch
    from repro_torch.core.evaluator import Timer
    phase_build()
    timer = Timer()
    install_launches = phase_install()
    phase_gate()
    paper_launches, paper_designs, paper_rows, paper_pack = phase_paper(timer)
    set_pack_shapes()
    cases, worst = phase_kernels(timer)
    tall_launches = phase_tall(timer)
    from repro_torch.configs.base import get_config
    phase_parity(dataclasses.replace(get_config("qwen1_5_4b"), num_layers=2,
                                     dtype="float32"), 1, 256)
    glm_parity = phase_parity(get_config("glm4_9b").reduced(**GLM_PARITY), 2,
                              1024)
    if not any(glm_parity.get(k, 0) for k in TALL):
        raise AssertionError("GLM-shaped parity ran no tall-A kernel")
    # the MoE family, 2 layers, fp32, drop-free (capacity factor 8):
    # OLMoE-1B-7B at its published widths, DeepSeek-V2 at its published
    # widths but 16 routed experts (160 fp32 experts are 15 GB a layer on
    # the host)
    for arch, cut, prompt in (("olmoe_1b_7b", {}, 256),
                              ("deepseek_v2_236b", {"num_experts": 16}, 128)):
        phase_parity(dataclasses.replace(
            get_config(arch), num_layers=2, dtype="float32",
            capacity_factor=8.0, **cut), 1, prompt,
            cut={"num_layers": 2, **cut})
    # the SSM family, 2 layers (Zamba2-2.7B 12: two groups, so the shared
    # block's weights serve two K/V caches), float32, at full width
    for arch, layers in (("mamba2_780m", 2), ("zamba2_2_7b", 12)):
        phase_parity(dataclasses.replace(get_config(arch), num_layers=layers,
                                         dtype="float32"), 1, 256,
                     cut={"num_layers": layers})
    # the rest of the zoo, float32, each cut on its line: h2o-danube-1.8b
    # at full width, 2 layers, its window cut to 256 under a 384-token
    # prompt (the prefill rolls); the LLaVA-NeXT backbone at full width,
    # 2 layers, 64 seeded image embeddings + 64 tokens; whisper-base whole
    # (6 + 6 layers, 1500 seeded frames, a 4-token decoder prompt); and
    # llama3-405b's reduced config widened so every leaf packs (one fp32
    # layer at full width, its embedding and head are ~30 GB on the host)
    for arch, cut, prompt in (
            ("h2o_danube_1_8b", {"num_layers": 2, "sliding_window": 256},
             384),
            ("llava_next_mistral_7b", {"num_layers": 2,
                                       "num_image_tokens": 64}, 64),
            ("whisper_base", {}, 4)):
        phase_parity(dataclasses.replace(get_config(arch), dtype="float32",
                                         **cut), 1, prompt, cut=cut or None)
    phase_parity(get_config("llama3_405b").reduced(**LLAMA3_PARITY), 1, 256,
                 cut={"reduced": True, **LLAMA3_PARITY})
    parity_designs = {d for p, v in FP32_PATHS.items()
                      if p.startswith("parity.") for d in v["designs"]}
    if parity_designs != FP32_SKINNY_DESIGNS:
        raise AssertionError(f"the fp32 parity paths ran skinny designs "
                             f"{sorted(parity_designs)}, not both of "
                             f"{sorted(FP32_SKINNY_DESIGNS)}")
    qwen_launches, _ = phase_serve("serve")
    glm_launches, glm_load = phase_serve("serve.glm4")
    phase_queue_parity(dataclasses.replace(get_config("qwen1_5_4b"),
                                           num_layers=2, dtype="float32"))
    queue_launches, queue_load, eng, reqs, results, stats = phase_queue(
        dataclasses.replace(get_config("qwen1_5_4b"),
                            **HALF_DEPTH["qwen1_5_4b"]))
    phase_queue_frontend(eng, reqs, results, stats)
    del eng
    by_path = {"paper": paper_launches, "queue": queue_launches}
    by_path["serve.olmoe"], olmoe_load = phase_serve("serve.olmoe")
    by_path["queue.olmoe"], olmoe_queue_load, eng, *_ = phase_queue(
        dataclasses.replace(get_config("olmoe_1b_7b"),
                            **HALF_DEPTH["olmoe_1b_7b"]),
        n=8, path="queue.olmoe", extras=False)
    del eng
    by_path["serve.deepseek"], deepseek_load = phase_serve("serve.deepseek")
    by_path["serve.mamba2"], mamba2_load = phase_serve("serve.mamba2")
    by_path["serve.zamba2"], zamba2_load = phase_serve("serve.zamba2")
    # the rest of the zoo: h2o-danube-1.8b, the LLaVA-NeXT backbone and
    # whisper-base whole, llama3-405b at full width cut to 2 layers
    zoo_load = {}
    for path in ZOO:
        by_path[path], zoo_load[path] = phase_serve(path)
    phase_resilience()
    phase_fleet()

    # each row: its case at the shape of the serve path that runs it, and
    # the launches of that path; a kernel the measured plans keep off the
    # serve paths counts the install path's launches (its measured
    # candidates and the grammar check)
    picks = {
        "tsmm_skinny_a": (dict(mode="baseline", m=1024, K=2560, N=6912),
                          "serve", qwen_launches),
        "skinny_kinner": (dict(mode="resident", m=4, K=2560, N=151936),
                          "serve", qwen_launches),
        "skinny_ksplit": (dict(mode="ksplit2", m=4, K=2560, N=6912),
                          "serve", qwen_launches),
        "flash_attention": (dict(mode="causal", B=1, S=2048, H=32, KH=2),
                            "serve.glm4", glm_launches),
        "tsmm_tall_a": (dict(mode="baseline"), "serve.glm4", glm_launches),
        "tsmm_packed_a": (dict(mode="packed"), "serve.glm4", glm_launches),
        "tall_kinner": (dict(mode="resident"), "serve.glm4", glm_launches),
        "tall_ksplit": (dict(mode="ksplit2"), "serve.glm4", glm_launches),
        "tall_kouter": (dict(mode="kouter"), "serve.glm4", glm_launches),
        "pack_blocks": (dict(mode="decode"), "serve.glm4", glm_launches),
    }
    picks = {name: (want, path, launches) if launches.get(name, 0)
             else (want, "install", install_launches)
             for name, (want, path, launches) in picks.items()}
    tol = (f"every case: |err| <= atol + rtol*|plain|, bf16 outputs "
           f"{BF16_TOL}, fp32 raw/partial/accumulated outputs {F32_TOL}; "
           f"pack_blocks bit-equal")
    line = []
    for name, (src, rep) in KERNELS.items():
        want, path, launches = picks[name]
        c = next(c for c in cases if c["kernel"] == name
                 and c.get("dtype") != "float32"
                 and all(c.get(k) == v for k, v in want.items()))
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "design": c["design"],
                     "launches": launches.get(name, 0),
                     "launches_path": path,
                     "launches_by_path": {
                         path: launches.get(name, 0),
                         **{p: ls.get(name, 0) for p, ls in by_path.items()}},
                     "max_abs_err": worst[name], "tol": tol, "ms": c["ms"],
                     "device_ms": c.get("device_ms"),
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"], "shape": shape_of(c)})
    # the pack's row also carries its other shapes and its launches on
    # each path (load, decode, the packed tall family)
    pack = next(r for r in line if r["name"] == "pack_blocks")
    pack["launches_by_path"] = {
        "queue.load": queue_load.get("pack_blocks", 0),
        "serve.glm4.load": glm_load.get("pack_blocks", 0),
        "serve.glm4": glm_launches.get("pack_blocks", 0),
        "serve.olmoe.load": olmoe_load.get("pack_blocks", 0),
        "queue.olmoe.load": olmoe_queue_load.get("pack_blocks", 0),
        "serve.deepseek.load": deepseek_load.get("pack_blocks", 0),
        "serve.mamba2.load": mamba2_load.get("pack_blocks", 0),
        "serve.zamba2.load": zamba2_load.get("pack_blocks", 0),
        **{f"{p}.load": ls.get("pack_blocks", 0)
           for p, ls in zoo_load.items()},
        "install": install_launches.get("pack_blocks", 0),
        "tall": tall_launches.get("pack_blocks", 0),
        **{p: ls.get("pack_blocks", 0) for p, ls in by_path.items()}}
    pack["shapes"] = [
        {**shape_of(c), **{k: c[k] for k in ("design", "ms", "device_ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms")}}
        for c in cases if c["kernel"] == "pack_blocks"]
    # the fp32 paper path by design (every tall launch on tall-A's fp32
    # designs): each tall row carries the planned rows it ran, and the
    # ``fp32`` rows at N = 4, 32, 128, 240 (the design, its kernel's ms and
    # device_ms, the bound at the design's rate beside the fp32 FMA bound,
    # torch.matmul); the pack row its case at the paper's shape
    fields = ("kernel", "design", "launch_plan", "blocks", "kernel_ms",
              "kernel_device_ms", "bound_ms", "bound_by", "bound_ms_fp32",
              "library_ms", "max_abs_err", "tol")
    for r in line:
        if r["name"] in TALL:
            r["paper"] = [
                {"n": p["n"], "M": p["M"], "K": p["K"], "dtype": "float32",
                 **{k: p["planned"][k] for k in fields}}
                for p in paper_rows if p["planned"]["launch"] == r["name"]]
        family = ("pack_" if r["name"] == "pack_blocks"
                  else "tall_" if r["name"] in TALL else None)
        r["paper_design_launches"] = {
            k: v for k, v in paper_designs.items()
            if family and k.startswith(family)}
    fp32 = [{"n": p["n"], "M": p["M"], "K": p["K"],
             "launch": p["planned"]["launch"],
             **{k: p["planned"][k] for k in fields}}
            for p in paper_rows if p["n"] in PAPER_FP32_N]
    for r in line:
        if r["name"] in TALL:
            r["fp32"] = fp32
    pack["paper"] = paper_pack
    # each skinny row also carries its fp32 cases (``f32`` / ``tf32x3``:
    # ms, device_ms, plain, torch.matmul, the bound at the design's rate
    # beside the FMA bound), its launches on each fp32-only path and the
    # fp32 designs each path ran (the install and gate paths run bf16
    # launches of the same kernels too)
    fp32_fields = ("mode", "design", "launch_plan", "m", "K", "N",
                   "max_abs_err", "ms", "device_ms", "plain_ms",
                   "library_ms", "bound_ms", "bound_by", "bound_ms_fma")
    for r in line:
        if r["name"] in SKINNY:
            r["fp32_skinny"] = [
                {k: c[k] for k in fp32_fields} for c in cases
                if c["kernel"] == r["name"] and c.get("dtype") == "float32"]
            r["fp32_max_abs_err"] = worst[f"{r['name']}.fp32"]
            r["fp32_launches_by_path"] = {
                p: v["launches"][r["name"]] for p, v in FP32_PATHS.items()
                if "launches" in v}
            r["fp32_design_launches_by_path"] = {
                p: v["designs"] for p, v in FP32_PATHS.items()}
    # the flash row also carries Zamba2's head dim (80), whisper-base's
    # (64) and the LLaVA-NeXT backbone's 3072 positions at their
    # prefills, each with its launches on its path
    flash = next(r for r in line if r["name"] == "flash_attention")
    flash_paths = {(80, 2048): "serve.zamba2", (64, 256): "serve.whisper",
                   (128, 3072): "serve.llava"}
    flash["cases"] = [
        {**shape_of(c), "launches_path": flash_paths[(c["D"], c["S"])],
         "launches": by_path[flash_paths[(c["D"], c["S"])]].get(
             "flash_attention", 0),
         **{k: c[k] for k in ("design", "max_abs_err", "ms", "device_ms",
                              "plain_ms", "library_ms", "bound_ms",
                              "bound_by")}}
        for c in cases if c["kernel"] == "flash_attention"
        and (c["D"], c["S"]) in flash_paths]
    if (len(flash["cases"]) != len(flash_paths)
            or not all(c["launches"] for c in flash["cases"])):
        raise AssertionError(f"flash at D = 80 / 64 / 128 x 3072: "
                             f"{flash['cases']}")
    # the skinny-A row also carries its bias + GELU cases (whisper-base's
    # w_in), with its bias + GELU epilogue launches on serve.whisper
    skinny = next(r for r in line if r["name"] == "tsmm_skinny_a")
    skinny["bias_gelu"] = [
        {**shape_of(c), "launches_path": "serve.whisper",
         "launches": EPILOGUES["serve.whisper"].get(
             "tsmm_skinny_a/bias_gelu", 0),
         **{k: c[k] for k in ("design", "max_abs_err", "ms", "device_ms",
                              "plain_ms", "library_ms", "library_call",
                              "bound_ms", "bound_by")}}
        for c in cases if c["kernel"] == "tsmm_skinny_a"
        and c["mode"] == "bias_gelu"]
    # the skinny rows and the pack row also carry llama3-405b's head and
    # w_down cases, each with its kernel's launches on serve.llama3 (the
    # pack's at that path's load)
    for r in line:
        if r["name"] not in SKINNY and r["name"] != "pack_blocks":
            continue
        lp, ls = (("serve.llama3.load", zoo_load["serve.llama3"])
                  if r["name"] == "pack_blocks"
                  else ("serve.llama3", by_path["serve.llama3"]))
        r["llama3"] = [
            {**shape_of(c), "leaf": c["leaf"], "launches_path": lp,
             "launches": ls.get(r["name"], 0),
             **{k: c[k] for k in ("design", "max_abs_err", "ms",
                                  "device_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}}
            for c in cases if c["kernel"] == r["name"] and "leaf" in c]
    bad = [r["name"] for r in line if r["launches"] == 0]
    if bad:
        raise AssertionError(f"kernels with no launch on a path: {bad}")
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
