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
7. serve      — qwen1.5-4b at full width, 5 of its 40 layers, bf16,
                seeded random weights, through ``Engine(max_batch=4)``:
                request groups of 1, 3 and 4 with 256-token prompts and 16
                greedy steps;
8. serve.glm4 — GLM-4-9B at full width, 5 of its 40 layers, bf16,
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
10. queue     — qwen1.5-4b at full width, 5 layers, bf16, on a queue
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
12. serve.olmoe — OLMoE-1B-7B at its published dims, 4 of its 16 layers (64
                experts, top-8), bf16, seeded random weights,
                ``Engine(max_batch=4)``: groups of 1, 3 and 4 with
                256-token prompts and 16 greedy steps; prints
                ``param_count`` / ``active_param_count`` and the profile
                of a bucket-4 step with the ``moe_experts`` and
                ``moe_dispatch`` families;
13. queue.olmoe — OLMoE-1B-7B (4 layers) on a queue engine of its own (4
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
15. serve.mamba2 — Mamba2-780m at full width, 6 of its 48 layers, bf16,
                ``Engine(max_batch=4)``: groups of 1, 3 and 4 with
                256-token prompts and 16 steps; every Mamba leaf, and the
                tied head as a packed copy of the table's transpose, packed
                at load; no pack launch and no flash launch on the path;
16. serve.zamba2 — Zamba2-2.7B at full width, 12 of its 54 Mamba2
                layers (the shared attention + MLP block applied 2
                times), bf16,
                ``Engine(max_batch=2)``: groups of 1 and 2 with 2048-token
                prompts and 8 steps; every leaf packed at load, no pack
                launch on the path, and the 2048-token prefill cells
                launch flash at D 80.  Both SSM paths also print the
                eager profile of one prefill (the ``ssm_conv``,
                ``ssm_scan`` and ``ssm_state`` families);
17. serve.danube — h2o-danube-1.8b at full width, 6 of its 24 layers
                (window 4096), bf16,
                ``Engine(max_batch=2)`` whose length grid holds exactly
                its two prompts: groups of 1 and 2 at 4352 tokens (the
                prefill rolls past the window) and at 4088 (the graphed
                decode crosses slot 4095 -> 0 at position 4096, checked
                on each bucket's cache), 16 steps; windowed attention
                takes the chunked body: flash must not launch;
18. serve.llava — the LLaVA-NeXT Mistral-7B backbone at full width, 4
                of its 32 layers,
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
                and jobs per minute;
23. train     — training (``train/``, ``optim/``, ``ckpt/``,
                ``launch/train.py``), which runs no hand-written kernel:
                train.parity (qwen1.5-4b at full width, 2 layers, fp32,
                1 x 256 tokens, where the flash gate would open at
                inference: two train steps from one seeded init on the
                card and on the CPU; the loss, ``grad_norm`` and every
                param leaf within ``F32_TOL``, both moments (the
                gradients) within ``F32_TOL`` scaled to each leaf, every
                gradient finite and nonzero, 0 launches of any kernel);
                train.run (full width cut to 4 layers, bf16 compute on
                fp32 masters, remat, 4 x 1024 tokens, 6 steps through
                ``train.loop.run``: step seconds against 6 N T / 989
                TFLOP/s, tokens per second, peak memory, the checkpoint's
                bytes and the seconds its save held the loop; finite
                losses, 0 launches); train.resume (a reduced, widened
                qwen: a simulated failure at step 3 of 6, the resumed run
                runs only the rest and ends within 2e-2 of a clean run's
                loss); train.cli (``python -m repro_torch.launch.train
                --reduced --steps 3`` on the card, its summary line).
                Prints the phase's seconds;
24. tp        — tensor-parallel serving and the distributed TSMM
                (``sharding/``, ``launch/mesh.py``, ``Engine(mesh=)``):
                ``install --mesh model=2`` for qwen1.5-4b (buckets 1, 2,
                4; prompts to 256: the five per-shard problems); two
                ranks (``python -m torch.distributed.run``, this script
                with ``--tp-worker``) share the card over gloo and serve
                qwen1.5-4b at full width cut to 4 layers, bf16, lookup
                only: groups of 1 and 4 x 256 tokens, 16 decode steps,
                then a 5-request queue (the ``tp`` main path: counts
                zeroed just before, read just after; every bf16 skinny
                launch on ``skinny_wgmma`` / ``skinny_stream``, flash
                launched, a healthy engine, gloo cells eager and a
                capture refused); one decode call's collectives equal to
                the contract from the shapes (2 all-reduces a layer, the
                lookup's, one logits all-gather, with their bytes); rank
                0's logits within ``TP_LOGITS_TOL`` of a one-rank engine
                on the same weights; ``distributed_tsmm`` at the paper's
                A (25600 x 25600 fp32, 12800 rows a rank, packed once,
                N 4 and 240) within 1e-2 + 1e-2·|ref| of the one-rank
                planned row with 0 collectives and a tall launch, and
                ``conventional_ksplit`` with exactly 1 all-reduce;
                ``overlapped_ring_tsmm`` at 4096 x 4096 x 64 within the
                K-scaled fp32 tolerance of ``torch.matmul``, its 2 sends
                staged
                through the host (gloo's send / recv take host memory;
                named on the ``tp`` line); then in this process NCCL at
                world size 1: the TP engine's
                grid captured with its collectives, every cell bit-equal
                to its eager run, a graphed group equal to an eager one.
                The same ranks then serve the MoE family (``TP_MOE``,
                after ``install --mesh model=2`` for both, their per-shard
                skinny leaves and packs held against the plain versions
                at decode and prefill rows): OLMoE-1B-7B at its published
                widths cut to 4 layers (32 experts and 8 heads a rank;
                groups of 1 and 4 x 256 tokens, 8 steps, a 3-request
                queue; flash launched) and DeepSeek-V2 at its published
                widths cut to 2 layers (the dense layer and one MoE layer
                of 160 experts, 80 a rank, 2 shared, top-6; 64 MLA heads
                a rank, the latent cache split along its sequence; groups
                of 1 and 2 x 512 tokens, 4 steps; no flash), each rank
                drawing every seeded leaf whole and keeping its piece;
                each decode call's collectives equal to
                ``tp_moe_contract``, 0 misses, a healthy engine, the
                rank's pieces only; rank 0 against a one-rank engine on
                the same weights (``tp_moe_compare``): the tokens whose
                top-k expert set (or an entry's drop) differs counted by
                layer with their probability gaps, every row's
                per-position prefill logits up to its first change and
                the first decode step of the rows with none and an
                agreeing input within ``TP_LOGITS_TOL``; then, the
                one-rank engine taking rank 0's expert choices, every
                position's prefill logits and every agreeing row's first
                decode step within it; in the first MoE layer every
                flip's one-rank gap under ``TP_MOE_GAP`` and at most
                ``TP_MOE_FLIPS`` of its tokens flipped; the planted
                controls (``TP_MOE_FAULTS``: every MoE layer's sum
                skipped, the router's columns gathered in the reverse
                order, and DeepSeek's MLA combine over the rank's own
                slots only), each outside the bound by its multiple at
                every bucket, the reversed router outside both limits
                of the routing bound too; and OLMoE's grid under NCCL at
                world size 1, captured and bit-equal to eager.
                ``python3 chip_smoke.py --phase tp`` runs env, build and
                this phase alone;
25. tp2d      — 2D weight-stationary tensor parallelism and FSDP serving
                (``ShardingOptions(fsdp=True, serve_2d_tp=True)`` and
                ``ShardingOptions(fsdp=True)`` through ``Engine(mesh=,
                opts=)``): ``install_arch(mesh=, opts=)`` for both modes
                at ``data=2,model=2``; each per-rank skinny leaf (the 2D
                pieces at K/2 and m 1, 4, FSDP's gathered weights at m 1,
                2) and each pack held against its plain version; four
                ranks (this script with ``--tp2d-worker``) share the card
                over gloo and serve qwen1.5-4b at full width cut to 2
                layers, bf16, seeded QKV biases and norm scales, lookup
                only, in each mode: groups of 1, 2 and 4 x 256 tokens
                (bucket 1 puts the cache's sequence on ``data``, 2 and 4
                its rows), 4 decode steps, then a 3-request queue (the
                ``tp2d`` main path: counts zeroed just before, read just
                after); each decode call's collectives equal to the
                contract from the shapes (``tp2d_contract``), the 2D
                decode moving fewer bytes than FSDP's at every bucket,
                each rank holding only its pieces, 0 misses, a healthy
                engine, skinny and flash launches; rank 0's logits
                within ``TP2D_LOGITS_TOL`` of a one-rank engine on the
                same weights in both modes, and a planted fault (layer
                0's ``w_gate`` sum over ``data`` skipped) at least
                ``TP2D_PLANTED`` x outside it; then in this process NCCL
                at world size 1 (``data=1,model=1``, 2D): the grid
                captured with the k-split sums, the gathers and the TP
                sums inside, every cell bit-equal to its eager run, a
                graphed group equal to an eager one, the decode call's
                collectives the contract.  In the same ranks, after the
                MoE family's paths (``TP2D_MOE``), the SSM family and the
                hybrid (``TP2D_SSM``, each after its own sweeps, at
                published widths, bf16, seeded, each rank drawing every
                leaf whole and keeping its piece): Mamba2-780m cut to 2
                layers under 2D at buckets 1 and 4 x 256 (4 steps; at
                bucket 4 the recurrent state's and the conv window's rows
                on ``data``, each rank's conv, scan and state update on
                its rows, the per-row output gathered) and under FSDP at
                bucket 4 (2 steps), and Zamba2-2.7B cut to 6 layers (one
                application of the shared block, flash at D 80 on 16
                heads a rank) under 2D at buckets 1 and 2 x 512 (4 steps;
                bucket 1's K/V slots on ``data`` and its state whole,
                bucket 2's both with their rows on ``data``) and under
                FSDP at bucket 2 (2 steps); each per-rank skinny piece
                (``TP2D_SSM_LEAVES``: ``w_in`` by segments, zero-padded
                to whole blocks, ``w_out``, the head, Zamba2's shared
                projections over their [x, x0] rows) at the paths' decode
                and prefill rows and each pack held against its plain
                version, every skinny launch of the paths at a held key;
                each decode call's collectives equal to
                ``tp2d_ssm_contract``, no weight piece gathered in a 2D
                decode call and 2D moving fewer bytes than FSDP, 0 misses,
                a healthy engine, the rank's pieces only; rank 0 within
                ``TP_LOGITS_TOL`` of a one-rank engine on the same weights
                at every prefill position and the first decode step, and
                the planted controls (``tp2d_ssm_planted``: the per-row
                output gathered in the reverse data order, the shared
                block fed ``[x, x]``, ``w_in``'s halves gathered in the
                reverse order) outside it; Zamba2's grid under NCCL at
                world size 1 (``tp2d.ssm.nccl``).  Then the VLM and
                encoder-decoder families in the same ranks
                (``TP2D_FAMILIES``, after their own sweeps, at published
                widths, bf16, the norms and GELU biases seeded away from
                their init): the LLaVA-NeXT backbone cut to 2 layers
                (2880 seeded image embeddings ahead of 192 tokens, flash
                at D 128) and whisper-base whole (1500 seeded frames,
                flash at D 64 on the decoder's 256 tokens), each under 2D
                at buckets 1 and 2 (4 steps; whisper's cross cache whole
                at bucket 1, its rows on ``data`` at bucket 2) and under
                FSDP at bucket 2 (2 steps); each per-rank skinny piece
                (``TP2D_FAMILY_LEAVES``) at the paths' decode and prefill
                rows (LLaVA's bucket x 3072 positions, whisper's bucket x
                1500 frames and x 256 tokens) and each pack held against
                its plain version, every skinny launch of the paths at a
                held key; each decode call's collectives equal to
                ``tp2d_contract``, no weight piece gathered in a 2D
                decode call and 2D moving fewer bytes than FSDP, 0
                misses, a healthy engine, the rank's pieces only; rank 0
                within ``TP_LOGITS_TOL`` of a one-rank engine on the same
                weights at every prefill position, the first decode step
                and whisper's cross cache, and the planted controls
                (``tp2d_family_planted``: the image embeddings zeroed on
                rank 1, the cross cache's first rows read by every data
                rank, ``w_in``'s bias and GELU applied before the data
                sum, the MLP in-projections' halves gathered in the
                reverse order) outside it; whisper's grid under NCCL at
                world size 1 (``tp2d.family.nccl``).  ``python3
                chip_smoke.py --phase tp2d`` runs env, build and this
                phase alone;
26. train.dist — sharded training (``train/`` on a process mesh,
                ``sharding/comm.py``'s collectives with gradients,
                ``launch/specs.py``), which runs no hand-written kernel:
                two ranks (this script with ``--train-dist-worker``) share
                the card over gloo and train qwen1.5-4b at full width cut
                to 2 layers, bf16 on fp32 masters, remat, a global batch
                of 4 x 512 tokens, 3 steps on each of ``data=2``,
                ``data=2`` with FSDP and ``model=2``; each rank holds the
                one-rank step from the same seeded params and batch, and
                its pieces must hold within ``TRAIN_DIST_TOL``: the step-0
                loss and ``grad_norm``, the params, m and v after the
                first update; each step's collectives equal to the
                contract from the shapes, none staged; 0 hand-written
                launches; a planted control (*f*'s backward all-reduce
                skipped at ``model=2``) must land outside the bound; a
                checkpoint saved at ``data=2`` with FSDP (a failure after
                step 2 of 4, reduced qwen at d 1024) restores at
                ``model=2`` and on one rank, both continuing within the
                loss bound of an uninterrupted one-rank run; then in this
                process NCCL at world size 1: one train step on a
                ``model=1`` process mesh against the one-rank step, its
                collectives the contract.  After qwen's meshes the same
                ranks train OLMoE-1B-7B (``train.dist.moe``: published
                widths, 2 layers, bf16, remat, 4 x 256 tokens, 2 steps
                on each of the three meshes, ``model=2`` splitting the
                experts); each mesh records step 0's routing by layer
                (``moe_layer_routes``), the one-rank step on the card
                then takes it (every data rank's rows in global order,
                dispatched in the mesh's groups) and each rank's first
                update must hold within ``TRAIN_DIST_TOL`` (the aux loss
                within ``TRAIN_DIST_AUX_TOL``), the flips of the one-rank
                step's own top-k reported by layer; each step's
                collectives the contract (the router gather, the
                expert counts' all-reduce, the MoE sum, the *f*s), 0
                hand-written launches; two planted controls (the aux
                over the rank's tokens on ``data=2``, the routed
                experts' *f* skipped on ``model=2``) must land outside
                the bound.  Prints per rank each mesh's peak memory,
                ``step_s`` and collective bytes (two ranks on one card:
                no speed).  ``python3 chip_smoke.py --phase train.dist``
                runs this phase alone.

The serve and queue paths of qwen1.5-4b, OLMoE-1B-7B, Mamba2-780m,
Zamba2-2.7B, h2o-danube-1.8b, GLM-4-9B and the LLaVA-NeXT backbone run
cut in depth (``HALF_DEPTH``: a quarter or an eighth of each), so that with the
paths of
whisper-base and llama3-405b, tp, tp2d and train.dist the script stays
inside its time limit (each model fits the card whole; the cut only
shortens the run, every width and kernel shape as at full depth).
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
serve.llava, serve.whisper, serve.llama3, tp) zeroes the
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
with their launches on serve.llama3; every row each tp rank's launches
on the tp path (``tp.rank0``, ``tp.rank1``) and its MoE paths
(``tp.moe.olmoe.rank0`` ...), at their load (the pack's)
and in ``distributed_tsmm`` at N = 4 and 240 (the tall rows'); each tall row the paper's planned rows it ran and the fp32
rows at N = 4, 32, 128, 240 (``f32`` or ``tf32x3``: ms, device_ms, the
bound at the design's rate beside the FMA bound, torch.matmul), each
skinny row its ``fp32_skinny`` cases and its fp32 launches on the
install, gate, parity and queue.parity paths, and the pack row its case
at the paper's shape) and,
last, the ``{"ok": true, ...}`` line.  Any failure
raises and exits non-zero before the last line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

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


@contextlib.contextmanager
def launch_shapes():
    """The shapes of the skinny and pack kernels launched inside: a set of
    (kernel, m, K, N) per skinny launch (N the columns the kernel writes,
    a packed weight's padded ones included) and ("pack_blocks", M, K, bm,
    bk) per pack.  Held cases and the ranks' main paths record alike, so a
    launch is held where its key is among the cases' keys."""
    from repro_torch.kernels import tsmm as kt
    seen = set()
    skinny, pack = kt.launch_skinny, kt.launch_pack

    def rec_skinny(name, x, w, bias, act, *, natural, **kw):
        out = skinny(name, x, w, bias, act, natural=natural, **kw)
        if not kt.plain(x, kw.get("impl"), name):
            n = w.shape[1] if natural else w.shape[1] * w.shape[3]
            seen.add((name, int(x.shape[0]), int(x.shape[1]), int(n)))
        return out

    def rec_pack(a, out, bm, bk, alpha, plan):
        seen.add(("pack_blocks", *(int(d) for d in a.shape[-2:]), bm, bk))
        return pack(a, out, bm, bk, alpha, plan)

    kt.launch_skinny, kt.launch_pack = rec_skinny, rec_pack
    try:
        yield seen
    finally:
        kt.launch_skinny, kt.launch_pack = skinny, pack


def unheld_shapes(launched, cases: list) -> list:
    """The launch keys of ``launched`` (``launch_shapes``' keys, as lists
    after JSON) that no case of ``cases`` launched."""
    held = {tuple(k) for c in cases for k in c.get("launched", ())}
    return sorted({tuple(k) for k in launched} - held)


def path_rows(rows, prompt: int, queue=()) -> tuple:
    """The rows a sharded path's products run at: its decode ``rows``,
    each group's prefill (``rows`` x ``prompt``) and the ``queue``'s
    admissions (under ``whole_rows`` one row, its prompt padded to its
    length bucket)."""
    from repro_torch.core.plan import bucket_for, length_buckets_for
    lbs = length_buckets_for(prompt)
    return tuple(sorted({*rows, *(r * prompt for r in rows),
                         *(bucket_for(n, lbs) for n, _ in queue)}))


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
    # 3072 positions, 32 query heads on 8 KV heads of 128), one rank's
    # 10 heads of qwen1.5-4b at model=2 (the tp path's prefill), and one
    # rank's heads on the tp.family paths (``TP_FAMILY_FLASH``)
    for b, s, h, kh, d in ((4, 256, 20, 20, 128), (4, 256, 10, 10, 128),
                           (1, 2048, 32, 2, 128),
                           (2, 2048, 32, 2, 128), (4, 256, 16, 16, 128),
                           (1, 2048, 32, 32, 80), (4, 256, 8, 8, 64),
                           (1, 3072, 32, 8, 128),
                           *TP_FAMILY_FLASH.values()):
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
               "load": (20, 4096, 13696, 128, 128),
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
            ("load", (HALF_DEPTH["glm4_9b"]["num_layers"], 4096, 13696),
             "GLM-4-9B's w_gate"),
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
                 min_prompt=spec.get("min_prompt", min(prompts)),
                 device="cuda")
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


# seven models' serve and queue paths cut in depth: OLMoE-1B-7B, Zamba2-2.7B
# and h2o-danube-1.8b to a quarter, qwen1.5-4b, GLM-4-9B, Mamba2-780m and
# the LLaVA-NeXT backbone to an eighth (paying for the tp phase's MoE paths
# and its other families), so the script ends well inside its time limit
# with the ZOO paths, tp, tp2d and train.dist (each model fits the card
# whole; Zamba2 keeps two whole groups of 6 Mamba layers)
HALF_DEPTH = {"qwen1_5_4b": {"num_layers": 5},
              "glm4_9b": {"num_layers": 5},
              "olmoe_1b_7b": {"num_layers": 4},
              "mamba2_780m": {"num_layers": 6},
              "zamba2_2_7b": {"num_layers": 12},
              "h2o_danube_1_8b": {"num_layers": 6},
              "llava_next_mistral_7b": {"num_layers": 4}}


# the serve paths: (arch, cut of the published config, max batch, prompt,
# decode steps, groups, the profiled batch, whether flash runs, the path's
# own checks).  Each path's grid holds its prompts' length buckets alone
# (``min_prompt``, default its shortest prompt): the queue paths capture
# every length bucket from 8 tokens (the program store's proof over the
# whole grid; their ragged admissions take them), qwen's on the same
# config as this path's.  The groups serve every batch bucket, so that
# each variant the install stamped runs (a group of 3 pads to 4).
# OLMoE-1B-7B, Mamba2-780m and Zamba2-2.7B whole;
# DeepSeek-V2 at its published widths cut to 3 layers (the dense first
# layer and 2 MoE layers: 160 experts x 3 x 5120 x 1536 bf16 = 7.55 GB a
# layer; 60 do not fit one card)
SERVE = {
    "serve": dict(arch="qwen1_5_4b", cut=HALF_DEPTH["qwen1_5_4b"],
                  max_batch=4, prompt=256,
                  steps=16, groups=(1, 2, 3, 4), profile_batch=4, flash=True,
                  hooks={"load": packed_load}),
    "serve.glm4": dict(arch="glm4_9b", cut=HALF_DEPTH["glm4_9b"],
                       max_batch=2, prompt=2048,
                       steps=8, groups=(1, 2), profile_batch=1, flash=True,
                       hooks={"load": glm_load, "group": glm_group,
                              "path": glm_path}),
    "serve.olmoe": dict(arch="olmoe_1b_7b", cut=HALF_DEPTH["olmoe_1b_7b"],
                        max_batch=4, prompt=256,
                        steps=16, groups=(1, 2, 3, 4), profile_batch=4,
                        flash=True, hooks={}),
    "serve.deepseek": dict(arch="deepseek_v2_236b", cut={"num_layers": 3},
                           max_batch=2, prompt=512, steps=8, groups=(1, 2),
                           profile_batch=2, flash=False,
                           hooks={"load": deepseek_load,
                                  "after": deepseek_after}),
    "serve.mamba2": dict(arch="mamba2_780m",
                         cut=HALF_DEPTH["mamba2_780m"], max_batch=4,
                         prompt=256,
                         steps=16, groups=(1, 2, 3, 4), profile_batch=4,
                         flash=False, hooks={"load": packed_load,
                                             "path": ssm_path,
                                             "after": ssm_after}),
    "serve.zamba2": dict(arch="zamba2_2_7b",
                         cut=HALF_DEPTH["zamba2_2_7b"], max_batch=2,
                         prompt=2048, steps=8, groups=(1, 2),
                         profile_batch=1, flash=True,
                         hooks={"load": packed_load, "path": ssm_path,
                                "after": ssm_after}),
    # h2o-danube-1.8b at half depth: a 4352-token prompt past the 4096
    # window (the rolled prefill) and a 4088-token one whose decode wraps;
    # the length grid holds exactly those two (min_prompt 4088).  Windowed
    # attention takes the chunked body, as in the reference: no flash
    "serve.danube": dict(arch="h2o_danube_1_8b",
                         cut=HALF_DEPTH["h2o_danube_1_8b"], max_batch=2,
                         prompt=4352, prompts=(4352, 4088), min_prompt=4088,
                         steps=16, groups=(1, 2), profile_batch=1,
                         flash=False, hooks={"load": packed_load,
                                             "path": window_path}),
    # the LLaVA-NeXT backbone at half depth: 2880 seeded image embeddings
    # + 192 tokens = 3072 positions, flash at D 128 on 32 query / 8 KV
    # heads
    "serve.llava": dict(arch="llava_next_mistral_7b",
                        cut=HALF_DEPTH["llava_next_mistral_7b"], max_batch=2,
                        prompt=192, steps=16, groups=(1, 2), profile_batch=1,
                        flash=True, hooks={"load": packed_load,
                                           "path": flash_path}),
    # whisper-base whole: 1500 seeded frames, a 256-token decoder prompt
    # (flash at D 64, causal); the encoder (1500 frames) and the cross
    # attention take the chunked body
    "serve.whisper": dict(arch="whisper_base", cut={}, max_batch=4,
                          prompt=256, steps=16, groups=(1, 2, 3, 4),
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



# the train phase: card vs CPU (qwen1.5-4b at full width, 2 layers, fp32,
# 1 x 256 tokens: the flash gate's shapes), the loop at full width (4
# layers, bf16, remat, 4 x 1024 tokens), resume and the launcher
TRAIN_PARITY = {"num_layers": 2, "dtype": "float32"}
TRAIN_RUN = {"num_layers": 4}
TRAIN_RUN_SHAPE = (4, 1024, 6)          # batch, tokens, steps
# resume on qwen1.5-4b's reduced config widened to a 128-wide head (vocab
# 512): the three runs write three checkpoints, which at full width would
# be 11 GB each
TRAIN_RESUME = {"d_model": 1024, "num_heads": 8, "num_kv_heads": 8,
                "head_dim": 128, "d_ff": 2048}
TRAIN_RESUME_SHAPE = (4, 256, 6, 3)     # batch, tokens, steps, fail_at


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def train_parity(device="cuda"):
    """Two train steps from one seeded init on the card and on the CPU.
    Each step: the loss and ``grad_norm`` within ``F32_TOL``; every
    param leaf within ``F32_TOL``; both moments, which carry the
    gradients (m = 0.1 x the clipped gradient after step 1), within
    ``F32_TOL`` scaled to the leaf (atol x max|CPU leaf| + rtol x |CPU|);
    every gradient finite and nonzero; no hand-written kernel launched."""
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.kernels import cuda
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step

    t_sub = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen1_5_4b"), **TRAIN_PARITY)
    model = build_model(cfg)
    ocfg = OptConfig()
    # one seeded init (on the card: the host's generator is ~10x slower),
    # its params copied to the CPU
    gpu = init_train_state(model, ocfg, generator=torch.Generator(
        device=device).manual_seed(0))
    cpu = init_train_state(model, ocfg, params=tree_map(
        lambda t: t.to("cpu"), gpu["params"]))
    names = ["/".join(p) for p in _paths(cpu["params"])]
    data = SyntheticData(cfg, ShapeSpec("train.parity", 256, 1, "train"),
                         seed=0, device="cpu")
    step = make_train_step(model, ocfg)
    rows = []
    for i in range(2):
        batch = data.batch(i)
        cuda.reset_launches()
        t0 = time.perf_counter()
        gpu, mg = step(gpu, {k: v.to(device) for k, v in batch.items()})
        float(mg["loss"])
        gpu_s = time.perf_counter() - t0
        launches = sum(cuda.launches.values())
        t0 = time.perf_counter()
        cpu, mc = step(cpu, batch)
        cpu_s = time.perf_counter() - t0
        worst, ok = {}, launches == 0
        for what in ("loss", "grad_norm"):
            good, err = within(mg[what].cpu(), mc[what], **F32_TOL)
            worst[what] = err
            ok = ok and good
        for key, tree, scaled in (("params", lambda s: s["params"], False),
                                  ("m", lambda s: s["opt"]["m"], True),
                                  ("v", lambda s: s["opt"]["v"], True)):
            errs = {}
            for name, a, b in zip(names, tree_leaves(tree(gpu)),
                                  tree_leaves(tree(cpu))):
                b = b.to(device)        # compared on the card: ~1 G values
                atol = F32_TOL["atol"] * (float(b.abs().max()) if scaled
                                          else 1.0)
                good, err = within(a, b, rtol=F32_TOL["rtol"], atol=atol)
                errs[name] = err / (float(b.abs().max()) if scaled else 1.0)
                ok = ok and good and bool(torch.isfinite(a).all())
                if key == "m" and not float(a.abs().max()) > 0:
                    raise AssertionError(f"train.parity: step {i}: the "
                                         f"gradient of {name} is zero")
            worst[key] = errs
        rows.append({"step": i, "loss": float(mg["loss"]),
                     "loss_cpu": float(mc["loss"]),
                     "grad_norm": float(mg["grad_norm"]),
                     "grad_norm_cpu": float(mc["grad_norm"]),
                     "launches": launches, "gpu_s": gpu_s, "cpu_s": cpu_s,
                     "worst": worst, "ok": ok})
        if not ok:
            raise AssertionError(f"train.parity: {rows[-1]}")
    emit({"phase": "train.parity", "config": cfg.name,
          "d_model": cfg.d_model, "heads": cfg.num_heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "cut": TRAIN_PARITY, "batch": 1,
          "tokens": 256, "remat": cfg.remat, "steps": rows,
          "tol": F32_TOL, "tol_rule": "params: F32_TOL; m, v (the "
          "gradients): atol x max|CPU leaf| + rtol x |CPU|, printed as "
          "max|err| / max|CPU leaf|; loss, grad_norm: F32_TOL",
          "hand_written_launches": sum(r["launches"] for r in rows),
          "seconds": time.perf_counter() - t_sub})


def _paths(tree, path=()):
    """Each leaf's key path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


def train_run(device="cuda"):
    """qwen1.5-4b at full width cut to ``TRAIN_RUN``'s depth, bf16 compute
    on fp32 masters, remat on, through ``train.loop.run`` on the card:
    step seconds against the tensor-core bound, peak memory, the
    checkpoint's bytes and seconds; finite losses; no hand-written kernel
    launched."""
    import statistics

    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.kernels import cuda
    from repro_torch.models.registry import build_model, param_count
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import LoopConfig, run

    t_sub = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen1_5_4b"), **TRAIN_RUN)
    model = build_model(cfg)
    b, s, steps = TRAIN_RUN_SHAPE
    ck = tempfile.mkdtemp(prefix="train-", dir=os.path.join(ROOT, "build"))
    try:
        before = (torch.cuda.memory_allocated() if device == "cuda"
                  else None)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        t0 = time.perf_counter()
        report = run(model, ShapeSpec("train.run", s, b, "train"),
                     LoopConfig(total_steps=steps, ckpt_every=steps,
                                log_every=steps, ckpt_dir=ck),
                     OptConfig(), device=device)
        wall = time.perf_counter() - t0
        launches = sum(cuda.launches.values())
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else None)
        ck_bytes = _dir_bytes(ck)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    n = param_count(model)
    step_s = statistics.median(report.step_times[1:])
    prof = profile_train_step(model, ShapeSpec("train.run", s, b, "train"),
                              device)
    bound_s = 6 * n * b * s / PEAK_BF16_FLOPS
    row = {"phase": "train.run", "config": cfg.name, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "cut": TRAIN_RUN, "dtype": cfg.dtype,
           "masters": "float32", "remat": cfg.remat, "params": n,
           "batch": b, "tokens": s, "steps": report.steps_run,
           "losses": report.losses, "step_times": report.step_times,
           "step_s": step_s, "tokens_per_s": b * s / step_s,
           "bound_s": bound_s, "bound_rule": "6 x params x tokens / 989 "
           "TFLOP/s (bf16 dense peak)", "step_over_bound": step_s / bound_s,
           "peak_bytes": peak, "allocated_before_bytes": before,
           "ckpt_bytes": ck_bytes,
           "save_s": report.save_s, "wall_s": wall,
           "hand_written_launches": launches,
           "stragglers": report.straggler_steps,
           "profile": {**prof, "device_share_of_step_s":
                       prof["device_ms"] / 1e3 / step_s}}
    row["seconds"] = time.perf_counter() - t_sub
    emit(row)
    if (report.steps_run != steps or launches
            or not all(math.isfinite(x) for x in report.losses)):
        raise AssertionError(f"train.run: {row}")


# cuBLAS / CUTLASS GEMM kernels, by name
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def profile_train_step(model, shape, device="cuda") -> dict:
    """One train step of ``model`` at ``shape`` under ``torch.profiler``,
    after a warm step, from a fresh seeded state: the device ms of its
    kernels by family: the GEMMs (forward and backward, by kernel name),
    AdamW (the kernels inside ``optim.adamw.UPDATE_RANGE``) and the rest
    (norms, RoPE, the chunked attention's masked softmax, the fp32
    cross-entropy over the vocabulary, the casts, the gradients' adds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.launch.profile_decode import range_device_ms
    from repro_torch.optim.adamw import UPDATE_RANGE, OptConfig
    from repro_torch.train.step import init_train_state, make_train_step

    ocfg = OptConfig()
    state = init_train_state(model, ocfg, generator=torch.Generator(
        device=device).manual_seed(1))
    data = SyntheticData(model.cfg, shape, device=device)
    step = make_train_step(model, ocfg)
    state, m = step(state, data.batch(0))
    float(m["loss"])
    batch = data.batch(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        float(m["loss"])
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and e.key != UPDATE_RANGE]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if any(k in e.key.lower() for k in GEMM_KERNELS)) / 1e3
    adamw = range_device_ms(prof, UPDATE_RANGE)
    return {"device_ms": total, "gemm_ms": gemm, "adamw_ms": adamw,
            "other_ms": total - gemm - adamw,
            "kernels": sum(e.count for e in kernels)}


def train_resume(device="cuda"):
    """The reference's resume test on the card: a run that fails in its
    middle, then resumes (only the rest of the steps run) and ends within
    2e-2 of a clean run's final loss."""
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import (LoopConfig, SimulatedFailure, run)

    t_sub = time.perf_counter()
    cfg = get_config("qwen1_5_4b").reduced(**TRAIN_RESUME)
    model = build_model(cfg)
    b, s, steps, fail_at = TRAIN_RESUME_SHAPE
    shape = ShapeSpec("train.resume", s, b, "train")
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=steps)
    ck = tempfile.mkdtemp(prefix="resume-", dir=os.path.join(ROOT, "build"))
    try:
        lcfg = LoopConfig(total_steps=steps, ckpt_every=fail_at,
                          log_every=steps, ckpt_dir=os.path.join(ck, "a"))
        try:
            run(model, shape, lcfg, ocfg, device=device, fail_at=fail_at)
            raise AssertionError("train.resume: no simulated failure")
        except SimulatedFailure:
            pass
        resumed = run(model, shape, lcfg, ocfg, device=device)
        clean = run(model, shape, dataclasses.replace(
            lcfg, ckpt_dir=os.path.join(ck, "b")), ocfg, device=device)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    gap = abs(clean.losses[-1] - resumed.losses[-1])
    row = {"phase": "train.resume", "config": cfg.name,
           "cut": {"reduced": True, **TRAIN_RESUME}, "dtype": cfg.dtype,
           "batch": b, "tokens": s, "steps": steps, "fail_at": fail_at,
           "resumed_from": resumed.resumed_from,
           "steps_run": resumed.steps_run, "losses_resumed": resumed.losses,
           "losses_clean": clean.losses, "final_gap": gap, "tol": 2e-2,
           "seconds": time.perf_counter() - t_sub}
    emit(row)
    if (resumed.resumed_from != fail_at
            or resumed.steps_run != steps - fail_at or not gap < 2e-2
            or not torch.isfinite(torch.tensor(clean.losses)).all()):
        raise AssertionError(f"train.resume: {row}")


def start_train_cli(device="cuda"):
    """``python -m repro_torch.launch.train --reduced --steps 3`` on the
    card, in a process of its own, started in the background (it runs
    beside train.parity's CPU half); :func:`finish_train_cli` reads it."""
    ck = tempfile.mkdtemp(prefix="cli-", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "3", "--device", device, "--ckpt-dir", ck],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, ck, time.perf_counter()


def finish_train_cli(cli):
    """Wait for the launcher; its summary line echoed."""
    proc, ck, t0 = cli
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(ck, ignore_errors=True)
    lines = out.strip().splitlines()
    summary = lines[-1] if lines else ""
    emit({"phase": "train.cli", "rc": proc.returncode, "summary": summary,
          "wall_s_beside_parity": time.perf_counter() - t0})
    if proc.returncode != 0 or not summary.startswith("ran 3 steps; loss "):
        raise AssertionError(f"train.cli: exited {proc.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")


def _free(device):
    import gc

    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def phase_train(device="cuda"):
    """Training on the card (``train/``, ``optim/``, ``ckpt/``,
    ``launch/train.py``): card vs CPU with the launcher's process beside
    it, the loop at full width, resume.  The serve phases' engines are
    freed first, so the peak memory is the phase's own."""
    t0 = time.perf_counter()
    _free(device)
    cli = start_train_cli(device)
    try:
        train_parity(device)
    except BaseException:
        cli[0].kill()
        cli[0].wait()
        shutil.rmtree(cli[1], ignore_errors=True)
        raise
    finish_train_cli(cli)
    for sub in (train_run, train_resume):
        _free(device)
        sub(device)
    emit({"phase": "train", "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# tp: tensor-parallel serving and the distributed TSMM
# ---------------------------------------------------------------------------

TP_LAYERS = 4                     # qwen1.5-4b at its published widths
TP_BUCKETS = (1, 4)
TP_PROMPT = 256
TP_STEPS = 16
TP_QUEUE = ((200, 8), (256, 6), (64, 10), (130, 4), (256, 5))
TP_MAX_LEN = 2 * TP_PROMPT + sum(m for _, m in TP_QUEUE) + 8
# rank 0's bf16 logits against the one-rank engine's on the same weights,
# every row of each group's first decode step.  Tensor parallelism rounds
# each rank's partial output of wo and w_down (and the looked-up
# embeddings) to bf16 before the sum, where one rank rounds the whole sum
# once.  On the card (NVIDIA H100 80GB HBM3, 700.00 W) the sound run's
# largest |delta| is 0.0625 (2 bf16 ulps of logits up to 4.94), the planted
# control's (``tp_planted``: layer 0's w_down all-reduce skipped) 5.42
# (PERF.md §6).  The bound sits between, 4x the one and 1/21 of the
# other, with no term relative to the logit, so no per-logit error of a
# few per cent passes
TP_LOGITS_TOL = dict(rtol=0.0, atol=0.25)
TP_PAPER_N = (4, 240)
TP_PAPER_MK = 25600               # the paper's A: M = K = 25600, fp32
# the paper tolerance of the distributed rows against the one-rank
# planned row (fp32, K = 25600)
TP_PAPER_TOL = dict(rtol=1e-2, atol=1e-2)
# the ring (``overlapped_ring_tsmm``): A (M, K) k-sharded, B (K, N),
# unit-scale normal draws: its two halves' fp32 sums against one
# ``torch.matmul`` differ with the terms' size, not the result's, so the
# paper tools' K-scaled fp32 tolerance holds them
# (``launch/prepack_vs_conventional.py::f32_tol``)
TP_RING = (4096, 4096, 64)
# qwen1.5-4b's skinny-A leaves as a rank holds them at model=2 (the five
# per-shard problems of ``sharded_serving_shapes``): wq / wk / wv (K 2560,
# N 1280, with the qkv bias), wo (1280, 2560), w_gate (SiLU in the
# epilogue) / w_up (2560, 3456), w_down (3456, 2560), each stacked over
# the layers, and the vocab-split head (2560, 75968: no multiple of 128
# divides it, so each rank's piece is zero-padded to whole column
# blocks); each at decode rows 1 and 4 and a 4 x 256-token prefill
TP_SHARD_LEAVES = {"wq": (2560, 1280, True, None),
                   "wo": (1280, 2560, False, None),
                   "w_gate": (2560, 3456, False, "silu"),
                   "w_up": (2560, 3456, False, None),
                   "w_down": (3456, 2560, False, None),
                   "head": (2560, 75968, False, None)}
TP_SHARD_M = (1, 4, 1024)


def tp_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("qwen1_5_4b"), num_layers=TP_LAYERS)


def tp_contract(cfg, rows: int, tp: int, itemsize: int) -> dict:
    """One decode call's collectives on a rank, from the shapes: per layer
    an all-reduce of the (rows, 1, d_model) output of ``wo`` and one of
    ``w_down``, one of the looked-up embeddings, one all-gather of the
    (rows, 1, vocab) logits; the reference's ring multipliers."""
    act = rows * cfg.d_model * itemsize
    n_ar = 2 * cfg.num_layers + 1
    logits = rows * cfg.vocab_size * itemsize
    f_ar = 2 * (tp - 1) / tp if tp > 1 else 0.0
    f_ag = (tp - 1) / tp if tp > 1 else 0.0
    return {"all-reduce": {"count": n_ar, "bytes_moved": n_ar * act * f_ar,
                           "tensor_bytes": float(n_ar * act)},
            "all-gather": {"count": 1, "bytes_moved": logits * f_ag,
                           "tensor_bytes": float(logits)}}


def tp_group_tokens(cfg, b: int, device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(100 + b)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, TP_PROMPT),
                                    generator=g, dtype=torch.int32)
            .to(device)}


def tp_queue(cfg):
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(5)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(TP_QUEUE)]


def tp_serve(mesh, res: dict):
    """The TP engine on ``mesh``: load, the groups and the queue (the
    main path, counted), then the comparison with a one-rank engine on
    rank 0.  Fills ``res``."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.models.param import torch_dtype
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore
    from repro_torch.sharding import comm

    cfg = tp_cfg()
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=mesh.device)
                              .manual_seed(0))
    dev = mesh.device
    registry.reset_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    eng = Engine(model, params, axes, max_len=TP_MAX_LEN, buckets=TP_BUCKETS,
                 max_prompt=TP_PROMPT, device=dev.type, mesh=mesh)
    _sync(dev)
    res["load"] = {"seconds": time.perf_counter() - t0,
                   "launches": dict(cuda.launches),
                   "designs": dict(cuda.design_launches),
                   "packed_leaves": len(eng.pack_report),
                   "head_blocks": eng.pack_report.get("embed/head")}
    res["graphed"] = eng.programs.stats()["graphed"]
    try:
        ProgramStore(model, device=mesh.device, mesh=mesh, capture=True)
        res["capture_refused"] = False
    except RuntimeError as e:
        res["capture_refused"] = str(e)
    # the main path: counts zeroed just before, read just after
    cuda.reset_launches()
    comm.reset()
    itemsize = torch_dtype(cfg.dtype).itemsize
    groups = {}
    for b in TP_BUCKETS:
        r = eng.generate(tp_group_tokens(cfg, b, mesh.device), TP_STEPS)
        groups[b] = {"prefill_s": r.prefill_s, "per_token_s": r.per_token_s,
                     "buckets": list(r.buckets),
                     "tokens0": r.tokens[0].tolist(),
                     "collectives": eng.collectives("decode", b),
                     "contract": tp_contract(cfg, b, 2, itemsize)}
    t0 = time.perf_counter()
    results, stats = eng.serve_queue(tp_queue(cfg))
    _sync(dev)
    res["queue"] = {"seconds": time.perf_counter() - t0,
                    "admitted": stats.admitted, "steps": stats.steps,
                    "generated": stats.generated_tokens,
                    "tokens": [r.tokens.tolist() for r in results]}
    res["launches"] = dict(cuda.launches)
    res["designs"] = dict(cuda.design_launches)
    res["comm"] = collective_bytes(comm.records)
    res["staged"] = sorted(set(staged_ops(comm.records)))
    res["groups"] = groups
    res["misses"] = registry.stats()["misses"]
    hr = eng.health_report()
    res["healthy"] = hr["healthy"] and not hr["failpoints"]
    # rank 0's logits against a one-rank engine with the same weights:
    # the first decode step of each group (its input, the prefill's
    # argmax, must agree first); both engines eager
    cmp = {}
    firsts = {b: eng.generate(tp_group_tokens(cfg, b, mesh.device), 1)
              for b in TP_BUCKETS}
    planted = tp_planted(eng, cfg, mesh)
    if mesh.rank == 0:
        one = Engine(model, params, axes, max_len=TP_MAX_LEN,
                     buckets=TP_BUCKETS, max_prompt=TP_PROMPT,
                     device=dev.type)
        one.programs = ProgramStore(model, device=mesh.device, capture=False)
        for b in TP_BUCKETS:
            want = one.generate(tp_group_tokens(cfg, b, mesh.device), 1)
            timed = one.generate(tp_group_tokens(cfg, b, mesh.device),
                                 TP_STEPS)
            agree = sum(x == y for x, y in zip(groups[b]["tokens0"],
                                              timed.tokens[0].tolist()))
            cmp[b] = {"rows": b, "ref_absmax": float(
                          want.logits_last.float().abs().max()),
                      **tp_logits_vs(firsts[b], want),
                      "planted": tp_logits_vs(planted[b], want),
                      "one_rank_per_token_s": timed.per_token_s,
                      "one_rank_prefill_s": timed.prefill_s,
                      "row0_tokens_agree": agree, "steps": TP_STEPS}
        del one
    res["compare"] = cmp
    del eng, params


def tp_logits_vs(got, want) -> dict:
    """The first decode step of a group against the one-rank engine's:
    how many rows took the same first token (the step's input), and all
    rows' logits under ``TP_LOGITS_TOL``."""
    ok, err = within(got.logits_last, want.logits_last, **TP_LOGITS_TOL)
    return {"first_tokens_equal": int((got.tokens[:, 0]
                                       == want.tokens[:, 0]).sum()),
            "max_abs_err": err, "within": ok}


def tp_planted(eng, cfg, mesh) -> dict:
    """The control of the logits bound: each group's first decode step
    with a planted fault, layer 0's ``w_down`` partial sums left unsummed
    (its all-reduce skipped on every rank alike, so the ranks stay in
    step).  The cells run eager under gloo, so the patched site is the
    one they call."""
    from repro_torch.models import lm
    sound = lm.tp_sum
    calls = [0]

    def skip_layer0_mlp(x, axis, dim):
        if axis == "mlp":
            calls[0] += 1
            if (calls[0] - 1) % cfg.num_layers == 0:
                return x
        return sound(x, axis, dim)

    lm.tp_sum = skip_layer0_mlp
    try:
        out = {b: eng.generate(tp_group_tokens(cfg, b, mesh.device), 1)
               for b in TP_BUCKETS}
    finally:
        lm.tp_sum = sound
    if not calls[0]:
        raise AssertionError("tp: the planted fault's site was never called")
    return out


def tp_paper(mesh, res: dict):
    """``distributed_tsmm`` at the paper's A (25600 x 25600 fp32), 12800
    rows a rank, packed once, and ``conventional_ksplit`` at the same
    shape, against the one-rank planned row."""
    import torch
    from repro_torch.core.autotuner import make_plan
    from repro_torch.core.hw import for_device
    from repro_torch.core.packing import pack
    from repro_torch.core.plan import Problem
    from repro_torch.core.tsmm import (conventional_ksplit, distributed_tsmm,
                                       overlapped_ring_tsmm)
    from repro_torch.kernels import cuda, variants
    from repro_torch.sharding import comm

    dev = mesh.device
    g = mesh.group("model")
    n_ranks = comm.group_size(g)
    r = mesh.coords["model"]
    m = k = TP_PAPER_MK
    rows = slice(r * m // n_ranks, (r + 1) * m // n_ranks)
    hw = dataclasses.replace(for_device(dev), pack_once=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    a = torch.randn((m, k), generator=gen, device=dev)
    out = []
    for n in TP_PAPER_N:
        b = torch.randn((k, n), generator=gen, device=dev)
        plan = make_plan(Problem(m // n_ranks, k, n, "float32", n_ranks), hw,
                         persist=False, device=dev)
        a_rows = a[rows].contiguous()
        ap = pack(a_rows, plan.bm, plan.bk) if plan.prepack else a_rows
        cuda.reset_launches()
        with comm.recording() as rec:
            got = distributed_tsmm(ap, b, g, plan=plan)
        _sync(dev)
        launches, designs = dict(cuda.launches), dict(cuda.design_launches)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            distributed_tsmm(ap, b, g, plan=plan)
        _sync(dev)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        del ap, a_rows
        plan1 = make_plan(Problem(m, k, n, "float32"), hw, persist=False,
                          device=dev)
        a1 = pack(a, plan1.bm, plan1.bk).blocks if plan1.prepack else a
        want = variants.run_tall_a(plan1.kernel, a1, b, bm=plan1.bm,
                                   bk=plan1.bk, packed=plan1.prepack,
                                   schedule=plan1.schedule)[:m, :n]
        del a1
        ok, err = within(got, want[rows], **TP_PAPER_TOL)
        cols = rows
        a_cols = a[:, cols].contiguous()
        with comm.recording() as rec_ks:
            ks = conventional_ksplit(a_cols, b[cols].contiguous(), g)
        ok_ks, err_ks = within(ks, want, **TP_PAPER_TOL)
        del a_cols, want, ks
        out.append({
            "n": n, "rows_a_rank": m // n_ranks, "K": k,
            "plan": {"bm": plan.bm, "bk": plan.bk, "prepack": plan.prepack,
                     "kernel": plan.kernel.key()},
            "launches": launches, "designs": designs,
            "wall_ms_two_ranks_one_card": ms,
            "collectives": [x["op"] for x in rec], "max_abs_err": err,
            "within": ok, "one_rank_plan": {"bm": plan1.bm, "bk": plan1.bk,
                                            "prepack": plan1.prepack,
                                            "kernel": plan1.kernel.key()},
            "ksplit": {"collectives": [x["op"] for x in rec_ks],
                       "bytes": [x["bytes"] for x in rec_ks],
                       "max_abs_err": err_ks, "within": ok_ks}})
    del a
    res["paper"] = out
    # the ring moves A's and B's k pieces along the ranks: gloo's send /
    # recv take host memory, so ``comm`` stages them, named in the record
    m2, k2, n2 = TP_RING
    a2 = torch.randn((m2, k2), generator=gen, device=dev)
    b2 = torch.randn((k2, n2), generator=gen, device=dev)
    cols = slice(r * k2 // n_ranks, (r + 1) * k2 // n_ranks)
    with comm.recording() as rec:
        ring = overlapped_ring_tsmm(a2[:, cols].contiguous(),
                                    b2[cols].contiguous(), g)
    from repro_torch.launch.prepack_vs_conventional import f32_tol
    tol = f32_tol(k2)
    ok, err = within(ring, torch.matmul(a2, b2), rtol=tol, atol=tol)
    res["ring"] = {"shape": TP_RING, "ops": [x["op"] for x in rec],
                   "staged": [x["staged"] for x in rec],
                   "max_abs_err": err, "tol": tol, "within": ok}


def tp_shard_cases(leaves=None, layers: int = TP_LAYERS,
                   buckets: tuple = TP_BUCKETS, ms: tuple = TP_SHARD_M,
                   mode: str = "tp") -> list:
    """The kernels of the tp path (``mode``; default qwen's) at the
    per-shard shapes the ranks give them.  Each leaf of ``leaves``
    (default ``TP_SHARD_LEAVES``) is packed as a rank packs its piece
    (``prepack_for`` over ``buckets`` keyed by the shard count: the plans
    ``install --mesh`` wrote), the pack bit-equal to ``pack_ref``; then
    ``tsmm_dot`` on layer 0's packed piece at ``ms`` rows (the stamped
    variant at decode, the registry's at the prefill) against the same
    call on the ladder's plain rung: the same variant's plain version,
    the planned rung refused by a failpoint, with no kernel launched."""
    import logging

    import torch
    from repro_torch.core import registry
    from repro_torch.core.evaluator import Timer
    from repro_torch.core.packing import pack
    from repro_torch.core.tsmm import prepack_for, tsmm_dot
    from repro_torch.kernels import cuda, ref
    from repro_torch.resilience import degrade, failpoints

    from repro_torch.serve.engine import PAD_COLS

    timer = Timer()
    g = torch.Generator(device="cuda").manual_seed(27)
    bf = torch.bfloat16
    misses = registry.stats()["misses"]
    out = []
    for leaf, (k, n, has_bias, act, *stack) in (
            leaves or TP_SHARD_LEAVES).items():
        # stacked over the layers, or one copy (a head, a shared block)
        depth = stack[0] if stack else 0 if leaf == "head" else layers
        w = (torch.randn((depth, k, n) if depth else (k, n), generator=g,
                         device="cuda") / k ** 0.5).to(bf)
        with Designs() as d:
            pk = prepack_for(buckets, w, pad=leaf in PAD_COLS, num_shards=2)
        if pk is None:
            raise AssertionError(f"{mode} {leaf} {(k, n)}: stays unpacked")
        bk, bn = pk.blocks.shape[-2:]
        if not torch.equal(pk.blocks, ref.pack_ref(w, bk, bn)):
            raise AssertionError(f"pack_blocks {mode} {leaf} {(k, n)} by "
                                 f"({bk}, {bn}): not bit-equal to pack_ref")
        pad_cols = pk.blocks.shape[-3] * bn
        bound_ms, bound_by = bound(w.numel() * 2 + pk.blocks.numel() * 2, 0)
        out.append({"kernel": "pack_blocks", "mode": f"{mode}_{leaf}",
                    "tp_leaf": leaf, "design": design_of(d.ran),
                    "L": depth or 1, "M": k, "K": n,
                    "bm": bk, "bk": bn, "padded_cols": pad_cols,
                    "max_abs_err": 0.0, "tol": "bit-equal",
                    "ms": timer(lambda: pack(w, bk, bn), iters=3),
                    "device_ms": timer(lambda: pack(w, bk, bn), iters=3,
                                       device=True),
                    "plain_ms": timer(lambda: ref.pack_ref(w, bk, bn),
                                      iters=3),
                    # no one PyTorch call pads and re-tiles
                    "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by})
        w0, pk0 = (w[0], pk[0]) if depth else (w, pk)
        bias = ((0.1 * torch.randn((n,), generator=g, device="cuda")).to(bf)
                if has_bias else None)
        for m in ms:
            x = torch.randn((m, k), generator=g, device="cuda").to(bf)

            def kern():
                return tsmm_dot(x, pk0, bias=bias, act=act)

            def plain():
                failpoints.configure({"kernels.lower.skinny": "raise"})
                logging.disable(logging.WARNING)
                try:
                    with degrade.use(degrade.DegradeStats()):
                        return tsmm_dot(x, pk0, bias=bias, act=act)
                finally:
                    logging.disable(logging.NOTSET)
                    failpoints.reset()

            before = dict(cuda.launches)
            with Designs() as d:
                got = kern()
            ran = {kk: v - before.get(kk, 0) for kk, v in cuda.launches.items()
                   if v != before.get(kk, 0)}
            before = dict(cuda.launches)
            want = plain()
            torch.cuda.synchronize()
            if dict(cuda.launches) != before or len(ran) != 1:
                raise AssertionError(f"{mode} {leaf} m={m}: the kernel call "
                                     f"launched {ran}, the plain rung "
                                     f"launched a kernel too")
            name = next(iter(ran))
            if design_of(d.ran) not in ("wgmma", "stream"):
                raise AssertionError(f"{mode} {leaf} m={m}: {name} ran "
                                     f"{d.ran}, not the wgmma or stream "
                                     f"design")
            ok, err = within(got, want, **BF16_TOL)
            if not ok:
                raise AssertionError(f"{name} {mode} {leaf} m={m} K={k} "
                                     f"N={n}: max |err| {err} outside "
                                     f"{BF16_TOL}")
            moved = (2 * (m * k + k * n + (n if has_bias else 0))
                     + got.numel() * got.element_size())
            bound_ms, bound_by = bound(moved, 2 * m * k * n)
            iters = 2 if m * n > 4 * 151936 else 5
            del got, want
            out.append({"kernel": name, "mode": mode, "tp_leaf": leaf,
                        "design": design_of(d.ran), "m": m, "K": k, "N": n,
                        "bk": bk, "bn": bn, "bias": has_bias, "act": act,
                        "max_abs_err": err, "tol": BF16_TOL,
                        "ms": timer(kern, iters=iters),
                        "device_ms": timer(kern, iters=iters, device=True),
                        "plain_ms": timer(plain, iters=iters),
                        "library_ms": timer(lambda: torch.matmul(x, w0),
                                            iters=iters),
                        "bound_ms": bound_ms, "bound_by": bound_by})
            del x
        del w, pk, w0, pk0
        torch.cuda.empty_cache()
    misses = registry.stats()["misses"] - misses
    for c in out:
        emit({"phase": f"{mode}.kernels", **c})
    if misses:
        raise AssertionError(f"{mode}.kernels: {misses} registry misses "
                             f"after install --mesh")
    return out


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tp_worker(out_dir: str, device: str = "cuda") -> None:
    """One rank of the tp phase (``torch.distributed.run``): two ranks on
    the one card, over gloo: qwen1.5-4b, the distributed TSMM, the MoE
    family (``TP_MOE``), then the SSM, hybrid, VLM and encoder-decoder
    families (``TP_FAMILIES``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("model",), device=device)
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    try:
        tp_serve(mesh, res)
        _free(mesh.device.type)
        tp_paper(mesh, res)
        res["moe"] = {}
        for name in TP_MOE:
            _free(mesh.device.type)
            res["moe"][name] = {}
            tp_moe_serve(mesh, name, res["moe"][name])
        res["family"] = {}
        for name in TP_FAMILIES:
            _free(mesh.device.type)
            res["family"][name] = {}
            t0 = time.perf_counter()
            tp_family_serve(mesh, name, res["family"][name])
            res["family"][name]["seconds"] = time.perf_counter() - t0
    finally:
        with open(os.path.join(out_dir, f"tp_rank{mesh.rank}.json"),
                  "w") as f:
            json.dump(res, f, default=str)
        mesh.close()


def tp_nccl(out_dir: str, name: str = "tp") -> dict:
    """The TP engine at model=1 under NCCL in this process (``name``:
    ``tp``, qwen1.5-4b, a ``TP_MOE`` path or a ``TP_FAMILIES`` one), whose
    grid holds its prompt's length bucket alone (the serve path of qwen
    captures every length bucket): its grid captured as
    CUDA graphs with the collectives inside, every cell bit-equal to its
    eager run, a graphed group equal to an eager one."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import init_pieces
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore, check_cells

    if name == "tp":
        cfg, buckets, max_len, prompt = (tp_cfg(), TP_BUCKETS, TP_MAX_LEN,
                                         TP_PROMPT)
        contract = tp_contract(cfg, 1, 1, 2)
        group = tp_group_tokens(cfg, 4, "cuda")
    elif name in TP_FAMILIES:
        spec = TP_FAMILIES[name]
        cfg, buckets, prompt = (tp_family_cfg(name), spec["buckets"],
                                spec["prompt"])
        max_len = tp_family_max_len(cfg, spec)
        contract = tp_family_contract(cfg, min(buckets), 1)
        group = tp_family_batch(cfg, max(buckets), prompt, "cuda")
    else:
        spec = TP_MOE[name]
        cfg, buckets, prompt = tp_moe_cfg(name), spec["buckets"], \
            spec["prompt"]
        max_len = tp_moe_max_len(spec)
        contract = tp_moe_contract(cfg, 1, 1)
        group = tp_moe_tokens(cfg, max(buckets), prompt, "cuda")
    mesh = make_mesh((1,), ("model",), device="cuda", rank=0, world_size=1,
                     init_file=os.path.join(out_dir, f"nccl_store_{name}"))
    try:
        if mesh.backend != "nccl":
            raise AssertionError(f"{name}.nccl: backend {mesh.backend}")
        model = build_model(cfg)
        with init_pieces(mesh, cfg):
            params, axes = model.init(torch.Generator(device="cuda")
                                      .manual_seed(0))
        eng = Engine(model, params, axes, max_len=max_len, buckets=buckets,
                     max_prompt=prompt, min_prompt=prompt, device="cuda",
                     mesh=mesh)
        del params
        t0 = time.perf_counter()
        eng.precompile()
        capture_s = time.perf_counter() - t0
        checks = check_cells(eng.programs)
        graphed = eng.generate(group, 4)
        store = eng.programs
        st = store.stats()
        eng.programs = ProgramStore(model, device="cuda", mesh=mesh,
                                    opts=eng.opts, capture=False,
                                    cache_init=eng._local_cache,
                                    layout_of=eng.cache_layout)
        eager = eng.generate(group, 4)
        dec = [p for p in store.programs()
               if p.kind == "decode" and p.bucket == min(buckets)]
        out = {"backend": mesh.backend, "graphed": st["graphed"],
               "cells": st["programs"], "captured": st["captured"],
               "capture_s": capture_s,
               "cells_bit_equal": sum(c["equal"] for c in checks),
               "cells_checked": len(checks),
               "group_tokens_equal": bool(torch.equal(graphed.tokens,
                                                      eager.tokens)),
               "group_logits_equal": bool(torch.equal(graphed.logits_last,
                                                      eager.logits_last)),
               "decode_collectives": store.collectives(dec[0])
               if dec else None,
               "contract": contract}
        del eng, store
        return out
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# tp.moe: the MoE family under tensor parallelism, in the tp phase's ranks
# ---------------------------------------------------------------------------

# OLMoE-1B-7B at its published widths cut to 4 layers (64 experts, 32 a
# rank; 16 heads, 8 a rank; flash at D 128 on a rank's heads) with a
# 3-request ragged queue, and DeepSeek-V2 at its published widths cut to 2
# layers (the dense first layer and one MoE layer: 160 routed experts, 80
# a rank, 2 shared, top-6; 128 MLA heads, 64 a rank; the latent cache
# split along its sequence; no flash), bf16, seeded, each rank drawing
# every leaf whole on the card and keeping its piece as it is drawn
# (``init_pieces``: DeepSeek's MoE layer alone is 7.55 GB)
TP_MOE = {
    "olmoe": dict(arch="olmoe_1b_7b", cut={"num_layers": 4}, buckets=(1, 4),
                  prompt=256, steps=8, queue=((200, 6), (256, 4), (64, 8)),
                  flash=True),
    "deepseek": dict(arch="deepseek_v2_236b", cut={"num_layers": 2},
                     buckets=(1, 2), prompt=512, steps=4, queue=(),
                     flash=False),
}
# the per-shard skinny-A leaves of each path at model=2, (K, N, bias,
# epilogue), each at decode rows and its prefill's (bucket x prompt):
# OLMoE's wq piece; DeepSeek's wq_b and wkv_b (their heads split) and wo
# (its rows split)
TP_MOE_LEAVES = {
    "olmoe": {"wq": (2048, 1024, False, None)},
    "deepseek": {"wq_b": (1536, 12288, False, None),
                 "wkv_b": (512, 16384, False, None),
                 "wo": (8192, 5120, False, None)},
}
TP_MOE_M = {"olmoe": (1, 4, 1024), "deepseek": (1, 2, 1024)}
# The controls of the bounds (``tp_moe_planted``), each planted alone on
# both ranks, and how many bounds (``TP_LOGITS_TOL``) outside it must land
# at every bucket (the least reading over the buckets), read where it
# acts (``TP_MOE_FAULT_AT``: every prefill position, or the first decode
# step of the rows whose input agrees, against the one-rank engine
# routed alike):
# * ``moe_sum``: every MoE layer's all-reduce skipped, each rank keeping
#   its fp32 partial.  On the card (NVIDIA H100 80GB HBM3, 700.00 W)
#   OLMoE's landed 8.2 bounds outside at bucket 1 and 11.2 at bucket 4,
#   so it is held to fail the bound, not to 10;
# * ``router_order``: the router's gathered columns in the reverse rank
#   order, so every token goes to other experts.  It must also break
#   both limits of the routing bound (``TP_MOE_GAP``, ``TP_MOE_FLIPS``)
#   at every bucket;
# * ``mla_local``: MLA's decode combining only the rank's own slots of
#   the sequence-split latent cache.
TP_MOE_FAULTS = {
    "olmoe": {"moe_sum": 1.0, "router_order": 10.0},
    "deepseek": {"moe_sum": 1.0, "router_order": 1.0, "mla_local": 1.0},
}
TP_MOE_FAULT_AT = {"moe_sum": "prefill", "router_order": "prefill",
                   "mla_local": "decode", "experts_sum": "prefill",
                   "router_sum": "prefill", "fsdp_reverse": "prefill",
                   "mla_rows": "decode"}
# The routing bound, in the first MoE layer of the prefill, where only
# the roundings of the TP sums move a router logit: every token whose
# top-k set differs from the one-rank engine's has a one-rank gap between
# its k-th and (k+1)-th expert probability of at most ``TP_MOE_GAP``, and
# at most ``TP_MOE_FLIPS`` of the layer's tokens differ.  Set from the
# card's readings (NVIDIA H100 80GB HBM3, 700.00 W): the first layer's
# flips 2.2-5.7 % of its tokens, their gaps at most 0.00025-0.00051 a
# bucket (0.0075 in later layers, whose inputs the earlier flips move);
# with the columns reversed every token flips, its gap up to 0.012-0.014.
TP_MOE_GAP = 0.002
TP_MOE_FLIPS = 0.10


def tp_moe_cfg(name: str):
    from repro_torch.configs.base import get_config
    spec = TP_MOE[name]
    return dataclasses.replace(get_config(spec["arch"]), **spec["cut"])


def tp_moe_max_len(spec: dict) -> int:
    """The ragged rule's length where a queue runs (2 x the prompt + its
    decode steps + 8), else the prompt + steps + 8; a multiple of 8, so
    the latent cache's slots split over the ranks."""
    need = (2 * spec["prompt"] + sum(m for _, m in spec["queue"]) + 8
            if spec["queue"] else spec["prompt"] + spec["steps"] + 8)
    return -(-need // 8) * 8


def tp_moe_tokens(cfg, b: int, prompt: int, device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(300 + b)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt),
                                    generator=g, dtype=torch.int32)
            .to(device)}


def tp_moe_queue(cfg, queue: tuple):
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(9)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(queue)]


def tp_moe_contract(cfg, rows: int, tp: int) -> dict:
    """One decode call's collectives on a rank, from the shapes (bf16
    activations, fp32 router logits and MoE partials): per layer an
    all-reduce after ``wo``; under MLA with the latent cache split along
    its sequence (tp > 1) an all-gather of every head's c-space and rope
    query ((rows, H, kv_lora_rank + rope_head_dim) fp32) and one of every
    piece's (m, l, weighted c) ((tp, rows, H, 2 + kv_lora_rank) fp32); in
    the dense layers the ``w_down`` all-reduce; in the MoE layers the
    all-gather of the router's fp32 logit columns (the experts split)
    and the one fp32 all-reduce of the routed and shared partials; per
    call the lookup's all-reduce and the logits' all-gather.  The
    reference's ring multipliers over a group of ``tp``."""
    d, bf, f4 = cfg.d_model, 2, 4
    ar, ag = [rows * d * bf], [rows * cfg.vocab_size * bf]
    for i in range(cfg.num_layers):
        if cfg.use_mla and tp > 1:
            h, kvr = cfg.num_heads, cfg.kv_lora_rank
            ag.append(rows * h * (kvr + cfg.rope_head_dim) * f4)
            ag.append(tp * rows * h * (2 + kvr) * f4)
        ar.append(rows * d * bf)                                 # wo
        if i < cfg.first_k_dense:
            ar.append(rows * d * bf)                             # w_down
        else:
            ag.append(rows * cfg.num_experts * f4)               # router
            ar.append(rows * d * f4)                             # the sum
    f_ar = 2 * (tp - 1) / tp if tp > 1 else 0.0
    f_ag = (tp - 1) / tp if tp > 1 else 0.0
    return {"all-reduce": {"count": len(ar), "bytes_moved": sum(ar) * f_ar,
                           "tensor_bytes": float(sum(ar))},
            "all-gather": {"count": len(ag), "bytes_moved": sum(ag) * f_ag,
                           "tensor_bytes": float(sum(ag))}}


def _routed_as(top_e, router, xf, g: int, cap: int, gathered: bool):
    """``moe.route``'s tuple with each token's experts ``top_e`` (t, k)
    in place of its own top-k, the weights from its own probabilities."""
    from repro_torch.models import moe
    probs = moe.router_probs(router, xf, gathered)
    top_e = top_e.to(probs.device)
    return moe.dispatch_order(probs, probs.gather(1, top_e), top_e, g, cap)


@contextlib.contextmanager
def moe_routes(k: int, replay=None):
    """Record each MoE dispatch's choice while inside: per call each
    token's k experts in top-k order (t, k), the same sorted with a
    dropped entry's id moved past the experts (id + E: a token's output
    changes with its experts or with the drop of one of them), and the
    top k + 1 probabilities (t, k + 1), on the host.  ``replay``: a
    record, whose experts each call takes in order in place of its own
    top-k (the weights from its own probabilities), so a second engine
    computes with the first one's routing."""
    import torch
    from repro_torch.models import moe
    sound = moe.route
    rec = []
    it = iter(replay or ())

    def recording(router, xf, k_, g, cap, gathered):
        out = (sound(router, xf, k_, g, cap, gathered) if replay is None
               else _routed_as(next(it)["experts"], router, xf, g, cap,
                               gathered))
        probs, flat_e, order, keep = out[:4]
        e = probs.shape[-1]
        kept = torch.empty_like(keep)
        kept[order] = keep
        code = torch.where(kept, flat_e, flat_e + e).view(-1, k)
        rec.append({"experts": flat_e.view(-1, k).cpu(),
                    "chosen": code.sort(-1).values.cpu(),
                    "probs": torch.topk(probs, k + 1, dim=-1).values.cpu()})
        return out

    moe.route = recording
    try:
        yield rec
    finally:
        moe.route = sound


def _prefill_logits(eng, cfg, batch, b: int):
    """Every position's logits of ``batch``'s prefill (``lm_forward`` in
    the engine's cell context for bucket ``b``), on the host."""
    import torch
    from repro_torch.core.linear import serving_ctx
    from repro_torch.models.lm import lm_forward
    with torch.inference_mode(), serving_ctx(), eng.programs.context(b):
        return lm_forward(eng.params, cfg, batch)[0].cpu()


def tp_moe_side(eng, cfg, b: int, spec: dict, replay=None) -> dict:
    """One engine's side of the comparison at bucket ``b``: every
    position's prefill logits and that forward's expert choices, then the
    group's first decode step (its input, logits, and the choices of its
    prefill and of the step).  ``replay``: a side whose choices this
    engine takes in place of its own (``moe_routes``)."""
    batch = tp_moe_tokens(cfg, b, spec["prompt"], eng.device)
    with moe_routes(cfg.experts_per_token,
                    replay and replay["routes"]) as rec:
        logits = _prefill_logits(eng, cfg, batch, b)
    with moe_routes(cfg.experts_per_token,
                    replay and replay["gen_routes"]) as gen:
        first = eng.generate(batch, 1)
    n_moe = cfg.num_layers - cfg.first_k_dense
    return {"logits": logits, "routes": rec, "gen_routes": gen,
            "dec_routes": gen[n_moe:2 * n_moe],
            "first_tokens": first.tokens[:, 0].cpu(),
            "first_logits": first.logits_last.cpu()}


def tp_moe_planted(eng, cfg, spec: dict, name: str) -> dict:
    """The controls of the logits and routing bounds (``TP_MOE_FAULTS``),
    each planted alone on every rank alike, so the ranks stay in step:
    {fault: {bucket: its side (``tp_moe_side``)}}.  Raises unless each
    fault's site ran as often as a side reaches it."""
    from repro_torch.models import attention, moe
    from repro_torch.sharding.context import tp_rank
    n_moe = cfg.num_layers - cfg.first_k_dense
    calls = [0]

    def moe_sum(sound):
        def skipped(part):
            calls[0] += 1
            return part
        return skipped

    def router_order(sound):
        def reversed_order(router, xf, gathered):
            calls[0] += 1
            p = sound(router, xf, gathered)
            n = p.shape[-1] // router.shape[-1]
            return p.view(p.shape[0], n, -1).flip(1).reshape(p.shape)
        return reversed_order

    def mla_local(sound):
        def local(m, l, acc):
            calls[0] += 1
            j = tp_rank()
            return sound(m[j:j + 1], l[j:j + 1], acc[j:j + 1])
        return local

    # (module, attribute, the fault, its calls a side: the prefill
    # forward, generate's prefill and its one decode step)
    sites = {"moe_sum": (moe, "moe_sum", moe_sum, 3 * n_moe),
             "router_order": (moe, "router_probs", router_order,
                              3 * n_moe),
             "mla_local": (attention, "combine_partials", mla_local,
                           cfg.num_layers)}
    out = {}
    for fault in TP_MOE_FAULTS[name]:
        mod, attr, plant, per_side = sites[fault]
        sound = getattr(mod, attr)
        calls[0] = 0
        setattr(mod, attr, plant(sound))
        try:
            out[fault] = {b: tp_moe_side(eng, cfg, b, spec)
                          for b in spec["buckets"]}
        finally:
            setattr(mod, attr, sound)
        if calls[0] != per_side * len(spec["buckets"]):
            raise AssertionError(f"tp.moe: the planted {fault} ran "
                                 f"{calls[0]} times")
    return out


def _route_diff(got: dict, want: dict, k: int) -> tuple:
    """One MoE call's routing, one side against the other: the tokens
    whose top-k set differs, those whose set or an entry's drop differs,
    and the one-rank gap between the k-th and (k+1)-th expert
    probability of each token of the first kind."""
    flip = (got["experts"].sort(-1).values
            != want["experts"].sort(-1).values).any(-1)
    diff = (got["chosen"] != want["chosen"]).any(-1)
    top = want["probs"][flip]
    return flip, diff, top[:, k - 1] - top[:, k]


def _routing_bound(got: dict, want: dict, k: int) -> dict:
    """The routing bound's readings in the first MoE layer of the
    prefill (``TP_MOE_GAP``, ``TP_MOE_FLIPS``)."""
    flip, _, gaps = _route_diff(got["routes"][0], want["routes"][0], k)
    frac = float(flip.float().mean())
    gap = float(gaps.max()) if len(gaps) else 0.0
    return {"first_layer_flip_frac": frac, "first_layer_gap_max": gap,
            "routing_within": frac <= TP_MOE_FLIPS and gap <= TP_MOE_GAP}


def tp_moe_compare(cfg, got: dict, want: dict, forced: dict,
                   planted: dict) -> dict:
    """Rank 0's side against the one-rank engine's, two ways, under
    ``TP_LOGITS_TOL``.

    Routed as each engine routes (``want``): the router's columns come
    from a narrower GEMM on each rank and the hidden states differ by the
    TP sums' bf16 roundings, so a near-tie can flip a token's top-k set
    (or the drop of one of its entries, which depends on every earlier
    token of the batch): the flips are counted by layer, with the
    one-rank probability gap between the k-th and the (k+1)-th expert of
    each, and a row is compared only up to its first changed position
    (its prefill logits before it; its first decode step only where
    nothing changed and its decode input agrees).

    Routed alike (``forced``: the one-rank engine taking rank 0's expert
    choices): every position's prefill logits and the first decode step
    of every row whose decode input agrees.  The routing bound in the
    first MoE layer (``_routing_bound``).  ``planted``: each control's
    side (``tp_moe_planted``), against ``forced`` at the prefill and the
    first decode step, and its routing against ``want``'s."""
    import torch
    k = cfg.experts_per_token
    b, s = got["logits"].shape[:2]
    first = [s] * b
    flips, drops, dec_flips, gaps = [], [], [], []
    for g_r, w_r in zip(got["routes"], want["routes"]):
        flip, diff, gap = _route_diff(g_r, w_r, k)
        diff = diff.view(b, s)
        flips.append(int(flip.sum()))
        drops.append(int(diff.sum()) - int(flip.sum()))
        for row in range(b):
            at = torch.nonzero(diff[row])
            if len(at):
                first[row] = min(first[row], int(at[0]))
        gaps.append(float(gap.max()) if len(gap) else None)
    dec_same = torch.ones(b, dtype=torch.bool)
    for g_r, w_r in zip(got["dec_routes"], want["dec_routes"]):
        diff = (g_r["chosen"] != w_r["chosen"]).any(-1)
        dec_flips.append(int(diff.sum()))
        dec_same &= ~diff
    ok, errs = True, [0.0]
    for row in range(b):
        n = first[row]
        if n:
            o, e = within(got["logits"][row, :n], want["logits"][row, :n],
                          **TP_LOGITS_TOL)
            ok, errs = ok and o, errs + [e]
    rows = ((got["first_tokens"] == want["first_tokens"]) & dec_same
            & torch.tensor([f == s for f in first]))
    ok_d, err_d = (within(got["first_logits"][rows],
                          want["first_logits"][rows], **TP_LOGITS_TOL)
                   if bool(rows.any()) else (True, 0.0))
    # routed alike: everything else held at every position
    ok_f, err_f = within(got["logits"], forced["logits"], **TP_LOGITS_TOL)
    same = got["first_tokens"] == forced["first_tokens"]
    ok_fd, err_fd = (within(got["first_logits"][same],
                            forced["first_logits"][same], **TP_LOGITS_TOL)
                     if bool(same.any()) else (True, 0.0))
    out = {"rows": b, "positions": s, "flips_by_layer": flips,
           "drop_changes_by_layer": drops,
           "decode_flips_by_layer": dec_flips,
           "flip_gap_max_by_layer": gaps,
           **_routing_bound(got, want, k),
           "first_change": first,
           "prefill_positions_compared": sum(first),
           "prefill_max_abs_err": max(errs),
           "decode_rows_compared": int(rows.sum()),
           "decode_max_abs_err": err_d,
           "forced_prefill_max_abs_err": err_f,
           "forced_decode_rows": int(same.sum()),
           "forced_decode_max_abs_err": err_fd,
           "within": ok and ok_d and ok_f and ok_fd,
           "ref_absmax": float(want["logits"].float().abs().max())}
    out["planted"] = {}
    for fault, side in planted.items():
        rows_p = side["first_tokens"] == forced["first_tokens"]
        err = {"prefill": within(side["logits"], forced["logits"],
                                 **TP_LOGITS_TOL)[1],
               "decode": (within(side["first_logits"][rows_p],
                                 forced["first_logits"][rows_p],
                                 **TP_LOGITS_TOL)[1]
                          if bool(rows_p.any()) else 0.0)}
        out["planted"][fault] = {
            "prefill_max_abs_err": err["prefill"],
            "decode_max_abs_err": err["decode"],
            "decode_rows": int(rows_p.sum()),
            "bounds_outside": (err[TP_MOE_FAULT_AT[fault]]
                               / TP_LOGITS_TOL["atol"]),
            **_routing_bound(side, want, k)}
    return out


def tp_moe_serve(mesh, name: str, res: dict) -> None:
    """One ``TP_MOE`` path on ``mesh``: load from the rank's pieces, the
    groups (and OLMoE's queue: the main path, counted), the comparison's
    side on both ranks, the planted controls; then on rank 0 a one-rank
    engine of the same seeded weights and the comparison.  Fills
    ``res``."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.models.param import init_pieces
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore
    from repro_torch.sharding import comm

    spec = TP_MOE[name]
    cfg = tp_moe_cfg(name)
    model = build_model(cfg)
    dev = mesh.device
    buckets, steps = spec["buckets"], spec["steps"]
    max_len = tp_moe_max_len(spec)
    kw = dict(max_len=max_len, buckets=buckets, max_prompt=spec["prompt"],
              device=dev.type)
    registry.reset_stats()
    cuda.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with init_pieces(mesh):
        params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, axes, mesh=mesh, **kw)
    del params
    _sync(dev)
    lay = eng.params["layers"]
    res["load"] = {"seconds": time.perf_counter() - t0,
                   "launches": dict(cuda.launches),
                   "designs": dict(cuda.design_launches),
                   "packed": sorted(eng.pack_report),
                   "head_blocks": eng.pack_report.get("embed/head")}
    res["pieces"] = {
        "w_gate": list(lay["mlp"]["w_gate"].shape),
        "router": list(lay["mlp"]["router"].shape),
        "heads": list(lay["attn"]["wq_b" if cfg.use_mla else "wq"].shape)}
    res["layouts"] = {b: repr(eng.cache_layout(b)) for b in buckets}
    res["graphed"] = eng.programs.stats()["graphed"]
    # the main path: counts zeroed just before, read just after
    cuda.reset_launches()
    comm.reset()
    groups = {}
    for b in buckets:
        r = eng.generate(tp_moe_tokens(cfg, b, spec["prompt"], dev), steps)
        groups[b] = {"prefill_s": r.prefill_s, "per_token_s": r.per_token_s,
                     "buckets": list(r.buckets),
                     "tokens0": r.tokens[0].tolist(),
                     "collectives": eng.collectives("decode", b),
                     "contract": tp_moe_contract(cfg, b, 2)}
    if spec["queue"]:
        t0 = time.perf_counter()
        results, stats = eng.serve_queue(tp_moe_queue(cfg, spec["queue"]))
        _sync(dev)
        res["queue"] = {"seconds": time.perf_counter() - t0,
                        "admitted": stats.admitted, "steps": stats.steps,
                        "generated": stats.generated_tokens,
                        "tokens": [q.tokens.tolist() for q in results]}
    res["launches"] = dict(cuda.launches)
    res["designs"] = dict(cuda.design_launches)
    res["comm"] = collective_bytes(comm.records)
    res["staged"] = sorted(set(staged_ops(comm.records)))
    res["groups"] = groups
    res["misses"] = registry.stats()["misses"]
    hr = eng.health_report()
    res["healthy"] = hr["healthy"] and not hr["failpoints"]
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    sides = {b: tp_moe_side(eng, cfg, b, spec) for b in buckets}
    planted = tp_moe_planted(eng, cfg, spec, name)
    del eng, lay
    _free(dev.type)
    cmp = {}
    if mesh.rank == 0:
        params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
        one = Engine(model, params, axes, **kw)
        del params
        one.programs = ProgramStore(model, device=dev, capture=False)
        for b in buckets:
            want = tp_moe_side(one, cfg, b, spec)
            forced = tp_moe_side(one, cfg, b, spec, replay=sides[b])
            timed = one.generate(tp_moe_tokens(cfg, b, spec["prompt"], dev),
                                 steps)
            agree = sum(x == y for x, y in zip(groups[b]["tokens0"],
                                              timed.tokens[0].tolist()))
            cmp[b] = {**tp_moe_compare(cfg, sides[b], want, forced,
                                       {f: p[b] for f, p in
                                        planted.items()}),
                      "one_rank_per_token_s": timed.per_token_s,
                      "one_rank_prefill_s": timed.prefill_s,
                      "row0_tokens_agree": agree, "steps": steps}
        del one
        _free(dev.type)
    res["compare"] = cmp


def tp_moe_checks(ranks: list) -> list:
    """What the ranks' results break of the tp.moe paths' contract."""
    bad = []
    for name, spec in TP_MOE.items():
        cfg = tp_moe_cfg(name)
        e, ff = cfg.num_experts, cfg.d_ff_expert
        width = (cfg.head_dim + cfg.rope_head_dim if cfg.use_mla
                 else cfg.head_dim)
        n_scan = cfg.num_layers - cfg.first_k_dense
        for rank in ranks:
            rk, res = rank["rank"], rank["moe"][name]
            where = f"{name} rank {rk}"
            if res["misses"] or not res["healthy"]:
                bad.append(f"{where}: {res['misses']} misses, healthy "
                           f"{res['healthy']}")
            pieces = {"w_gate": [n_scan, e // 2, cfg.d_model, ff],
                      "router": [n_scan, cfg.d_model, e // 2],
                      "heads": [n_scan, cfg.q_lora_rank if cfg.use_mla
                                else cfg.d_model,
                                cfg.num_heads * width // 2]}
            if res["pieces"] != pieces:
                bad.append(f"{where}: pieces {res['pieces']} != {pieces}")
            if cfg.use_mla and not all("seq='model'" in v for v in
                                       res["layouts"].values()):
                bad.append(f"{where}: latent cache layouts {res['layouts']}")
            designs = res["designs"]
            off = {d for d in designs if d.startswith("skinny_")
                   and d not in ("skinny_wgmma", "skinny_stream")}
            if off or not any(designs.get(d) for d in ("skinny_wgmma",
                                                       "skinny_stream")):
                bad.append(f"{where}: skinny designs {designs}")
            if bool(res["launches"].get("flash_attention")) != spec["flash"]:
                bad.append(f"{where}: flash launches "
                           f"{res['launches'].get('flash_attention', 0)}, "
                           f"expected {'some' if spec['flash'] else 'none'}")
            if not res["load"]["launches"].get("pack_blocks"):
                bad.append(f"{where}: no pack at load")
            for b, g in res["groups"].items():
                if g["collectives"] != g["contract"]:
                    bad.append(f"{where} b={b}: collectives "
                               f"{g['collectives']} != contract "
                               f"{g['contract']}")
            if spec["queue"] and res["queue"]["admitted"] != len(
                    spec["queue"]):
                bad.append(f"{where}: queue {res['queue']}")
        if spec["queue"] and (ranks[0]["moe"][name]["queue"]["tokens"]
                              != ranks[1]["moe"][name]["queue"]["tokens"]):
            bad.append(f"{name}: the ranks' queue tokens differ")
        cmp = ranks[0]["moe"][name]["compare"]
        if not sum(c["prefill_positions_compared"] for c in cmp.values()):
            bad.append(f"{name}: rank 0 compared nothing: {cmp}")
        for b, c in cmp.items():
            if not c["within"]:
                bad.append(f"{name} b={b}: rank 0 vs the one-rank engine {c}")
            if not c["routing_within"]:
                bad.append(f"{name} b={b}: the first MoE layer's routing "
                           f"breaks its bound: flips "
                           f"{c['first_layer_flip_frac']}, gap "
                           f"{c['first_layer_gap_max']}")
        for fault, need in TP_MOE_FAULTS[name].items():
            least = min((c["planted"][fault]["bounds_outside"]
                         for c in cmp.values()), default=0.0)
            if not least > need:
                bad.append(f"{name}: the planted {fault} lands {least} "
                           f"bounds outside at its least bucket, not "
                           f"over {need}")
            if fault == "router_order" and not all(
                    c["planted"][fault]["first_layer_flip_frac"]
                    > TP_MOE_FLIPS and c["planted"][fault][
                        "first_layer_gap_max"] > TP_MOE_GAP
                    for c in cmp.values()):
                bad.append(f"{name}: the planted {fault} passes a limit "
                           f"of the routing bound")
    return bad


# ---------------------------------------------------------------------------
# tp.family: the SSM, hybrid, VLM and encoder-decoder families under tensor
# parallelism, in the tp phase's ranks
# ---------------------------------------------------------------------------

# Each at its published widths, bf16, seeded, cut in depth, each rank
# drawing every leaf whole on the card and keeping its piece as it is
# drawn (``init_pieces``; an SSM leaf's concatenated axis by segments), at
# one bucket (the script's time limit): Mamba2-780m at 4
# layers (48 SSM heads, 24 a rank; no flash), 4 x 256; Zamba2-2.7B at 6
# layers (one group: 6 Mamba layers and one application of the shared
# block, 16 of its 32 heads a rank, flash at D 80), 2 x 512; the LLaVA-NeXT
# backbone at 1 layer (2880 seeded image embeddings ahead of 192 tokens:
# flash at D 128 over 3072 positions, 16 of 32 query and 4 of 8 KV heads a
# rank), 1 x 3072; whisper-base at 3 + 3 layers (1500 seeded frames, 4 of 8
# heads a rank, flash at D 64 over the decoder's 256-token prompt; its odd
# vocabulary whole on every rank), 4 x 256.  (The LLaVA and whisper paths
# were cut from 2 layers and from 6 + 6 to pay for the ``tp2d`` phase's
# ``TP2D_FAMILIES``, which serve both models deeper on a superset mesh.)
TP_FAMILIES = {
    "mamba2": dict(arch="mamba2_780m", cut={"num_layers": 4},
                   buckets=(4,), prompt=256, steps=8, flash=False),
    "zamba2": dict(arch="zamba2_2_7b", cut={"num_layers": 6},
                   buckets=(2,), prompt=512, steps=4, flash=True),
    "llava": dict(arch="llava_next_mistral_7b", cut={"num_layers": 1},
                  buckets=(1,), prompt=192, steps=4, flash=True),
    "whisper": dict(arch="whisper_base",
                    cut={"num_layers": 3, "encoder_layers": 3}, buckets=(4,),
                    prompt=256, steps=8, flash=True),
}
# each path's per-shard skinny-A leaves at model=2, (K, N, bias, epilogue,
# stacked layers; 0: one copy): Mamba2's segmented w_in piece (its heads'
# z / x / dt and the whole B / C: 1536 + 1536 + 128 + 128 + 24 = 3352
# columns, zero-padded to whole blocks) and its w_out rows; Zamba2's w_in
# piece (2560 + 2560 + 64 + 64 + 40 = 5288) and the shared block's wq
# heads (its input [x, x0] 5120 wide, one copy); LLaVA's wq heads;
# whisper's four piece shapes: the heads of wq / wk / wv (self and cross)
# and the rows of wo, the MLP's w_in columns with the bias and GELU in
# the epilogue and its w_out rows with the first rank's bias; each at
# decode rows and its path's prefill rows (whisper's encoder: bucket x
# 1500 frames)
TP_FAMILY_LEAVES = {
    "mamba2": {"w_in": (1536, 3352, False, None, 4),
               "w_out": (1536, 1536, False, None, 4)},
    "zamba2": {"w_in": (2560, 5288, False, None, 6),
               "wq": (5120, 1280, False, None, 0)},
    "llava": {"wq": (4096, 2048, False, None, 1)},
    "whisper": {"wq": (512, 256, False, None, 3),
                "wo": (256, 512, False, None, 3),
                "w_in": (512, 1024, True, "gelu", 3),
                "w_out": (1024, 512, True, None, 3)},
}
TP_FAMILY_M = {"mamba2": (4, 1024), "zamba2": (2, 1024),
               "llava": (1, 3072), "whisper": (4, 1024, 6000)}
# each path's flash prefill on one rank's heads, (B, S, H, KH, D): Zamba2's
# shared block (2 x 512, 16 heads of 80), LLaVA's 3072 positions (16 query
# heads on 4 KV heads of 128), whisper's decoder (4 x 256, 4 heads of 64);
# held in the kernels phase
TP_FAMILY_FLASH = {"zamba2": (2, 512, 16, 16, 80),
                   "llava": (1, 3072, 16, 4, 128),
                   "whisper": (4, 256, 4, 4, 64)}
# The planted controls of the logits bound (``TP_LOGITS_TOL``), each alone
# on both ranks (``tp_family_planted``), read at rank 0 against the
# one-rank engine as the sound run is: every prefill position's logits,
# the first decode step's, and whisper's cross cache (rank 0's heads):
# * ``norm``: layer 0's gated-norm all-reduce skipped (each rank normalizes
#   by its own channels' sum of squares);
# * ``shared_wo``: the shared block's wo all-reduce skipped;
# * ``embeds``: the image embeddings zeroed on rank 1;
# * ``enc_w_down``: every encoder layer's MLP all-reduce skipped;
# * ``naive_cut``: w_in cut contiguously (each rank a window of its
#   segmented width from its contiguous offset, wrapping at the end), not
#   by segments; the engine built anew from such pieces.
# Each must land over ``need`` bounds outside, where it acts.
TP_FAMILY_FAULTS = {
    "mamba2": {"norm": 1.0, "naive_cut": 1.0},
    "zamba2": {"norm": 1.0, "shared_wo": 1.0},
    "llava": {"embeds": 1.0},
    "whisper": {"enc_w_down": 1.0},
}
# the LLaVA path's image embeddings and whisper's frames: seeded normal
# draws at these scales (the token table's 0.02 and unit-scale frames)
TP_FAMILY_INPUT_SCALE = {"embeds": 0.02, "enc_frames": 1.0}


def tp_family_cfg(name: str):
    from repro_torch.configs.base import get_config
    spec = TP_FAMILIES[name]
    return dataclasses.replace(get_config(spec["arch"]), **spec["cut"])


def tp_family_max_len(cfg, spec: dict) -> int:
    """The image embeddings, the prompt, the decode steps and 8 spare
    slots, a multiple of 8."""
    image = cfg.num_image_tokens if cfg.embeds_input else 0
    return -(-(image + spec["prompt"] + spec["steps"] + 8) // 8) * 8


def tp_family_batch(cfg, b: int, prompt: int, device) -> dict:
    """A group of ``b`` seeded prompts and, for the VLM, its seeded image
    embeddings, for the encoder-decoder its seeded frames (bf16)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(400 + b)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt),
                                   generator=g, dtype=torch.int32)}
    extra = {}
    if cfg.embeds_input:
        extra["embeds"] = (b, cfg.num_image_tokens, cfg.d_model)
    if cfg.is_encoder_decoder:
        extra["enc_frames"] = (b, cfg.encoder_seq, cfg.d_model)
    for k, shape in extra.items():
        out[k] = (torch.randn(shape, generator=g)
                  * TP_FAMILY_INPUT_SCALE[k]).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}


def tp_family_contract(cfg, rows: int, tp: int) -> dict:
    """One decode call's collectives on a rank, from the shapes (bf16
    activations, the gated norm's fp32 sums): where the vocabulary splits
    (not whisper-base's odd one), the lookup's all-reduce and the logits'
    all-gather; per Mamba2 layer the gated norm's (rows, 1) fp32 sum of
    squares and ``w_out``'s all-reduce; per application of the hybrid's
    shared block, and per layer of the dense backbone, ``wo``'s and
    ``w_down``'s all-reduce; per decoder layer of the encoder-decoder the
    self- and cross-attention ``wo`` and the MLP's ``w_out``.  The
    reference's ring multipliers over a group of ``tp``."""
    d, bf, f4 = cfg.d_model, 2, 4
    split_vocab = cfg.vocab_size % tp == 0
    ar = [rows * d * bf] if split_vocab else []
    ag = [rows * cfg.vocab_size * bf] if split_vocab else []
    if cfg.family in ("ssm", "hybrid"):
        for _ in range(cfg.num_layers):
            ar += [rows * f4, rows * d * bf]
    if cfg.family == "hybrid":
        ar += [rows * d * bf] * 2 * (cfg.num_layers // cfg.attn_every)
    if cfg.family == "vlm":
        ar += [rows * d * bf] * 2 * cfg.num_layers
    if cfg.family == "encdec":
        ar += [rows * d * bf] * 3 * cfg.num_layers
    f_ar = 2 * (tp - 1) / tp if tp > 1 else 0.0
    f_ag = (tp - 1) / tp if tp > 1 else 0.0
    out = {"all-reduce": {"count": len(ar), "bytes_moved": sum(ar) * f_ar,
                          "tensor_bytes": float(sum(ar))}}
    if ag:
        out["all-gather"] = {"count": len(ag), "bytes_moved": sum(ag) * f_ag,
                             "tensor_bytes": float(sum(ag))}
    return out


def tp_family_side(eng, cfg, b: int, spec: dict, batch=None,
                   group=None) -> dict:
    """One engine's side of the comparison at bucket ``b``, on the host:
    every position's prefill logits (the model's forward in the engine's
    cell context), then the group's first decode step (its input and
    logits) and, for the encoder-decoder, the cross cache that prefill
    wrote (the first 4 heads: rank 0's).  ``group``: (the whole group,
    its first row) where ``batch`` is a data line's rows of a bucket the
    data axis splits (FSDP): ``generate`` serves the whole group, and its
    first step is read at the line's rows."""
    import torch
    from repro_torch.core.linear import serving_ctx
    batch = batch or tp_family_batch(cfg, b, spec["prompt"], eng.device)
    with torch.inference_mode(), serving_ctx(), eng.programs.context(b):
        logits = eng.model.forward(eng.params, batch)[0].cpu()
    first = eng.generate(batch if group is None else group[0], 1)
    r0 = 0 if group is None else group[1]
    n = batch["tokens"].shape[0]
    out = {"logits": logits,
           "first_tokens": first.tokens[r0:r0 + n, 0].cpu(),
           "first_logits": first.logits_last[r0:r0 + n].cpu()}
    if cfg.is_encoder_decoder:
        cache = eng.programs.static_cache(b, eng.max_len)
        heads = cfg.num_kv_heads // 2
        out["cross"] = torch.cat([cache[k][..., :heads, :].cpu()
                                  for k in ("cross_k", "cross_v")])
    return out


@contextlib.contextmanager
def _patched(mod, attr, value):
    sound = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield sound
    finally:
        setattr(mod, attr, sound)


def _naive_segments(sound):
    """``tp_segments`` as a contiguous cut would place ``w_in``'s pieces:
    each rank a window of its segmented width starting at its contiguous
    offset, wrapping at the end of the axis (the conv and the rest as the
    sound cut)."""
    def naive(cfg, tp, rank, width):
        segs = sound(cfg, tp, rank, width)
        if segs is None or width != 2 * cfg.d_inner + 2 * (
                cfg.ssm_groups * cfg.ssm_state) + cfg.ssm_heads:
            return segs
        n = sum(b - a for a, b in segs)
        lo = rank * width // tp
        if lo + n <= width:
            return [(lo, lo + n)]
        return [(lo, width), (0, lo + n - width)]
    return naive


def tp_family_planted(mesh, eng, cfg, spec: dict, name: str, make) -> dict:
    """The controls of the logits bound (``TP_FAMILY_FAULTS``), each
    planted alone on every rank alike (the ranks stay in step): {fault:
    {bucket: its side}}.  ``make()`` builds the path's engine anew (the
    naive cut's).  Raises unless each fault's site ran."""
    import torch
    from repro_torch.models import attention, layers, mamba2
    calls = [0]
    out = {}
    for fault in TP_FAMILY_FAULTS[name]:
        calls[0] = 0
        e, ctx, batch_of = eng, contextlib.nullcontext(), None
        if fault == "norm":
            def norm_sum(ss, cfg_, _sound=mamba2.norm_sum):
                calls[0] += 1
                if (calls[0] - 1) % cfg.num_layers == 0:
                    return ss
                return _sound(ss, cfg_)
            ctx = _patched(mamba2, "norm_sum", norm_sum)
        elif fault == "shared_wo":
            def skip_wo(x, axis, dim, _sound=attention.tp_sum):
                if axis == "qheads":
                    calls[0] += 1
                    return x
                return _sound(x, axis, dim)
            ctx = _patched(attention, "tp_sum", skip_wo)
        elif fault == "enc_w_down":
            def skip_enc(x, axis, dim, _sound=layers.tp_sum):
                if axis == "mlp" and x.shape[1] == cfg.encoder_seq:
                    calls[0] += 1
                    return x
                return _sound(x, axis, dim)
            ctx = _patched(layers, "tp_sum", skip_enc)
        elif fault == "embeds":
            def batch_of(b):
                bt = tp_family_batch(cfg, b, spec["prompt"], eng.device)
                if mesh.rank == 1:
                    calls[0] += 1
                    bt["embeds"] = torch.zeros_like(bt["embeds"])
                return bt
        elif fault == "naive_cut":
            with _patched(mamba2, "tp_segments",
                          _naive_segments(mamba2.tp_segments)):
                calls[0] += 1
                e = make()
        with ctx:
            out[fault] = {b: tp_family_side(
                e, cfg, b, spec, batch_of(b) if batch_of else None)
                for b in spec["buckets"]}
        if e is not eng:
            del e
            _free(eng.device.type)
        if not calls[0] and not (fault == "embeds" and mesh.rank != 1):
            raise AssertionError(f"tp.family.{name}: the planted {fault} "
                                 f"never ran")
    return out


def tp_family_compare(cfg, got: dict, want: dict, planted: dict) -> dict:
    """Rank 0's side against the one-rank engine's under
    ``TP_LOGITS_TOL``: every prefill position's logits, the first decode
    step's on the rows whose input (the prefill's argmax) agrees, and the
    encoder-decoder's cross cache; each planted control's readings the
    same way, its distance in bounds (its largest reading over the
    bound's ``atol``)."""
    def readings(side):
        out = {"prefill": within(side["logits"], want["logits"],
                                 **TP_LOGITS_TOL)[1]}
        rows = side["first_tokens"] == want["first_tokens"]
        out["decode"] = (within(side["first_logits"][rows],
                                want["first_logits"][rows],
                                **TP_LOGITS_TOL)[1]
                         if bool(rows.any()) else 0.0)
        out["decode_rows"] = int(rows.sum())
        if "cross" in side:
            out["cross"] = within(side["cross"], want["cross"],
                                  **TP_LOGITS_TOL)[1]
        return out

    mine = readings(got)
    errs = [v for k, v in mine.items() if k != "decode_rows"]
    res = {"rows": int(got["first_tokens"].shape[0]),
           "positions": int(got["logits"].shape[1]),
           **{f"{k}_max_abs_err" if k != "decode_rows" else k: v
              for k, v in mine.items()},
           "within": max(errs) <= TP_LOGITS_TOL["atol"],
           "ref_absmax": float(want["logits"].float().abs().max()),
           "planted": {}}
    for fault, side in planted.items():
        r = readings(side)
        worst = max(v for k, v in r.items() if k != "decode_rows")
        res["planted"][fault] = {
            **{f"{k}_max_abs_err" if k != "decode_rows" else k: v
               for k, v in r.items()},
            "bounds_outside": worst / TP_LOGITS_TOL["atol"]}
    return res


def tp_family_serve(mesh, name: str, res: dict) -> None:
    """One ``TP_FAMILIES`` path on ``mesh``: load from the rank's pieces,
    the groups (the main path, counted), the comparison's side on both
    ranks, the planted controls; then on rank 0 a one-rank engine of the
    same seeded weights and the comparison.  Fills ``res``."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.models.param import init_pieces
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore
    from repro_torch.sharding import comm

    spec = TP_FAMILIES[name]
    cfg = tp_family_cfg(name)
    model = build_model(cfg)
    dev = mesh.device
    buckets, steps = spec["buckets"], spec["steps"]
    kw = dict(max_len=tp_family_max_len(cfg, spec), buckets=buckets,
              max_prompt=spec["prompt"], device=dev.type)

    def make():
        with init_pieces(mesh, cfg):
            params, axes = model.init(torch.Generator(device=dev)
                                      .manual_seed(0))
        return Engine(model, params, axes, mesh=mesh, **kw)

    registry.reset_stats()
    cuda.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = make()
    _sync(dev)
    res["load"] = {"seconds": time.perf_counter() - t0,
                   "launches": dict(cuda.launches),
                   "designs": dict(cuda.design_launches),
                   "packed": sorted(eng.pack_report),
                   "head_blocks": eng.pack_report.get("embed/head")}
    res["pieces"] = {}
    for path in _paths(eng.params):
        if path[-1] in ("w_in", "wq", "tok") and path[0] != "enc_layers":
            leaf = eng.params
            for key in path:
                leaf = leaf[key]
            res["pieces"]["/".join(path)] = list(leaf.shape)
    cache = eng.programs.static_cache(buckets[0], kw["max_len"])
    res["cache"] = {k: list(v.shape) for k, v in cache.items()}
    res["layouts"] = {b: repr(eng.cache_layout(b)) for b in buckets}
    res["graphed"] = eng.programs.stats()["graphed"]
    # the main path: counts zeroed just before, read just after
    cuda.reset_launches()
    comm.reset()
    groups = {}
    for b in buckets:
        r = eng.generate(tp_family_batch(cfg, b, spec["prompt"], dev), steps)
        groups[b] = {"prefill_s": r.prefill_s, "per_token_s": r.per_token_s,
                     "buckets": list(r.buckets),
                     "tokens0": r.tokens[0].tolist(),
                     "collectives": eng.collectives("decode", b),
                     "contract": tp_family_contract(cfg, b, 2)}
    _sync(dev)
    res["launches"] = dict(cuda.launches)
    res["designs"] = dict(cuda.design_launches)
    res["comm"] = collective_bytes(comm.records)
    res["staged"] = sorted(set(staged_ops(comm.records)))
    res["groups"] = groups
    res["misses"] = registry.stats()["misses"]
    hr = eng.health_report()
    res["healthy"] = hr["healthy"] and not hr["failpoints"]
    res["degradations"] = hr["degradations"]["total"]
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    sides = {b: tp_family_side(eng, cfg, b, spec) for b in buckets}
    planted = tp_family_planted(mesh, eng, cfg, spec, name, make)
    del eng
    _free(dev.type)
    cmp = {}
    if mesh.rank == 0:
        params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
        one = Engine(model, params, axes, **kw)
        del params
        one.programs = ProgramStore(model, device=dev, capture=False)
        for b in buckets:
            want = tp_family_side(one, cfg, b, spec)
            timed = one.generate(tp_family_batch(cfg, b, spec["prompt"], dev),
                                 steps)
            agree = sum(x == y for x, y in zip(groups[b]["tokens0"],
                                              timed.tokens[0].tolist()))
            cmp[b] = {**tp_family_compare(cfg, sides[b], want,
                                          {f: p[b] for f, p in
                                           planted.items()}),
                      "one_rank_per_token_s": timed.per_token_s,
                      "one_rank_prefill_s": timed.prefill_s,
                      "row0_tokens_agree": agree, "steps": steps}
        del one
        _free(dev.type)
    res["compare"] = cmp


def tp_family_checks(ranks: list) -> list:
    """What the ranks' results break of the tp.family paths' contract."""
    bad = []
    for name, spec in TP_FAMILIES.items():
        cfg = tp_family_cfg(name)
        for rank in ranks:
            rk, res = rank["rank"], rank["family"][name]
            where = f"{name} rank {rk}"
            if res["misses"] or not res["healthy"] or res["staged"]:
                bad.append(f"{where}: {res['misses']} misses, healthy "
                           f"{res['healthy']}, staged {res['staged']}")
            designs = res["designs"]
            off = {d for d in designs if d.startswith("skinny_")
                   and d not in ("skinny_wgmma", "skinny_stream")}
            off |= {d for d in designs if d.startswith(("tall_", "flash_"))
                    and d not in ("tall_wgmma", "flash_wgmma")}
            if off or not any(designs.get(d) for d in ("skinny_wgmma",
                                                       "skinny_stream")):
                bad.append(f"{where}: designs {designs}")
            if bool(res["launches"].get("flash_attention")) != spec["flash"]:
                bad.append(f"{where}: flash launches "
                           f"{res['launches'].get('flash_attention', 0)}, "
                           f"expected {'some' if spec['flash'] else 'none'}")
            if not res["load"]["launches"].get("pack_blocks"):
                bad.append(f"{where}: no pack at load")
            if cfg.ssm_state:
                seg = cfg.d_inner // 2 + 2 * cfg.ssm_groups * cfg.ssm_state
                if res["cache"]["conv"][-1] != seg:
                    bad.append(f"{where}: conv cache {res['cache']['conv']}")
            for b, g in res["groups"].items():
                if g["collectives"] != g["contract"]:
                    bad.append(f"{where} b={b}: collectives "
                               f"{g['collectives']} != contract "
                               f"{g['contract']}")
        cmp = ranks[0]["family"][name]["compare"]
        if not sum(c["decode_rows"] for c in cmp.values()):
            bad.append(f"{name}: rank 0 compared no decode row: {cmp}")
        for b, c in cmp.items():
            if not c["within"]:
                bad.append(f"{name} b={b}: rank 0 vs the one-rank engine {c}")
        for fault, need in TP_FAMILY_FAULTS[name].items():
            least = min((c["planted"][fault]["bounds_outside"]
                         for c in cmp.values()), default=0.0)
            if not least > need:
                bad.append(f"{name}: the planted {fault} lands {least} "
                           f"bounds outside at its least bucket, not over "
                           f"{need}")
    return bad


def tp_checks(ranks: list) -> list:
    """What the two ranks' results break of the tp phase's contract."""
    bad = []
    for res in ranks:
        rk = res["rank"]
        if res["backend"] != "gloo" or res["graphed"] is not False:
            bad.append(f"rank {rk}: backend {res['backend']}, graphed "
                       f"{res['graphed']}")
        if not res["capture_refused"]:
            bad.append(f"rank {rk}: a gloo store accepted capture")
        if res["misses"] or not res["healthy"]:
            bad.append(f"rank {rk}: {res['misses']} misses, healthy "
                       f"{res['healthy']}")
        designs = res["designs"]
        if not any(designs.get(d) for d in ("skinny_wgmma", "skinny_stream")):
            bad.append(f"rank {rk}: no skinny launch: {designs}")
        off = {d for d in designs if d.startswith("skinny_")
               and d not in ("skinny_wgmma", "skinny_stream")}
        if off or not res["launches"].get("flash_attention"):
            bad.append(f"rank {rk}: skinny designs {sorted(off)} or no "
                       f"flash on the path: {designs}")
        for b, g in res["groups"].items():
            if g["collectives"] != g["contract"]:
                bad.append(f"rank {rk} b={b}: collectives {g['collectives']}"
                           f" != contract {g['contract']}")
        if res["queue"]["admitted"] != len(TP_QUEUE):
            bad.append(f"rank {rk}: queue admitted {res['queue']}")
        for p in res["paper"]:
            if p["collectives"] or not p["within"]:
                bad.append(f"rank {rk} N={p['n']}: distributed_tsmm "
                           f"collectives {p['collectives']}, within "
                           f"{p['within']} ({p['max_abs_err']})")
            if not any(p["launches"].get(t) for t in TALL):
                bad.append(f"rank {rk} N={p['n']}: no tall launch "
                           f"{p['launches']}")
            if p["ksplit"]["collectives"] != ["all-reduce"] or \
                    not p["ksplit"]["within"]:
                bad.append(f"rank {rk} N={p['n']}: k-split {p['ksplit']}")
        ring = res["ring"]
        if (ring["ops"] != ["collective-permute"] * 2 or not all(
                ring["staged"]) or not ring["within"]):
            bad.append(f"rank {rk}: the ring {ring}")
    if ranks[0]["queue"]["tokens"] != ranks[1]["queue"]["tokens"]:
        bad.append("the ranks' queue tokens differ")
    if not ranks[0]["compare"]:
        bad.append("rank 0 compared nothing with the one-rank engine")
    for b, c in ranks[0]["compare"].items():
        if (c["first_tokens_equal"] != c["rows"] or not c["within"]
                or c["row0_tokens_agree"] != c["steps"]):
            bad.append(f"b={b}: rank 0 vs the one-rank engine {c}")
        if c["planted"]["within"]:
            bad.append(f"b={b}: the planted fault passed the logits bound "
                       f"{c['planted']}")
    return bad


def phase_tp():
    """Tensor-parallel serving and the distributed TSMM on the card: the
    install sweep with ``--mesh model=2``; two ranks (``torch.distributed.
    run``) sharing the card over gloo serve qwen1.5-4b (full width, 4
    layers, bf16) lookup-only, with rank 0's logits against a one-rank
    engine and one decode call's collectives against the contract; the
    distributed TSMM and the conventional k-split at the paper's A; the
    MoE family (``TP_MOE``: OLMoE-1B-7B and DeepSeek-V2 at their
    published widths, cut in depth) lookup-only after their own install
    sweeps, each against a one-rank engine with the flipped expert
    choices counted and bounded, and the planted controls; the SSM,
    hybrid, VLM and encoder-decoder families (``TP_FAMILIES``: Mamba2-780m,
    Zamba2-2.7B, the LLaVA-NeXT backbone, whisper-base) lookup-only after
    one sweep of the four, each against a one-rank engine with its planted
    controls; then NCCL at world size 1 in this process with the cells
    captured (qwen's grid, OLMoE's and Zamba2's).
    Returns each rank's launches on each path's main path (and at
    load), the paper's, and the per-shard kernel cases."""
    import signal

    import torch
    from repro_torch.core import install
    t_phase = time.perf_counter()
    _free("cuda")
    t0 = time.perf_counter()
    inst = install.main(["--archs", "qwen1_5_4b", "--override",
                         f"num_layers={TP_LAYERS}", "--max-batch",
                         str(max(TP_BUCKETS)), "--max-prompt",
                         str(TP_PROMPT), "--mesh", "model=2"])
    emit({"phase": "tp.install", "seconds": time.perf_counter() - t0,
          "plans": inst["plans"]})
    for name, spec in TP_MOE.items():
        t0 = time.perf_counter()
        cut = ",".join(f"{k}={v}" for k, v in spec["cut"].items())
        inst = install.main(["--archs", spec["arch"], "--override", cut,
                             "--max-batch", str(max(spec["buckets"])),
                             "--max-prompt", str(spec["prompt"]),
                             "--mesh", "model=2"])
        emit({"phase": f"tp.moe.{name}.install",
              "seconds": time.perf_counter() - t0, "plans": inst["plans"]})
    # the four families' sweeps at model=2 in this one process, each at
    # its path's buckets and the one length bucket its prompts take,
    # written in one flush
    from repro_torch.core import registry
    t0 = time.perf_counter()
    plans = {name: install.install_arch(
        tp_family_cfg(name), spec["buckets"], (spec["prompt"],),
        mesh=install.parse_mesh("model=2"), device="cuda")
        for name, spec in TP_FAMILIES.items()}
    registry.flush()
    emit({"phase": "tp.family.install", "seconds": time.perf_counter() - t0,
          "plans": plans})
    t0 = time.perf_counter()
    shard_cases = tp_shard_cases()
    emit({"phase": "tp.kernels.seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    moe_cases = {}
    for name, spec in TP_MOE.items():
        cfg = tp_moe_cfg(name)
        moe_cases[name] = tp_shard_cases(
            TP_MOE_LEAVES[name], cfg.num_layers - cfg.first_k_dense,
            spec["buckets"], TP_MOE_M[name], mode=f"tp.moe.{name}")
        _free("cuda")
    emit({"phase": "tp.moe.kernels.seconds",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    family_cases = {}
    for name, spec in TP_FAMILIES.items():
        family_cases[name] = tp_shard_cases(
            TP_FAMILY_LEAVES[name], 0, spec["buckets"], TP_FAMILY_M[name],
            mode=f"tp.family.{name}")
        _free("cuda")
    emit({"phase": "tp.family.kernels.seconds",
          "seconds": time.perf_counter() - t0})
    _free("cuda")
    out_dir = tempfile.mkdtemp(prefix="tp-", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", os.path.abspath(__file__), "--tp-worker",
         out_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    ranks = []
    for r in range(2):
        path = os.path.join(out_dir, f"tp_rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    if proc.returncode != 0:
        raise AssertionError(f"tp: the ranks exited {proc.returncode}:\n"
                             f"{out[-3000:]}\n{err[-6000:]}")
    bad = tp_checks(ranks) + tp_moe_checks(ranks) + tp_family_checks(ranks)
    held = {c["kernel"] for c in shard_cases}
    for res in ranks:
        unheld = sorted(k for k in SKINNY
                        if res["launches"].get(k) and k not in held)
        if unheld:
            bad.append(f"rank {res['rank']}: {unheld} launched at shapes "
                       f"tp.kernels did not hold against the plain version")
        for name in TP_MOE:
            held = {c["kernel"] for c in moe_cases[name]}
            unheld = sorted(k for k in SKINNY if res["moe"][name][
                "launches"].get(k) and k not in held)
            if unheld:
                bad.append(f"{name} rank {res['rank']}: {unheld} launched "
                           f"at shapes tp.moe.kernels did not hold")
        for name in TP_FAMILIES:
            held = {c["kernel"] for c in family_cases[name]}
            unheld = sorted(k for k in SKINNY + TALL if res["family"][name][
                "launches"].get(k) and k not in held)
            if unheld:
                bad.append(f"{name} rank {res['rank']}: {unheld} launched "
                           f"at shapes tp.family.kernels did not hold")
    for name in TP_FAMILIES:
        for res in ranks:
            m = res["family"][name]
            emit({"phase": f"tp.family.{name}.rank", "rank": res["rank"],
                  **{k: m[k] for k in (
                      "seconds", "load", "pieces", "cache", "layouts",
                      "graphed", "launches", "designs", "comm", "staged",
                      "misses", "healthy", "degradations", "peak_bytes",
                      "groups")}})
        emit({"phase": f"tp.family.{name}", "logits_tol": TP_LOGITS_TOL,
              "faults_need": TP_FAMILY_FAULTS[name],
              "compare": ranks[0]["family"][name]["compare"],
              "decode_collectives": {
                  b: g["collectives"]
                  for b, g in ranks[0]["family"][name]["groups"].items()}})
    for name in TP_MOE:
        for res in ranks:
            m = res["moe"][name]
            emit({"phase": f"tp.moe.{name}.rank", "rank": res["rank"],
                  **{k: m[k] for k in (
                      "load", "pieces", "layouts", "graphed", "launches",
                      "designs", "comm", "staged", "misses", "healthy",
                      "peak_bytes", "groups")},
                  "queue": m.get("queue")})
        emit({"phase": f"tp.moe.{name}", "logits_tol": TP_LOGITS_TOL,
              "compare": ranks[0]["moe"][name]["compare"],
              "decode_collectives": {
                  b: g["collectives"]
                  for b, g in ranks[0]["moe"][name]["groups"].items()}})
    for res in ranks:
        emit({"phase": "tp.rank", **{k: res[k] for k in (
            "rank", "backend", "device", "load", "graphed", "launches",
            "designs", "comm", "staged", "misses", "healthy", "queue",
            "paper", "ring")}, "groups": res["groups"]})
    r0 = ranks[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"phase": "tp", "nvidia_smi": smi, "ranks": 2,
          "backend": r0["backend"],
          "note": "two ranks share one card over gloo: correctness and the "
                  "kernels at per-shard shapes, not a speed",
          "staged_ops": sorted({s for r in ranks for s in r["staged"]}
                               | {"collective-permute (ring: gloo send / "
                                  "recv on CUDA memory)"
                                  for r in ranks if any(r["ring"]["staged"])}),
          "logits_tol": TP_LOGITS_TOL, "compare": r0["compare"],
          "per_token_s_two_ranks_one_card": {
              b: g["per_token_s"] for b, g in r0["groups"].items()},
          "decode_collectives": {b: g["collectives"]
                                 for b, g in r0["groups"].items()},
          "misses": [r["misses"] for r in ranks],
          "workers_s": time.perf_counter() - t0})
    if bad:
        raise AssertionError("tp: " + "; ".join(bad))
    for name in ("tp", "olmoe", "zamba2"):
        nccl = tp_nccl(out_dir, name)
        phase = ("tp.nccl" if name == "tp" else f"tp.moe.{name}.nccl"
                 if name in TP_MOE else f"tp.family.{name}.nccl")
        emit({"phase": phase, **nccl})
        if not (nccl["graphed"]
                and nccl["cells_bit_equal"] == nccl["cells_checked"]
                and nccl["cells_checked"] and nccl["group_tokens_equal"]
                and nccl["group_logits_equal"]
                and nccl["decode_collectives"] == nccl["contract"]):
            raise AssertionError(f"{phase}: {nccl}")
        _free("cuda")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "tp", "seconds": time.perf_counter() - t_phase})
    launches = {f"tp.rank{r['rank']}": r["launches"] for r in ranks}
    loads = {f"tp.rank{r['rank']}.load": r["load"]["launches"]
             for r in ranks}
    for name in TP_MOE:
        launches.update({f"tp.moe.{name}.rank{r['rank']}":
                         r["moe"][name]["launches"] for r in ranks})
        loads.update({f"tp.moe.{name}.rank{r['rank']}.load":
                      r["moe"][name]["load"]["launches"] for r in ranks})
    for name in TP_FAMILIES:
        launches.update({f"tp.family.{name}.rank{r['rank']}":
                         r["family"][name]["launches"] for r in ranks})
        loads.update({f"tp.family.{name}.rank{r['rank']}.load":
                      r["family"][name]["load"]["launches"] for r in ranks})
    return launches, loads, \
        {f"tp.rank{r['rank']}.paper.n{p['n']}": p["launches"]
         for r in ranks for p in r["paper"]}, \
        shard_cases + [c for cs in moe_cases.values() for c in cs] \
        + [c for cs in family_cases.values() for c in cs]


# ---------------------------------------------------------------------------
# tp2d: 2D weight-stationary tensor parallelism and FSDP serving
# ---------------------------------------------------------------------------

TP2D_LAYERS = 2                   # qwen1.5-4b at its published widths
# bucket 1: the rules put the cache's sequence on ``data``; 2 its rows (4
# would repeat 2's layout)
TP2D_BUCKETS = (1, 2)
TP2D_PROMPT = 256
TP2D_MAX_LEN = 512
TP2D_STEPS = 4
TP2D_QUEUE = ((200, 4), (256, 3), (64, 5))
TP2D_MODES = {"tp2d": dict(fsdp=True, serve_2d_tp=True),
              "fsdp": dict(fsdp=True)}
# rank 0's bf16 logits against the one-rank engine's on the same weights,
# both modes: each group's prefill logits (every row), and its first decode
# step's logits on every row whose decode input (the prefill's argmax)
# agrees with the one-rank engine's: where bf16 rounds two top logits
# within the bound of each other the argmax may differ, and the prefill
# logits hold that row (the first card run met one such row at bucket 4,
# in both modes alike).  Set before the first card run (PERF.md, PR 29's
# prediction): 2D tensor parallelism
# rounds each k-split partial (wq, wk, wv, w_gate, w_up, the head) to bf16
# before the data group's sum, on top of the TP sums PR 27 bounded at
# 0.25 (its sound run 0.0625), so the same absolute bound, with no term
# relative to the logit; the planted fault (layer 0's w_gate sum over
# the data group skipped) must land at least TP2D_PLANTED x outside it
TP2D_LOGITS_TOL = dict(rtol=0.0, atol=0.25)
TP2D_PLANTED = 10.0
# qwen1.5-4b's packed leaves, (rows, cols, the dim FSDP puts on ``data``):
# a rank's 2D piece is (rows/2, cols/2); FSDP gathers its piece over
# ``data`` into (rows, cols/2) (wq, w_gate, the head) or (rows/2, cols)
# (wo, w_down: their rows on ``model``)
TP2D_LEAVES = {"wq": (2560, 2560, "rows", True, None),
               "wo": (2560, 2560, "cols", False, None),
               "w_gate": (2560, 6912, "rows", False, "silu"),
               "w_down": (6912, 2560, "cols", False, None),
               "head": (2560, 151936, "rows", False, None)}
# 2D: every rank computes the bucket (decode 1 and 2 rows, the 1 x 256 and
# 2 x 256 prefills); FSDP: a data line's rows (decode 1 row at both
# buckets, its 1 x 256 prefill rows); both: the queue's admissions, a row
# at each prompt's length bucket (64, 256)
TP2D_SHARD_M = (1, 2, 64, TP2D_PROMPT, 2 * TP2D_PROMPT)
TP2D_FSDP_ROWS = (1,)
TP2D_FSDP_M = (1, 64, TP2D_PROMPT)


def tp2d_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("qwen1_5_4b"),
                               num_layers=TP2D_LAYERS)


def tp2d_params(model, device):
    """Seeded params with the QKV biases and the norm scales seeded away
    from their init (zeros, ones): a bias added once per data rank, or a
    norm piece gathered out of order, would show."""
    import torch
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    g = torch.Generator(device=device).manual_seed(29)
    att = params["layers"]["attn"]
    for k in ("bq", "bk", "bv"):
        att[k] = (0.1 * torch.randn(att[k].shape, generator=g,
                                    device=device)).to(att[k].dtype)
    for t in (params["layers"]["ln1"], params["layers"]["ln2"],
              params["final_norm"]):
        t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g, device=device))
    return params, axes


def tp2d_tokens(cfg, b: int, device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(200 + b)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, TP2D_PROMPT),
                                    generator=g, dtype=torch.int32)
            .to(device)}


def tp2d_queue(cfg):
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(29)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(TP2D_QUEUE)]


def _ring(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    return 2 * (n - 1) / n if op == "all-reduce" else (n - 1) / n


def tp2d_contract(cfg, mode: str, bucket: int, packed: dict, data: int,
                  model: int, e: int = 2) -> dict:
    """One decode call's collectives on a rank of the dense LM, the VLM's
    or the encoder-decoder's decoder, from the shapes and the rank's
    packed block shapes (``packed``: the engine's pack report),
    activations of ``e`` bytes, as ``(op, group, tensor bytes)`` summed
    into the reference's accounting.

    Both modes: each norm's ``embed`` scale gathered over ``data``, and a
    LayerNorm's bias beside it (at ``data=1`` both whole, and nothing);
    where the rules split the vocabulary over ``model`` (LLaVA's, not
    whisper-base's odd one at ``model=2``) the lookup summed over
    ``model`` and the logits gathered over it; the lookup's columns
    gathered over ``data``; per attention ``wo``'s partials and per MLP
    ``w_down``'s or ``w_out``'s summed over ``model``; where the
    self-attention slots lie on ``data`` (a bucket it cannot split) the
    softmax partials gathered over it.

    2D: every rank computes the bucket; each k-split product (``wq`` /
    ``wk`` / ``wv``, the cross-attention's ``wq``, ``w_gate`` / ``w_up``,
    whisper's ``w_in``, the head) summed over ``data``; ``wo``'s,
    ``w_down``'s and ``w_out``'s columns gathered over ``data``; with the
    caches' rows on ``data`` the self- and the cross-attention outputs
    gathered over it.

    FSDP: a data line computes its rows of a bucket it splits; the ids
    gathered over ``data`` before the lookup; every packed piece gathered
    over ``data`` before use, and whisper's ``b_out`` piece."""
    d, v, H, hd = cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.head_dim
    q, kv, ff = H * hd, cfg.num_kv_heads * hd, cfg.d_ff
    two_d = mode == "tp2d"
    split = data > 1 and bucket % data == 0
    seq = data > 1 and not split
    rows = bucket if two_d or not split else bucket // data
    cols = data if two_d else 1                # the output's column pieces
    vocab = v % model == 0
    encdec = cfg.is_encoder_decoder
    ops = []                                   # (op, group size, bytes)

    def ar(n, b):
        ops.append(("all-reduce", n, b))

    def ag(n, b):
        ops.append(("all-gather", n, b))

    def norm():
        if data > 1:
            ag(data, d * e)
            if encdec:
                ag(data, d * e)                              # the bias

    def blocks(leaf):
        n = 1
        for s in packed[leaf][-4:]:
            n *= s
        return n * data * e

    def product(leaf, n_out):
        """A piece whose rows lie on data (``n_out`` its columns): 2D a
        k-split's sum over data, FSDP its gather (of the packed blocks,
        or of an unpacked (d / data, n_out) piece: a reduced width's)."""
        if two_d:
            ar(data, rows * n_out * e)
        else:
            ag(data, blocks(leaf) if leaf in packed else d * n_out * e)

    def row_parallel(leaf, bias=False):
        """wo, w_down, w_out: rows on model, columns on data."""
        if not two_d:
            ag(data, blocks(leaf))
            if bias and data > 1:
                ag(data, d * e)                              # b_out
        ar(model, rows * d // cols * e)
        if two_d:
            ag(data, rows * d * e)

    def attention(prefix):
        for w, n in (("wq", q), ("wk", kv), ("wv", kv)):
            product(f"{prefix}/{w}", n // model)
        if seq:
            ag(data, data * rows * H // model * (hd + 2) * 4)
        elif two_d and split:
            ag(data, rows * q // model * e)                  # attn output
        row_parallel(f"{prefix}/wo")

    if two_d:
        if vocab:
            ar(model, rows * d // data * e)
        ag(data, rows * d * e)
    else:
        ag(data, data * rows * 4)                            # the ids
        if vocab:
            ar(model, rows * d * e)
        ag(data, data * rows * d * e)
    stack = "dec_layers" if encdec else "layers"
    for _ in range(cfg.num_layers):
        norm()
        attention(f"{stack}/self_attn" if encdec else f"{stack}/attn")
        norm()
        if encdec:
            product(f"{stack}/cross_attn/wq", q // model)
            if two_d and split:
                ag(data, rows * q // model * e)              # the rows' out
            row_parallel(f"{stack}/cross_attn/wo")
            norm()
            product(f"{stack}/mlp/w_in", ff // model)
            row_parallel(f"{stack}/mlp/w_out", bias=True)
        else:
            for w in ("w_gate", "w_up"):
                product(f"{stack}/mlp/{w}", ff // model)
            row_parallel(f"{stack}/mlp/w_down")
    norm()                                                   # final norm
    product("embed/head", v // model if vocab else v)
    if vocab:
        ag(model, rows * v * e)                              # the logits
    out = {}
    for op, n, b in ops:
        acc = out.setdefault(op, {"count": 0, "bytes_moved": 0.0,
                                  "tensor_bytes": 0.0})
        acc["count"] += 1
        acc["bytes_moved"] += b * _ring(op, n)
        acc["tensor_bytes"] += b
    return out


def tp2d_shard_cases(leaves=None, buckets: tuple = TP2D_BUCKETS,
                     shard_m: tuple = TP2D_SHARD_M,
                     fsdp_rows: tuple = TP2D_FSDP_ROWS,
                     fsdp_m: tuple = TP2D_FSDP_M, phase: str = "tp2d",
                     unpacked=None, path=None) -> list:
    """The kernels of the tp2d path (``phase``; default qwen's) at the
    per-rank shapes its ranks give them.  Each leaf of ``leaves`` (default
    ``TP2D_LEAVES``; an entry's optional sixth field False where the
    rules leave the leaf's other dim off ``model``, its third None where
    they put no dim on ``data``) is packed as a rank
    packs it in each mode
    (``prepack_for`` with the engine's problems, the plans
    ``install_arch(mesh=, opts=)`` wrote: 2D over ``buckets``, FSDP over
    the data line's compute rows ``fsdp_rows``), each pack bit-equal to
    ``pack_ref``; then ``tsmm_dot`` on layer 0's piece: 2D, the rank's
    (K/2, N/2) piece at ``shard_m`` rows with no epilogue (a k-split
    product's bias and activation run after the data group's sum); FSDP
    (``fsdp_m`` rows, None: a leaf served under 2D alone), the two data
    ranks' pieces gathered as the all-gather concatenates them, with the
    leaf's epilogue; each against the same call on the ladder's plain
    rung (the planned rung refused by a failpoint, no kernel launched).
    ``unpacked``: {leaf: (K, N, rows)} of 2D row pieces the engine keeps
    unpacked (DeepSeek-V2's ``wkv_a``), each held at the rows whose
    product runs a planned kernel (its per-call pack and the skinny
    kernel).  ``path``: the phase's path (a ``TP2D_MOE`` one), named in
    each case's mode and line.  Each case keeps the shapes its kernel call
    launched (``launch_shapes``), which the ranks' launches are held to."""
    import logging

    import torch
    from repro_torch.core import registry
    from repro_torch.core.evaluator import Timer
    from repro_torch.core.packing import pack
    from repro_torch.core.tsmm import prepack_for, tsmm_dot
    from repro_torch.kernels import cuda, ref
    from repro_torch.resilience import degrade, failpoints
    from repro_torch.serve.engine import PAD_COLS

    timer = Timer()
    g = torch.Generator(device="cuda").manual_seed(29)
    bf = torch.bfloat16
    misses = registry.stats()["misses"]
    out = []
    tag = f"{phase}.{path}" if path else phase

    def held(leaf, mode, x, pk, w, bias, act):
        def kern():
            return tsmm_dot(x, pk, bias=bias, act=act)

        def plain():
            failpoints.configure({"kernels.lower.skinny": "raise",
                                  "kernels.lower.tall": "raise"})
            logging.disable(logging.WARNING)
            try:
                with degrade.use(degrade.DegradeStats()):
                    return tsmm_dot(x, pk, bias=bias, act=act)
            finally:
                logging.disable(logging.NOTSET)
                failpoints.reset()

        m, k = x.shape
        n = getattr(pk, "orig_cols", pk.shape[-1])
        before = dict(cuda.launches)
        with Designs() as d, launch_shapes() as shapes:
            got = kern()
        ran = {kk: c - before.get(kk, 0) for kk, c in cuda.launches.items()
               if c != before.get(kk, 0)}
        before = dict(cuda.launches)
        want = plain()
        torch.cuda.synchronize()
        # a packed piece launches its one kernel; an unpacked one its
        # per-call pack too
        kinds = set(ran) - ({"pack_blocks"} if not hasattr(pk, "blocks")
                            else set())
        if dict(cuda.launches) != before or len(kinds) != 1:
            raise AssertionError(f"{tag} {mode} {leaf} m={m}: the kernel "
                                 f"call launched {ran}, or the plain rung "
                                 f"launched one")
        name = next(iter(kinds))
        # the kernel's design (an unpacked piece's per-call pack aside)
        design = design_of({k_: v for k_, v in d.ran.items()
                            if not k_.startswith("pack_")})
        if design not in ("wgmma", "stream"):
            raise AssertionError(f"{tag} {mode} {leaf} m={m}: {name} ran "
                                 f"{d.ran}")
        ok, err = within(got, want, **BF16_TOL)
        if not ok:
            raise AssertionError(f"{name} {tag} {mode} {leaf} m={m} K={k} "
                                 f"N={n}: max |err| {err} outside {BF16_TOL}")
        moved = (2 * (m * k + k * n + (n if bias is not None else 0))
                 + got.numel() * got.element_size())
        bound_ms, bound_by = bound(moved, 2 * m * k * n)
        del got, want
        return {"kernel": name, "mode": f"{tag}.{mode}", "tp_leaf": leaf,
                "design": design, "m": m, "K": k, "N": n,
                "launched": sorted(shapes),
                **({"bk": pk.blocks.shape[-2], "bn": pk.blocks.shape[-1]}
                   if hasattr(pk, "blocks") else {"unpacked": True}),
                "bias": bias is not None, "act": act, "max_abs_err": err,
                "tol": BF16_TOL, "ms": timer(kern, iters=3),
                "device_ms": timer(kern, iters=3, device=True),
                "plain_ms": timer(plain, iters=3),
                "library_ms": timer(lambda: torch.matmul(x, w), iters=3),
                "bound_ms": bound_ms, "bound_by": bound_by}

    def packed(leaf, mode, w, pk):
        bk, bn = pk.blocks.shape[-2:]
        if not torch.equal(pk.blocks, ref.pack_ref(w, bk, bn)):
            raise AssertionError(f"pack_blocks {tag} {mode} {leaf} "
                                 f"{tuple(w.shape)} by ({bk}, {bn}): not "
                                 f"bit-equal to pack_ref")
        bound_ms, bound_by = bound(w.numel() * 2 + pk.blocks.numel() * 2, 0)
        return {"kernel": "pack_blocks", "mode": f"{tag}.{mode}_{leaf}",
                "tp_leaf": leaf, "design": "", "M": w.shape[-2],
                "K": w.shape[-1], "bm": bk, "bk": bn,
                "padded_cols": pk.blocks.shape[-3] * bn, "max_abs_err": 0.0,
                "tol": "bit-equal",
                "ms": timer(lambda: pack(w, bk, bn), iters=3),
                "device_ms": timer(lambda: pack(w, bk, bn), iters=3,
                                   device=True),
                "plain_ms": timer(lambda: ref.pack_ref(w, bk, bn), iters=3),
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by}

    for leaf, (rows, cols, on_data, has_bias, act, *on_model) in (
            leaves or TP2D_LEAVES).items():
        pad = leaf in PAD_COLS         # the head and an SSM w_in piece
        # the rank's 2D piece: (rows/2, cols/2), or (rows/2, cols) where
        # the leaf's columns are not on ``model`` (DeepSeek-V2's wq_a), or
        # (rows, cols/2) where no dim is on ``data`` (its wq_b, wkv_b)
        tp = 2 if not on_model or on_model[0] else 1
        kd = 2 if on_data else 1
        w = (torch.randn((rows // kd, cols // tp), generator=g, device="cuda")
             / rows ** 0.5).to(bf)
        with Designs() as d:
            pk = prepack_for(buckets, w, pad=pad, num_shards=kd * tp)
        if pk is None:
            raise AssertionError(f"{tag} {leaf}: the 2D piece stays "
                                 f"unpacked")
        out.append({**packed(leaf, "2d", w, pk), "design": design_of(d.ran)})
        for m in shard_m:
            x = torch.randn((m, rows // kd), generator=g, device="cuda").to(bf)
            # a k-split leaf's product runs without its epilogue
            ep = on_data != "rows"
            out.append(held(leaf, "2d", x, pk, w,
                            None, act if ep else None))
            del x
        del w, pk
        if fsdp_m is None or on_data is None:
            torch.cuda.empty_cache()
            continue
        # FSDP: the gathered (rows, cols/2) or (rows/2, cols), cut in two
        # along the data axis's dim, each half packed as its rank packs it
        shape = (rows, cols // tp) if on_data == "rows" else (rows // tp, cols)
        dim = 0 if on_data == "rows" else 1
        full = (torch.randn(shape, generator=g, device="cuda")
                / shape[0] ** 0.5).to(bf)
        halves = [t.contiguous() for t in full.chunk(2, dim=dim)]
        with Designs() as d:
            pks = [prepack_for(fsdp_rows, t, pad=pad, num_shards=tp,
                               plan_shape=shape) for t in halves]
        out.append({**packed(leaf, "fsdp", halves[0], pks[0]),
                    "design": design_of(d.ran)})
        blocks = torch.cat([p.blocks for p in pks], dim=-4 if dim == 0 else -3)
        gathered = dataclasses.replace(pks[0], blocks=blocks,
                                       orig_rows=shape[0],
                                       orig_cols=(pks[0].orig_cols if dim == 0
                                                  else shape[1]))
        bias = ((0.1 * torch.randn((shape[1],), generator=g, device="cuda"))
                .to(bf) if has_bias else None)
        for m in fsdp_m:
            x = torch.randn((m, shape[0]), generator=g, device="cuda").to(bf)
            out.append(held(leaf, "fsdp", x, gathered, full, bias, act))
            del x
        del full, halves, pks, gathered, blocks
        torch.cuda.empty_cache()
    for leaf, (k, n, ms) in (unpacked or {}).items():
        # the rank's 2D row piece, unpacked: its K slice's product
        w = (torch.randn((k // 2, n), generator=g, device="cuda")
             / k ** 0.5).to(bf)
        for m in ms:
            x = torch.randn((m, k // 2), generator=g, device="cuda").to(bf)
            out.append(held(leaf, "2d", x, w, w, None, None))
            del x
        del w
    misses = registry.stats()["misses"] - misses
    for c in out:
        emit({"phase": f"{phase}.kernels", **({"path": path} if path else {}),
              **c})
    if misses:
        raise AssertionError(f"{tag}.kernels: {misses} registry misses "
                             f"after install_arch(mesh=, opts=)")
    return out


def tp2d_planted(eng, cfg, device) -> dict:
    """The control of the logits bound: each group's prefill and first
    decode step with layer 0's ``w_gate`` partial products left unsummed
    over the data group (every rank skips the same sum, so the ranks stay
    in step).  A forward runs 5 k-split sums a layer and the head's."""
    from repro_torch.core import tsmm
    sound = tsmm._data_sum
    calls = [0]
    per_forward = 5 * cfg.num_layers + 1

    def skip_layer0_gate(part, group):
        i = calls[0]
        calls[0] += 1
        return part if i % per_forward == 3 else sound(part, group)

    tsmm._data_sum = skip_layer0_gate
    try:
        out = {b: (eng.generate(tp2d_tokens(cfg, b, device), 0),
                   eng.generate(tp2d_tokens(cfg, b, device), 1))
               for b in TP2D_BUCKETS}
    finally:
        tsmm._data_sum = sound
    if calls[0] != 3 * per_forward * len(TP2D_BUCKETS):
        raise AssertionError(f"tp2d: the planted site ran {calls[0]} times")
    return out


def tp2d_serve(mesh, mode: str, model, cfg, params, axes) -> tuple:
    """One mode's engine on ``mesh``: load, the groups and the queue (the
    main path, counted, its launches' shapes recorded), each group's first
    decode step, and (2D) the planted fault.  Returns (the rank's results,
    the first steps, the planted steps)."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.models.param import torch_dtype
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import ShardingOptions

    dev = mesh.device
    opts = ShardingOptions(**TP2D_MODES[mode])
    res = {}
    registry.reset_stats()
    cuda.reset_launches()
    _free(dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(model, params, axes, max_len=TP2D_MAX_LEN,
                 buckets=TP2D_BUCKETS, max_prompt=TP2D_PROMPT,
                 device=dev.type, mesh=mesh, opts=opts)
    _sync(dev)
    p = eng.params
    res["load"] = {"seconds": time.perf_counter() - t0,
                   "launches": dict(cuda.launches),
                   "designs": dict(cuda.design_launches),
                   "packed": {k: list(v) for k, v in eng.pack_report.items()}}
    res["pieces"] = {"wq": list(p["layers"]["attn"]["wq"].shape),
                     "tok": list(p["embed"]["tok"].shape),
                     "ln1": list(p["layers"]["ln1"].shape)}
    res["graphed"] = eng.programs.stats()["graphed"]
    res["layouts"] = {b: repr(eng.cache_layout(b)) for b in TP2D_BUCKETS}
    # the main path: counts zeroed just before, read just after
    cuda.reset_launches()
    comm.reset()
    itemsize = torch_dtype(cfg.dtype).itemsize
    groups = {}
    with launch_shapes() as shapes:
        for b in TP2D_BUCKETS:
            r = eng.generate(tp2d_tokens(cfg, b, dev), TP2D_STEPS)
            groups[b] = {"prefill_s": r.prefill_s,
                         "per_token_s": r.per_token_s,
                         "buckets": list(r.buckets),
                         "tokens0": r.tokens[0].tolist(),
                         "collectives": eng.collectives("decode", b),
                         "contract": tp2d_contract(
                             cfg, mode, b, eng.pack_report, 2, 2, itemsize)}
        t0 = time.perf_counter()
        results, stats = eng.serve_queue(tp2d_queue(cfg))
        _sync(dev)
    res["queue"] = {"seconds": time.perf_counter() - t0,
                    "admitted": stats.admitted, "steps": stats.steps,
                    "generated": stats.generated_tokens,
                    "tokens": [q.tokens.tolist() for q in results]}
    res["shapes"] = sorted(shapes)
    res["launches"] = dict(cuda.launches)
    res["designs"] = dict(cuda.design_launches)
    res["comm"] = collective_bytes(comm.records)
    res["staged"] = sorted(set(staged_ops(comm.records)))
    res["groups"] = groups
    res["misses"] = registry.stats()["misses"]
    hr = eng.health_report()
    res["healthy"] = hr["healthy"] and not hr["failpoints"]
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    firsts = {b: (eng.generate(tp2d_tokens(cfg, b, dev), 0),
                  eng.generate(tp2d_tokens(cfg, b, dev), 1))
              for b in TP2D_BUCKETS}
    planted = tp2d_planted(eng, cfg, dev) if mode == "tp2d" else None
    del eng, p
    return res, firsts, planted


def tp2d_worker(out_dir: str, device: str = "cuda") -> None:
    """One rank of the tp2d phase (``torch.distributed.run``): four ranks
    on the one card as ``data=2,model=2``, over gloo.  Rank 0 then holds
    each mode's first decode steps against a one-rank engine on the same
    weights.  Then the MoE family's paths (``TP2D_MOE``), the SSM
    family's and the hybrid's (``TP2D_SSM``), and the VLM's and the
    encoder-decoder's (``TP2D_FAMILIES``), rank 0 keeping each path's
    sides for the phase's process to compare (``tp2d_paths_worker``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    try:
        cfg = tp2d_cfg()
        model = build_model(cfg)
        params, axes = tp2d_params(model, mesh.device)
        firsts, planted = {}, None
        for mode in TP2D_MODES:
            res[mode], firsts[mode], p = tp2d_serve(mesh, mode, model, cfg,
                                                   params, axes)
            planted = planted or p
        cmp = {}
        if mesh.rank == 0:
            one = Engine(model, params, axes, max_len=TP2D_MAX_LEN,
                         buckets=TP2D_BUCKETS, max_prompt=TP2D_PROMPT,
                         device=mesh.device.type)
            one.programs = ProgramStore(model, device=mesh.device,
                                        capture=False)
            for b in TP2D_BUCKETS:
                pre = one.generate(tp2d_tokens(cfg, b, mesh.device), 0)
                want = one.generate(tp2d_tokens(cfg, b, mesh.device), 1)
                timed = one.generate(tp2d_tokens(cfg, b, mesh.device),
                                     TP2D_STEPS)
                row = {"rows": b, "ref_absmax": float(
                           want.logits_last.float().abs().max()),
                       "planted": tp2d_logits_vs(pre, want, *planted[b],
                                                 every_row=True),
                       "one_rank_per_token_s": timed.per_token_s,
                       "one_rank_prefill_s": timed.prefill_s,
                       "steps": TP2D_STEPS}
                for mode in TP2D_MODES:
                    agree = sum(x == y for x, y in zip(
                        res[mode]["groups"][b]["tokens0"],
                        timed.tokens[0].tolist()))
                    row[mode] = {**tp2d_logits_vs(pre, want,
                                                  *firsts[mode][b]),
                                 "row0_tokens_agree": agree}
                cmp[b] = row
            del one
        res["compare"] = cmp
        del params
        _free(mesh.device.type)
        for key, paths, serve in (("moe", TP2D_MOE, tp2d_moe_serve),
                                  ("ssm", TP2D_SSM, tp2d_ssm_serve),
                                  ("family", TP2D_FAMILIES,
                                   tp2d_family_serve)):
            res[key] = {}
            tp2d_paths_worker(mesh, res[key], paths, serve, key, out_dir)
    finally:
        with open(os.path.join(out_dir, f"tp2d_rank{mesh.rank}.json"),
                  "w") as f:
            json.dump(res, f, default=str)
        mesh.close()


def tp2d_logits_vs(pre, want, got_pre, got, *, every_row=False) -> dict:
    """A group's prefill logits (every row) and first decode step's
    logits (the rows whose decode input agrees; ``every_row``: all of
    them, for the planted control) against the one-rank engine's
    (``pre``, ``want``), under ``TP2D_LOGITS_TOL``."""
    import torch
    ok_pre, err_pre = within(got_pre.logits_last, pre.logits_last,
                             **TP2D_LOGITS_TOL)
    same = got.tokens[:, 0] == want.tokens[:, 0]
    if every_row:
        same = torch.ones_like(same)
    ok, err = (within(got.logits_last[same], want.logits_last[same],
                      **TP2D_LOGITS_TOL) if bool(same.any())
               else (True, 0.0))
    return {"first_tokens_equal": int(same.sum()),
            "prefill_max_abs_err": err_pre, "max_abs_err": err,
            "within": ok and ok_pre,
            "worst": max(err_pre, err)}


def tp2d_nccl(out_dir: str, name=None) -> dict:
    """The 2D engine at ``data=1,model=1`` under NCCL in this process
    (``name``: None, qwen1.5-4b; or a ``TP2D_MOE``, ``TP2D_SSM`` or
    ``TP2D_FAMILIES`` path),
    whose grid holds
    its prompt's length bucket alone (the serve path of qwen captures
    every length bucket): its grid captured as CUDA graphs
    with the k-split sums, the gathers and the TP sums inside (group size
    1), every cell bit-equal to its eager run, a graphed group equal to
    an eager one."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import init_pieces
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore, check_cells
    from repro_torch.sharding.rules import ShardingOptions

    opts = ShardingOptions(**TP2D_MODES["tp2d"])
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda", rank=0,
                     world_size=1,
                     init_file=os.path.join(out_dir, f"nccl_store_{name}"))
    try:
        if mesh.backend != "nccl":
            raise AssertionError(f"tp2d.nccl: backend {mesh.backend}")
        if name is None:
            cfg = tp2d_cfg()
            model = build_model(cfg)
            params, axes = tp2d_params(model, "cuda")
            buckets, prompt, min_prompt, max_len = (
                TP2D_BUCKETS, TP2D_PROMPT, TP2D_PROMPT, TP2D_MAX_LEN)
            tokens = tp2d_tokens
        elif name in TP2D_FAMILIES:
            spec = TP2D_FAMILIES[name]
            cfg = tp2d_family_cfg(name)
            model = build_model(cfg)
            with init_pieces(mesh, cfg, opts):
                params, axes = model.init(torch.Generator(device="cuda")
                                          .manual_seed(0))
            params = tp2d_family_seeded(cfg)(params, axes, mesh, opts)
            buckets, prompt = spec["modes"]["tp2d"]["buckets"], spec["prompt"]
            min_prompt = prompt
            max_len = tp2d_family_max_len(cfg, spec)

            def tokens(cfg, b, device):
                return tp2d_family_batch(cfg, b, prompt, device)
        else:
            moe = name in TP2D_MOE
            spec = (TP2D_MOE if moe else TP2D_SSM)[name]
            cfg = (tp2d_moe_cfg if moe else tp2d_ssm_cfg)(name)
            model = build_model(cfg)
            with init_pieces(mesh, cfg, opts):
                params, axes = model.init(torch.Generator(device="cuda")
                                          .manual_seed(0))
            buckets, prompt = spec["modes"]["tp2d"]["buckets"], spec["prompt"]
            min_prompt = prompt
            max_len = (tp2d_moe_max_len if moe else tp2d_ssm_max_len)(spec)

            def tokens(cfg, b, device):
                return tp_moe_tokens(cfg, b, prompt, device)
        eng = Engine(model, params, axes, max_len=max_len, buckets=buckets,
                     max_prompt=prompt, min_prompt=min_prompt, device="cuda",
                     mesh=mesh, opts=opts)
        del params
        t0 = time.perf_counter()
        eng.precompile()
        capture_s = time.perf_counter() - t0
        checks = check_cells(eng.programs)
        bucket = max(buckets)
        group = tokens(cfg, bucket, "cuda")
        graphed = eng.generate(group, 4)
        store = eng.programs
        st = store.stats()
        eng.programs = ProgramStore(model, device="cuda", mesh=mesh,
                                    opts=eng.opts, capture=False,
                                    cache_init=eng._local_cache,
                                    layout_of=eng.cache_layout)
        eager = eng.generate(group, 4)
        dec = [p for p in store.programs()
               if p.kind == "decode" and p.bucket == bucket]
        contract = (tp2d_contract if name is None or name in TP2D_FAMILIES
                    else tp2d_moe_contract if name in TP2D_MOE
                    else tp2d_ssm_contract)(
            cfg, "tp2d", bucket, eng.pack_report, 1, 1, 2)
        out = {"backend": mesh.backend, "graphed": st["graphed"],
               "cells": st["programs"], "captured": st["captured"],
               "capture_s": capture_s,
               "cells_bit_equal": sum(c["equal"] for c in checks),
               "cells_checked": len(checks),
               "group_tokens_equal": bool(torch.equal(graphed.tokens,
                                                      eager.tokens)),
               "group_logits_equal": bool(torch.equal(graphed.logits_last,
                                                      eager.logits_last)),
               "decode_collectives": store.collectives(dec[0])
               if dec else None,
               "contract": contract}
        del eng, store
        return out
    finally:
        mesh.close()


def tp2d_checks(ranks: list) -> list:
    """What the four ranks' results break of the tp2d phase's contract."""
    from repro_torch.analysis.collectives import bytes_moved
    bad = []
    cfg = tp2d_cfg()
    for res in ranks:
        rk = res["rank"]
        if res["backend"] != "gloo":
            bad.append(f"rank {rk}: backend {res['backend']}")
        for mode in TP2D_MODES:
            r = res[mode]
            if r["graphed"] is not False:
                bad.append(f"rank {rk} {mode}: graphed {r['graphed']}")
            if r["misses"] or not r["healthy"]:
                bad.append(f"rank {rk} {mode}: {r['misses']} misses, "
                           f"healthy {r['healthy']}")
            want = {"wq": [TP2D_LAYERS, cfg.d_model // 2,
                           cfg.num_heads * cfg.head_dim // 2],
                    "tok": [cfg.vocab_size // 2, cfg.d_model // 2],
                    "ln1": [TP2D_LAYERS, cfg.d_model // 2]}
            if r["pieces"] != want:
                bad.append(f"rank {rk} {mode}: pieces {r['pieces']}, "
                           f"want {want}")
            designs = r["designs"]
            if not any(designs.get(x) for x in ("skinny_wgmma",
                                                "skinny_stream")):
                bad.append(f"rank {rk} {mode}: no skinny launch {designs}")
            if not r["launches"].get("flash_attention"):
                bad.append(f"rank {rk} {mode}: no flash on the path")
            if r["staged"]:
                bad.append(f"rank {rk} {mode}: staged {r['staged']}")
            for b, g in r["groups"].items():
                if g["collectives"] != g["contract"]:
                    bad.append(f"rank {rk} {mode} b={b}: collectives "
                               f"{g['collectives']} != contract "
                               f"{g['contract']}")
            if r["queue"]["admitted"] != len(TP2D_QUEUE):
                bad.append(f"rank {rk} {mode}: queue {r['queue']}")
        for b in res["tp2d"]["groups"]:
            two = bytes_moved(res["tp2d"]["groups"][b]["collectives"])
            fsdp = bytes_moved(res["fsdp"]["groups"][b]["collectives"])
            if not 0 < two < fsdp:
                bad.append(f"rank {rk} b={b}: 2D moves {two} bytes, FSDP "
                           f"{fsdp}")
    for mode in TP2D_MODES:
        if any(r[mode]["queue"]["tokens"] != ranks[0][mode]["queue"]["tokens"]
               for r in ranks):
            bad.append(f"{mode}: the ranks' queue tokens differ")
    cmp = ranks[0]["compare"]
    if not cmp:
        bad.append("rank 0 compared nothing with the one-rank engine")
    atol = TP2D_LOGITS_TOL["atol"]
    for b, c in cmp.items():
        for mode in TP2D_MODES:
            m = c[mode]
            if not m["within"] or not m["first_tokens_equal"]:
                bad.append(f"b={b} {mode}: rank 0 vs the one-rank engine "
                           f"{m}")
        if c["planted"]["worst"] < TP2D_PLANTED * atol:
            bad.append(f"b={b}: the planted fault is not {TP2D_PLANTED}x "
                       f"outside the bound: {c['planted']}")
    return bad


# ---------------------------------------------------------------------------
# tp2d.moe: the MoE family under 2D tensor parallelism and FSDP, in the
# tp2d phase's ranks
# ---------------------------------------------------------------------------

# Each at its published widths cut to 2 layers, bf16, seeded, each rank
# drawing every leaf whole on the card and keeping its piece under the
# mode's rules as it is drawn (``init_pieces(mesh, cfg, opts)``; the
# experts' embed dim, the router's rows and the shared experts' on
# ``data``): OLMoE-1B-7B (64 experts, 32 a rank; 16 heads, 8 a rank, flash
# at D 128) under 2D at buckets 1 and 4 with a 3-request ragged queue, and
# under FSDP at bucket 4 for 2 decode steps (each rank gathers ~0.8 GB of
# expert stacks a decode call, through the host over gloo); DeepSeek-V2
# (its dense first layer and one MoE layer of 160 experts, 80 a rank, 2
# shared; 128 MLA heads, 64 a rank; the latent cache's rows on ``data`` at
# bucket 2 and its slots on ``model``; no flash) under 2D at buckets 1 and
# 2.  DeepSeek-V2 under FSDP would run the tp phase's per-shard kernel shapes
# after ~3.8 GB of gathers a decode call a rank through the host: it is
# held against the reference on the CPU (tests/test_torch_tp2d_moe.py).
# ``faults``: the planted controls of each mode (``tp2d_moe_planted``).
TP2D_MOE = {
    "olmoe": dict(arch="olmoe_1b_7b", prompt=256, flash=True, modes={
        "tp2d": dict(buckets=(1, 4), steps=4,
                     queue=((200, 4), (256, 3), (64, 5)),
                     faults=("experts_sum", "router_sum")),
        "fsdp": dict(buckets=(4,), steps=2, queue=(),
                     faults=("fsdp_reverse",))}),
    "deepseek": dict(arch="deepseek_v2_236b", prompt=512, flash=False,
                     modes={
        "tp2d": dict(buckets=(1, 2), steps=4, queue=(),
                     faults=("experts_sum", "router_sum", "mla_rows"))}),
}
TP2D_MOE_LAYERS = 2
# the per-rank pieces of each path, (rows, cols, the dim FSDP puts on
# ``data``, bias, epilogue) as ``TP2D_LEAVES``: OLMoE's attention pieces
# (wk and wv are wq's shape) and head under both modes; DeepSeek-V2's
# wq_a, wo, the dense layer's MLP (w_up is w_gate's shape), the head, and
# wq_b and wkv_b (no dim on ``data``: the tp phase's per-shard pieces, at
# the rows 2D computes) under 2D
TP2D_MOE_LEAVES = {
    "olmoe": {"wq": (2048, 2048, "rows", False, None),
              "wo": (2048, 2048, "cols", False, None),
              "head": (2048, 50304, "rows", False, None)},
    "deepseek": {"wq_a": (5120, 1536, "rows", False, None, False),
                 "wq_b": (1536, 24576, None, False, None),
                 "wkv_b": (512, 32768, None, False, None),
                 "wo": (16384, 5120, "cols", False, None),
                 "w_gate": (5120, 12288, "rows", False, "silu"),
                 "w_down": (12288, 5120, "cols", False, None),
                 "head": (5120, 102400, "rows", False, None)},
}
# 2D row pieces kept unpacked, (K, N, the rows whose product runs a planned
# kernel: decode; a prefill's K slice runs torch.matmul, not TSMM-shaped)
TP2D_MOE_UNPACKED = {"deepseek": {"wkv_a": (5120, 576, (1, 2))}}
# where a control acts, where not every bucket of its mode: the latent
# cache's rows lie on ``data`` at bucket 2 only
TP2D_MOE_FAULT_BUCKETS = {"mla_rows": (2,)}


def tp2d_moe_cfg(name: str):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(TP2D_MOE[name]["arch"]),
                               num_layers=TP2D_MOE_LAYERS)


def tp2d_moe_max_len(spec: dict) -> int:
    """One length for every mode of a path: the largest of
    ``tp_moe_max_len`` over them (the ragged rule where a queue runs)."""
    return max(tp_moe_max_len({"prompt": spec["prompt"], **m})
               for m in spec["modes"].values())


def tp2d_moe_contract(cfg, mode: str, bucket: int, packed: dict, data: int,
                      model: int, e: int = 2) -> dict:
    """One decode call's collectives on a rank, from the shapes and the
    rank's packed block shapes (``packed``: the engine's pack report),
    bf16 activations (``e`` bytes), the router's logits and the MoE
    partials in fp32, as ``tp2d_contract`` does for the dense family.

    Both modes: each norm's ``embed`` scale gathered over ``data`` (at
    ``data=1`` it is whole, and nothing); the
    lookup summed over ``model`` and its columns gathered over ``data``;
    ``wo`` summed over ``model``; GQA over a cache whose slots lie on
    ``data`` gathers its partials over it, MLA (slots on ``model``) every
    head's query and the partials over ``model``; the MoE layer's router
    logits gathered over ``model`` and its partials summed over it once;
    the logits gathered over ``model``.

    2D: every rank computes the bucket; each k-split product (the packed
    pieces with rows on ``data``, MLA's unpacked ``wkv_a``, the router's
    fp32 logits, the routed and shared experts' ``w_gate`` / ``w_up`` in
    one sum) summed over ``data``; ``wo``'s, ``w_down``'s and the MoE
    layer's output columns gathered over ``data``; with the cache's rows
    on ``data`` the attention output gathered over it.

    FSDP: a data line computes its rows of a bucket it splits; the ids
    gathered over ``data`` before the lookup; every packed piece,
    ``wkv_a``, the router and the expert stacks gathered over ``data``
    before use."""
    from repro_torch.models.moe import _capacity
    d, v, H = cfg.d_model, cfg.vocab_size, cfg.num_heads
    two_d = mode == "tp2d"
    split = data > 1 and bucket % data == 0
    rows = bucket if two_d or not split else bucket // data
    cols = data if two_d else 1                # the output's column pieces
    ops = []                                   # (op, group size, bytes)

    def ar(n, b):
        ops.append(("all-reduce", n, b))

    def ag(n, b):
        ops.append(("all-gather", n, b))

    def norm(b):
        if data > 1:
            ag(data, b)

    def packed_product(leaf, n_out, cols_on_data=False):
        """A packed piece's product (``n_out`` the piece's columns): 2D a
        k-split's sum over data (rows on data), FSDP its gather."""
        if not two_d:
            n = 1
            for s in packed[leaf][-4:]:
                n *= s
            ag(data, n * data * e)
        elif not cols_on_data:
            ar(data, rows * n_out * e)

    def row_parallel(leaf):
        """wo or a dense w_down: columns on data, rows on model."""
        packed_product(leaf, d // data, cols_on_data=True)
        ar(model, rows * d // cols * e)
        if two_d:
            ag(data, rows * d * e)

    if two_d:
        ar(model, rows * d // data * e)
        ag(data, rows * d * e)
    else:
        ag(data, data * rows * 4)                            # the ids
        ar(model, rows * d * e)
        ag(data, data * rows * d * e)
    for i in range(cfg.num_layers):
        pre = f"dense{i}" if i < cfg.first_k_dense else "layers"
        norm(d * e)                                          # ln1
        if cfg.use_mla:
            kvr, dr, dv = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
            packed_product(f"{pre}/attn/wq_a", cfg.q_lora_rank)
            if two_d and data > 1:
                ar(data, rows * (kvr + dr) * e)              # wkv_a summed
            elif data > 1:
                ag(data, d * (kvr + dr) * e)                 # wkv_a gathered
            local = rows // data if two_d and split else rows
            if model > 1:
                ag(model, local * H * (kvr + dr) * 4)        # every head's q
                ag(model, model * local * H * (2 + kvr) * 4)  # the partials
            if two_d and split:
                ag(data, rows * H // model * dv * e)         # heads' output
        else:
            q = H * cfg.head_dim // model
            for w in ("wq", "wk", "wv"):
                packed_product(f"{pre}/attn/{w}", q)
            if data > 1 and not split:
                ag(data, data * rows * H // model * (cfg.head_dim + 2) * 4)
            elif two_d and split:
                ag(data, rows * q * e)                       # attn output
        row_parallel(f"{pre}/attn/wo")
        norm(d * e)                                          # ln2
        if i < cfg.first_k_dense:
            for w in ("w_gate", "w_up"):
                packed_product(f"{pre}/mlp/{w}", cfg.d_ff // model)
            row_parallel(f"{pre}/mlp/w_down")
            continue
        E, ff = cfg.num_experts, cfg.d_ff_expert
        sff = ff * cfg.num_shared_experts
        whole = two_d or not split              # the rank dispatches groups
        g = (data if whole and data > 1 and rows % data == 0
             and rows >= data else 1)
        cap = _capacity(rows // g, E, cfg.experts_per_token,
                        cfg.capacity_factor)
        if two_d:
            ar(data, rows * E // model * 4)                  # router
            ar(data, (2 * E // model * g * cap * ff          # experts
                      + 2 * rows * sff // model) * e)        # and shared
        else:
            ag(data, d * E // model * 4)                     # the router
            for _ in ("w_gate", "w_up", "w_down"):
                ag(data, E // model * d * ff * e)            # the stacks
                if sff:
                    ag(data, d * sff // model * e)           # the shared
        ag(model, rows * E * 4)                              # router cols
        ar(model, rows * d // cols * 4)                      # moe_sum
        if two_d:
            ag(data, rows * d * e)
    norm(d * e)                                              # final norm
    packed_product("embed/head", v // model)
    ag(model, rows * v * e)                                  # the logits
    out = {}
    for op, n, b in ops:
        acc = out.setdefault(op, {"count": 0, "bytes_moved": 0.0,
                                  "tensor_bytes": 0.0})
        acc["count"] += 1
        acc["bytes_moved"] += b * _ring(op, n)
        acc["tensor_bytes"] += b
    return out


def piece_gather_bytes(params, data: int) -> set:
    """The tensor bytes of a weight piece of ``params`` (two dims or more
    a layer: packed blocks or unpacked; a layer stack's leaf, the LM's
    ``layers`` or the hybrid's ``mamba_layers``, read a layer at a time)
    gathered over a data group of ``data``: what an all-gather of that
    piece records.  The encoder-decoder's ``enc_layers`` / ``dec_layers``
    are stacks too."""
    out = set()

    def walk(t, stacked):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, stacked or k in ("layers", "mamba_layers",
                                         "enc_layers", "dec_layers"))
            return
        t = getattr(t, "blocks", t)
        if t.ndim - stacked >= 2:
            n = t.numel() // (t.shape[0] if stacked else 1)
            out.add(data * n * t.element_size())

    walk(params, False)
    return out


def tp2d_moe_side(eng, cfg, batch, b: int, *, group=None,
                  replay=None) -> dict:
    """``tp_moe_side`` on ``batch``'s rows in the cell context of bucket
    ``b``: every position's prefill logits and that forward's expert
    choices, then the first decode step.  ``group``: (the whole group,
    its first row) where ``batch`` is a data line's rows of a bucket the
    data axis splits (FSDP): ``generate`` serves the whole group, and its
    first step is read at the line's rows.  ``replay``: a side whose
    choices this engine takes in place of its own (``moe_routes``)."""
    k = cfg.experts_per_token
    with moe_routes(k, replay and replay["routes"]) as rec:
        logits = _prefill_logits(eng, cfg, batch, b)
    with moe_routes(k, replay and replay["gen_routes"]) as gen:
        first = eng.generate(batch if group is None else group[0], 1)
    r0 = 0 if group is None else group[1]
    n = batch["tokens"].shape[0]
    n_moe = cfg.num_layers - cfg.first_k_dense
    return {"logits": logits, "routes": rec, "gen_routes": gen,
            "dec_routes": gen[n_moe:2 * n_moe],
            "first_tokens": first.tokens[r0:r0 + n, 0].cpu(),
            "first_logits": first.logits_last[r0:r0 + n].cpu()}


def tp2d_moe_rows(eng, cfg, b: int, prompt: int,
                  batch_of=None) -> tuple:
    """(the rows a rank's side reads, the ``group`` argument of
    ``tp2d_moe_side``) of bucket ``b``'s group on ``eng`` (``batch_of(cfg,
    b, prompt, device)``, default ``tp_moe_tokens``): the data line's rows
    under FSDP where the bucket splits, else the group."""
    batch = (batch_of or tp_moe_tokens)(cfg, b, prompt, eng.device)
    n, r0, data = eng.rows_of(b)
    if data is None:
        return batch, None
    return {k: v[r0:r0 + n] for k, v in batch.items()}, (batch, r0)


def tp2d_moe_planted(eng, cfg, spec: dict, mode: str) -> dict:
    """The controls of the logits and routing bounds of one mode
    (``faults``), each planted alone on every rank alike, so the ranks
    stay in step: {fault: {bucket: its side}} at each bucket where it acts
    (``TP2D_MOE_FAULT_BUCKETS``, else every bucket of the mode).  Raises
    unless each fault's site ran as often as a side reaches it.

    * ``experts_sum``: the routed and shared experts' ``w_gate`` / ``w_up``
      partials left unsummed over ``data`` (2D);
    * ``router_sum``: the router's partial logits left unsummed over
      ``data`` (2D); it must also break the routing bound;
    * ``fsdp_reverse``: each expert stack's data halves gathered in the
      reverse order (FSDP);
    * ``mla_rows``: MLA's decode reading the latent cache's data-split rows
      as if whole (every rank's piece taken for the bucket's first rows;
      2D, where the rows lie on ``data``)."""
    import torch
    from repro_torch.models import attention, moe
    n_moe = cfg.num_layers - cfg.first_k_dense
    calls = [0]

    def skipped(sound):
        def skip(part):
            calls[0] += 1
            return part
        return skip

    def reversed_halves(sound):
        def gather(w, full, dim):
            out = sound(w, full, dim)
            if dim in (1, 2) and out is not w:
                calls[0] += 1
                halves = out.chunk(2, dim=dim)
                out = torch.cat(halves[::-1], dim=dim)
            return out
        return gather

    def whole_rows(sound):
        def first(lay, rows):
            calls[0] += 1
            return 0
        return first

    # (module, attribute, the fault, its calls a side: the prefill
    # forward, generate's prefill and its one decode step)
    sites = {"experts_sum": (moe, "experts_sum", skipped, 3 * n_moe),
             "router_sum": (moe, "router_sum", skipped, 3 * n_moe),
             "fsdp_reverse": (moe, "dp_weight", reversed_halves, 9 * n_moe),
             "mla_rows": (attention, "row_start", whole_rows,
                          cfg.num_layers)}
    m = spec["modes"][mode]
    out = {}
    for fault in m["faults"]:
        mod, attr, plant, per_side = sites[fault]
        buckets = TP2D_MOE_FAULT_BUCKETS.get(fault, m["buckets"])
        sound = getattr(mod, attr)
        calls[0] = 0
        setattr(mod, attr, plant(sound))
        try:
            out[fault] = {}
            for b in buckets:
                batch, group = tp2d_moe_rows(eng, cfg, b, spec["prompt"])
                out[fault][b] = tp2d_moe_side(eng, cfg, batch, b,
                                              group=group)
        finally:
            setattr(mod, attr, sound)
        if calls[0] != per_side * len(buckets):
            raise AssertionError(f"tp2d.moe {mode}: the planted {fault} ran "
                                 f"{calls[0]} times, not "
                                 f"{per_side * len(buckets)}")
    return out


def tp2d_load(mesh, cfg, mode: str, m: dict, prompt: int, max_len: int,
              res: dict, seeded=None):
    """A ``TP2D_MOE``, ``TP2D_SSM`` or ``TP2D_FAMILIES`` path's engine in
    one mode on ``mesh``, loaded from the rank's pieces of the seeded
    weights (each leaf drawn whole and cut as it is drawn; ``seeded(params,
    axes, mesh, opts)`` then redraws some of them, ``tp2d_family_seeded``),
    with the registry's and the launches' counts and the peak memory reset
    before; ``res["load"]`` its seconds, launches, designs and pack report.
    Returns the engine."""
    import torch
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.models.param import init_pieces
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.rules import ShardingOptions

    model = build_model(cfg)
    dev = mesh.device
    opts = ShardingOptions(**TP2D_MODES[mode])
    registry.reset_stats()
    cuda.reset_launches()
    _free(dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with init_pieces(mesh, cfg, opts):
        params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
    if seeded is not None:
        params = seeded(params, axes, mesh, opts)
    eng = Engine(model, params, axes, mesh=mesh, opts=opts, max_len=max_len,
                 buckets=m["buckets"], max_prompt=prompt, device=dev.type)
    del params
    _sync(dev)
    res["load"] = {"seconds": time.perf_counter() - t0,
                   "launches": dict(cuda.launches),
                   "designs": dict(cuda.design_launches),
                   "packed": {k: list(v) for k, v in eng.pack_report.items()}}
    return eng


def tp2d_main_path(eng, cfg, mode: str, m: dict, prompt: int, contract,
                   res: dict, queue=None, batch_of=None) -> None:
    """A ``TP2D_MOE``, ``TP2D_SSM`` or ``TP2D_FAMILIES`` path's main path
    on its loaded engine, counts zeroed just before and read just after:
    each bucket's group of ``prompt`` seeded tokens (``batch_of(cfg, b,
    prompt, device)``, default ``tp_moe_tokens``: with a VLM's image
    embeddings or an encoder-decoder's frames: ``tp2d_family_batch``) for
    the mode's steps (its decode
    call's collectives beside ``contract``'s, the weight pieces it
    gathered) and the ``queue``'s requests where given.  Fills ``res``
    with the groups, the queue, the launches, their keys
    (``launch_shapes``), designs, collectives, misses, health and peak
    bytes."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.core import registry
    from repro_torch.kernels import cuda
    from repro_torch.models.param import torch_dtype
    from repro_torch.sharding import comm

    mesh, dev = eng.mesh, eng.device
    weights = piece_gather_bytes(eng.params, mesh.shape["data"])
    cuda.reset_launches()
    comm.reset()
    groups = {}
    res["queue"] = None
    with launch_shapes() as shapes:
        for b in m["buckets"]:
            r = eng.generate((batch_of or tp_moe_tokens)(cfg, b, prompt, dev),
                             m["steps"])
            prog = next(p for p in eng.programs.programs()
                        if p.kind == "decode" and p.bucket == b)
            groups[b] = {
                "prefill_s": r.prefill_s, "per_token_s": r.per_token_s,
                "buckets": list(r.buckets), "tokens0": r.tokens[0].tolist(),
                "collectives": eng.collectives("decode", b),
                "contract": contract(
                    cfg, mode, b, eng.pack_report, mesh.shape["data"],
                    mesh.shape["model"], torch_dtype(cfg.dtype).itemsize),
                "weight_gathers": sum(
                    x["op"] == "all-gather" and x["bytes"] in weights
                    for x in prog.comm)}
        if queue:
            t0 = time.perf_counter()
            results, stats = eng.serve_queue(queue)
            _sync(dev)
            res["queue"] = {"seconds": time.perf_counter() - t0,
                            "admitted": stats.admitted, "steps": stats.steps,
                            "generated": stats.generated_tokens,
                            "tokens": [q.tokens.tolist() for q in results]}
        _sync(dev)
    res["shapes"] = sorted(shapes)
    res["launches"] = dict(cuda.launches)
    res["designs"] = dict(cuda.design_launches)
    res["comm"] = collective_bytes(comm.records)
    res["staged"] = sorted(set(staged_ops(comm.records)))
    res["groups"] = groups
    res["misses"] = registry.stats()["misses"]
    hr = eng.health_report()
    res["healthy"] = hr["healthy"] and not hr["failpoints"]
    res["degradations"] = hr["degradations"]["total"]
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)


def tp2d_moe_serve(mesh, name: str, mode: str, res: dict) -> dict:
    """One ``TP2D_MOE`` path in one mode on ``mesh``: load from the rank's
    pieces, the groups (and the queue: the main path, counted), each
    group's comparison side, the planted controls.  Fills ``res``;
    returns {"sides": {bucket: side}, "planted": ...} (rank 0 compares
    them with a one-rank engine after every path has run)."""
    spec = TP2D_MOE[name]
    m = spec["modes"][mode]
    cfg = tp2d_moe_cfg(name)
    dev = mesh.device
    eng = tp2d_load(mesh, cfg, mode, m, spec["prompt"],
                    tp2d_moe_max_len(spec), res)
    lay = eng.params["layers"]
    res["pieces"] = {
        **{k: list(lay["mlp"][k].shape) for k in ("router", "w_gate",
                                                   "w_down")},
        "heads": list(lay["attn"]["wq_b" if cfg.use_mla else "wq"].shape)}
    if cfg.use_mla:
        res["pieces"]["wkv_a"] = list(lay["attn"]["wkv_a"].shape)
    res["layouts"] = {b: repr(eng.cache_layout(b)) for b in m["buckets"]}
    res["graphed"] = eng.programs.stats()["graphed"]
    tp2d_main_path(eng, cfg, mode, m, spec["prompt"], tp2d_moe_contract,
                   res, queue=m["queue"] and tp_moe_queue(cfg, m["queue"]))
    sides = {}
    for b in m["buckets"]:
        batch, group = tp2d_moe_rows(eng, cfg, b, spec["prompt"])
        sides[b] = tp2d_moe_side(eng, cfg, batch, b, group=group)
    planted = tp2d_moe_planted(eng, cfg, spec, mode)
    del eng, lay
    _free(dev.type)
    return {"sides": sides, "planted": planted}


def tp2d_moe_compare(mesh, name: str, kept: dict) -> dict:
    """Rank 0's sides of every mode of one path (``kept``: {mode:
    ``tp2d_moe_serve``'s return}) against a one-rank engine on the same
    seeded weights: routed as it routes, and routed alike
    (``tp_moe_compare``), on the rows rank 0's side reads (the data line's
    under FSDP), dispatched in the mesh's groups (``moe_groups`` patched:
    the reference's ``_dp_groups``, off a mesh 1)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore

    spec = TP2D_MOE[name]
    cfg = tp2d_moe_cfg(name)
    model = build_model(cfg)
    dev = mesh.device
    params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
    buckets = sorted({s["logits"].shape[0] for k in kept.values()
                      for s in k["sides"].values()}
                     | {b for m in spec["modes"].values()
                        for b in m["buckets"]})
    one = Engine(model, params, axes, max_len=tp2d_moe_max_len(spec),
                 buckets=tuple(buckets), max_prompt=spec["prompt"],
                 device=dev.type)
    del params
    one.programs = ProgramStore(model, device=dev, capture=False)
    sound = moe.moe_groups
    out, wants = {}, {}
    try:
        for mode, k in kept.items():
            out[mode] = {}
            for b, got in k["sides"].items():
                n = got["logits"].shape[0]
                batch = {key: v[:n] for key, v in tp_moe_tokens(
                    cfg, b, spec["prompt"], dev).items()}
                # the mesh's dispatch groups: the data axis's where a rank
                # computed the whole bucket, one where its data line's rows
                g = mesh.shape["data"] if n == b else 1
                moe.moe_groups = (lambda t, g=g: g if t % g == 0 and t >= g
                                  else 1)
                if (b, n) not in wants:
                    wants[b, n] = tp2d_moe_side(one, cfg, batch, n)
                forced = tp2d_moe_side(one, cfg, batch, n, replay=got)
                out[mode][b] = {
                    **tp_moe_compare(cfg, got, wants[b, n], forced,
                                     {f: p[b] for f, p in
                                      k["planted"].items() if b in p}),
                    "rows_compared": n, "dispatch_groups": g}
    finally:
        moe.moe_groups = sound
    del one
    _free(dev.type)
    return out


def tp2d_keep(out_dir: str, key: str, name: str, kept: dict) -> None:
    """Rank 0's sides of every mode of one path (``kept``: {mode: its
    serve's return}) written for the phase's process, which compares them
    with a one-rank engine while the ranks serve the next paths
    (``tp2d_compares``): to a temporary file, then renamed."""
    import torch
    path = os.path.join(out_dir, f"kept.{key}.{name}.pt")
    torch.save(kept, path + ".tmp")
    os.replace(path + ".tmp", path)


def tp2d_paths_worker(mesh, res: dict, paths: dict, serve, key: str,
                      out_dir: str) -> None:
    """Every path of ``paths`` (``TP2D_MOE``, ``TP2D_SSM`` or
    ``TP2D_FAMILIES``, under ``key`` of the ranks' results) in every mode
    on this rank (``serve(mesh, name, mode, res)``); rank 0 keeps each
    path's sides for the phase's one-rank comparisons (``tp2d_keep``)."""
    for name, spec in paths.items():
        res[name], kept = {}, {}
        for mode in spec["modes"]:
            res[name][mode] = {}
            t0 = time.perf_counter()
            out = serve(mesh, name, mode, res[name][mode])
            res[name][mode]["seconds"] = time.perf_counter() - t0
            if mesh.rank == 0:
                kept[mode] = out
        if mesh.rank == 0:
            tp2d_keep(out_dir, key, name, kept)
        del kept


# the paths whose rank-0 sides the phase's process compares, in the order
# the ranks serve them: (key of the ranks' results, paths, comparison)
TP2D_COMPARED = (("moe", "TP2D_MOE", "tp2d_moe_compare"),
                 ("ssm", "TP2D_SSM", "tp2d_ssm_compare"),
                 ("family", "TP2D_FAMILIES", "tp2d_family_compare"))


def tp2d_compares(out_dir: str, proc, host, done: dict) -> None:
    """In the tp2d phase's process, while the ranks (``proc``) serve: each
    ``TP2D_COMPARED`` path's rank-0 sides, as ``tp2d_keep`` writes them,
    against a one-rank engine on ``host`` (its ``device`` and the mesh's
    ``shape``); ``done[(key, name)]`` = (the comparison, its seconds), or
    ``done["error"]`` the failure.  Stops when the ranks end without a
    path's sides (their exit code tells why)."""
    import traceback

    import torch
    try:
        for key, paths, fn in TP2D_COMPARED:
            for name in globals()[paths]:
                path = os.path.join(out_dir, f"kept.{key}.{name}.pt")
                while not os.path.exists(path):
                    if proc.poll() is not None and not os.path.exists(path):
                        return
                    time.sleep(0.5)
                kept = torch.load(path, weights_only=False)
                os.remove(path)
                t0 = time.perf_counter()
                out = globals()[fn](host, name, kept)
                done[key, name] = (out, time.perf_counter() - t0)
                del kept
    except BaseException:
        done["error"] = traceback.format_exc()


def tp2d_path_checks(where: str, res: dict, mode: str, flash: bool) -> list:
    """What one rank's results of a ``TP2D_MOE`` or ``TP2D_SSM`` path in
    one mode (``where`` names them) break: misses, health, graphs or
    staged ops on gloo, a skinny, pack, tall or flash launch off its
    Hopper designs or no skinny launch, flash where the path runs none
    (or none where it runs some), no pack at load, a decode call's
    collectives off the contract, a weight piece gathered in a 2D decode
    call or none in an FSDP one."""
    bad = []
    if res["misses"] or not res["healthy"]:
        bad.append(f"{where}: {res['misses']} misses, healthy "
                   f"{res['healthy']}")
    if res["graphed"] is not False or res["staged"]:
        bad.append(f"{where}: graphed {res['graphed']}, staged "
                   f"{res['staged']}")
    designs = res["designs"]
    off = {x for x in designs if x.startswith("skinny_")
           and x not in ("skinny_wgmma", "skinny_stream")}
    off |= {x for x in designs if x.startswith("pack_")
            and x not in ("pack_tma", "pack_vec")}
    off |= {x for x in designs if x.startswith(("tall_", "flash_"))
            and x not in ("tall_wgmma", "flash_wgmma")}
    if off or not any(designs.get(x) for x in ("skinny_wgmma",
                                               "skinny_stream")):
        bad.append(f"{where}: designs {designs}")
    if bool(res["launches"].get("flash_attention")) != flash:
        bad.append(f"{where}: flash launches "
                   f"{res['launches'].get('flash_attention', 0)}")
    if not res["load"]["launches"].get("pack_blocks"):
        bad.append(f"{where}: no pack at load")
    for b, g in res["groups"].items():
        if g["collectives"] != g["contract"]:
            bad.append(f"{where} b={b}: collectives {g['collectives']} != "
                       f"contract {g['contract']}")
        if (g["weight_gathers"] > 0) != (mode == "fsdp"):
            bad.append(f"{where} b={b}: {g['weight_gathers']} weight pieces "
                       f"gathered in a decode call")
    return bad


def tp2d_bytes_checks(name: str, ranks: list, key: str) -> list:
    """Each rank's 2D decode call moving fewer bytes than its FSDP one at
    every bucket both modes of path ``name`` (under ``key`` of the
    ranks' results) serve."""
    from repro_torch.analysis.collectives import bytes_moved
    bad = []
    for rank in ranks:
        two = rank[key][name]["tp2d"]["groups"]
        fsdp = rank[key][name]["fsdp"]["groups"]
        for b in set(two) & set(fsdp):
            a, f = (bytes_moved(two[b]["collectives"]),
                    bytes_moved(fsdp[b]["collectives"]))
            if not 0 < a < f:
                bad.append(f"{name} rank {rank['rank']} b={b}: 2D moves {a} "
                           f"bytes, FSDP {f}")
    return bad


def tp2d_moe_checks(ranks: list) -> list:
    """What the four ranks' results break of the tp2d.moe paths'
    contract."""
    bad = []
    for name, spec in TP2D_MOE.items():
        cfg = tp2d_moe_cfg(name)
        d, e, ff = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
        n_scan = cfg.num_layers - cfg.first_k_dense
        width = (cfg.head_dim + cfg.rope_head_dim if cfg.use_mla
                 else cfg.head_dim)
        for mode, m in spec["modes"].items():
            for rank in ranks:
                rk, res = rank["rank"], rank["moe"][name][mode]
                where = f"{name} {mode} rank {rk}"
                bad += tp2d_path_checks(where, res, mode, spec["flash"])
                pieces = {"router": [n_scan, d // 2, e // 2],
                          "w_gate": [n_scan, e // 2, d // 2, ff],
                          "w_down": [n_scan, e // 2, ff, d // 2],
                          "heads": [n_scan, cfg.q_lora_rank if cfg.use_mla
                                    else d // 2,
                                    cfg.num_heads * width // 2]}
                if cfg.use_mla:
                    pieces["wkv_a"] = [n_scan, d // 2,
                                       cfg.kv_lora_rank + cfg.rope_head_dim]
                if res["pieces"] != pieces:
                    bad.append(f"{where}: pieces {res['pieces']} != {pieces}")
                if m["queue"] and res["queue"]["admitted"] != len(m["queue"]):
                    bad.append(f"{where}: queue {res['queue']}")
            if m["queue"] and any(
                    r["moe"][name][mode]["queue"]["tokens"]
                    != ranks[0]["moe"][name][mode]["queue"]["tokens"]
                    for r in ranks):
                bad.append(f"{name} {mode}: the ranks' queue tokens differ")
            cmp = ranks[0]["moe"][name]["compare"][mode]
            for b, c in cmp.items():
                if not c["within"]:
                    bad.append(f"{name} {mode} b={b}: rank 0 vs the one-rank "
                               f"engine {c}")
                if not c["routing_within"]:
                    bad.append(f"{name} {mode} b={b}: the first MoE layer's "
                               f"routing breaks its bound: flips "
                               f"{c['first_layer_flip_frac']}, gap "
                               f"{c['first_layer_gap_max']}")
            for fault in m["faults"]:
                read = [c["planted"][fault] for c in cmp.values()
                        if fault in c["planted"]]
                least = min((p["bounds_outside"] for p in read), default=0.0)
                if not least > 1.0:
                    bad.append(f"{name} {mode}: the planted {fault} lands "
                               f"{least} bounds outside at its least bucket")
                if fault == "router_sum" and not all(
                        p["first_layer_flip_frac"] > TP_MOE_FLIPS
                        and p["first_layer_gap_max"] > TP_MOE_GAP
                        for p in read):
                    bad.append(f"{name} {mode}: the planted {fault} passes a "
                               f"limit of the routing bound")
        if len(spec["modes"]) > 1:
            bad += tp2d_bytes_checks(name, ranks, "moe")
    return bad


# ---------------------------------------------------------------------------
# tp2d.ssm: the SSM family and the hybrid under 2D tensor parallelism and
# FSDP, in the tp2d phase's ranks
# ---------------------------------------------------------------------------

# Each at its published widths cut in depth, bf16, seeded, each rank
# drawing every leaf whole on the card and keeping its piece under the
# mode's rules (``init_pieces(mesh, cfg, opts)``: ``w_in``'s rows on
# ``data`` and its columns on ``model`` by segments, ``w_out``'s and the
# head's ``embed`` dims on ``data``): Mamba2-780m at 2 layers (48 SSM
# heads, 24 a rank; its tied head) under 2D at buckets 1 (the state whole
# on every rank) and 4 (the state's and the conv window's rows on
# ``data``: each rank's conv, scan and state update on its rows, the
# per-row output gathered), 4 decode steps, and under FSDP at bucket 4, 2
# steps; Zamba2-2.7B at 6 layers (one application of the shared block: 16
# heads of 80 a rank, flash; its [x, x0] input's rows on ``data``) under
# 2D at buckets 1 (the K/V slots on ``data``, the state whole) and 2 (both
# kinds of slab with their rows on ``data``), 4 steps, and under FSDP at
# bucket 2, 2 steps.  ``faults``: the planted controls of each mode
# (``tp2d_ssm_planted``).
TP2D_SSM = {
    "mamba2": dict(arch="mamba2_780m", cut={"num_layers": 2}, prompt=256,
                   flash=False, modes={
        "tp2d": dict(buckets=(1, 4), steps=4, faults=("state_rows",)),
        "fsdp": dict(buckets=(4,), steps=2, faults=("fsdp_reverse",))}),
    "zamba2": dict(arch="zamba2_2_7b", cut={"num_layers": 6}, prompt=512,
                   flash=True, modes={
        "tp2d": dict(buckets=(1, 2), steps=4,
                     faults=("state_rows", "shared_x0")),
        "fsdp": dict(buckets=(2,), steps=2, faults=("fsdp_reverse",))}),
}
# each path's per-rank pieces, (rows, cols, the dim FSDP puts on ``data``,
# bias, epilogue) as ``TP2D_LEAVES``, a rank's 2D piece (rows/2, cols/2):
# ``w_in``'s cols are twice its segmented piece's width (Mamba2 2 x 3352,
# Zamba2 2 x 5288: the rank's heads' z / x / dt and the whole B / C),
# packed zero-padded to whole blocks as the head is; ``w_out``'s rows on
# ``model`` and its columns on ``data``; Zamba2's shared block over its
# [x, x0] rows (wk and wv are wq's shape, w_up w_gate's)
TP2D_SSM_LEAVES = {
    "mamba2": {"w_in": (1536, 6704, "rows", False, None),
               "w_out": (3072, 1536, "cols", False, None),
               "head": (1536, 50280, "rows", False, None)},
    "zamba2": {"w_in": (2560, 10576, "rows", False, None),
               "w_out": (5120, 2560, "cols", False, None),
               "wq": (5120, 2560, "rows", False, None),
               "wo": (2560, 2560, "cols", False, None),
               "w_gate": (5120, 10240, "rows", False, "silu"),
               "w_down": (10240, 2560, "cols", False, None),
               "head": (2560, 32000, "rows", False, None)},
}


def tp2d_ssm_cfg(name: str):
    from repro_torch.configs.base import get_config
    spec = TP2D_SSM[name]
    return dataclasses.replace(get_config(spec["arch"]), **spec["cut"])


def tp2d_ssm_max_len(spec: dict) -> int:
    """The prompt, the most decode steps of a mode and 8 spare slots."""
    steps = max(m["steps"] for m in spec["modes"].values())
    return -(-(spec["prompt"] + steps + 8) // 8) * 8


def _ssm_segment(cfg, model: int) -> int:
    """The width of a rank's segmented ``w_in`` piece over ``model``."""
    return (2 * cfg.d_inner // model + 2 * cfg.ssm_groups * cfg.ssm_state
            + cfg.ssm_heads // model)


def tp2d_ssm_contract(cfg, mode: str, bucket: int, packed: dict, data: int,
                      model: int, e: int = 2) -> dict:
    """One decode call's collectives on a rank, from the shapes and the
    rank's packed block shapes (``packed``: the engine's pack report),
    bf16 activations (``e`` bytes), the gated norm's sums of squares in
    fp32, as ``tp2d_moe_contract`` does for the MoE family.

    Both modes: each norm's ``embed`` scale gathered over ``data`` (the
    shared block's 2 d_model wide; at ``data=1`` nothing); the lookup
    summed over ``model`` and its columns gathered over ``data``; per
    Mamba2 layer the gated norm's (rows, 1) sums and ``w_out``'s partials
    summed over ``model``; per application of the shared block ``wo``'s
    and ``w_down``'s partials summed over ``model``, and where its K/V
    slots lie on ``data`` its softmax partials gathered over it; the
    logits gathered over ``model``.

    2D: every rank computes the bucket; each k-split product (``w_in``,
    the shared ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``, the head)
    summed over ``data``; ``w_out``'s, ``wo``'s and ``w_down``'s columns
    gathered over ``data``; with the state's rows on ``data`` each Mamba2
    layer's per-row ``y`` gathered over it, and the shared block's
    attention output too.

    FSDP: a data line computes its rows of a bucket it splits; the ids
    gathered over ``data`` before the lookup; every packed piece gathered
    over ``data`` before use."""
    d, v, H = cfg.d_model, cfg.vocab_size, cfg.num_heads
    two_d = mode == "tp2d"
    split = data > 1 and bucket % data == 0
    rows = bucket if two_d or not split else bucket // data
    cols = data if two_d else 1                # the output's column pieces
    ops = []                                   # (op, group size, bytes)

    def ar(n, b):
        ops.append(("all-reduce", n, b))

    def ag(n, b):
        ops.append(("all-gather", n, b))

    def norm(b):
        if data > 1:
            ag(data, b)

    def blocks(leaf):
        n = 1
        for s in packed[leaf][-4:]:
            n *= s
        return n * data * e

    def packed_product(leaf, n_out):
        """A packed piece whose rows lie on data (``n_out`` its columns):
        2D a k-split's sum over data, FSDP its gather."""
        if two_d:
            ar(data, rows * n_out * e)
        else:
            ag(data, blocks(leaf))

    def row_parallel(leaf):
        """w_out, wo, w_down: rows on model, columns on data."""
        if not two_d:
            ag(data, blocks(leaf))
        ar(model, rows * d // cols * e)
        if two_d:
            ag(data, rows * d * e)

    if two_d:
        ar(model, rows * d // data * e)
        ag(data, rows * d * e)
    else:
        ag(data, data * rows * 4)                            # the ids
        ar(model, rows * d * e)
        ag(data, data * rows * d * e)
    stack = "layers" if cfg.family == "ssm" else "mamba_layers"
    for i in range(cfg.num_layers):
        norm(d * e)                                          # ln1
        packed_product(f"{stack}/mamba/w_in", _ssm_segment(cfg, model))
        if two_d and split:
            ag(data, rows * cfg.d_inner // model * e)        # the rows' y
        ar(model, rows * 4)                                  # gated norm
        row_parallel(f"{stack}/mamba/w_out")
        if cfg.family != "hybrid" or (i + 1) % cfg.attn_every:
            continue
        q, kv = H * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        norm(2 * d * e)                                      # shared ln1
        for w, n_out in (("wq", q), ("wk", kv), ("wv", kv)):
            packed_product(f"shared/attn/{w}", n_out // model)
        if data > 1 and not split:
            ag(data, data * rows * H // model * (cfg.head_dim + 2) * 4)
        elif two_d and split:
            ag(data, rows * q // model * e)                  # attn output
        row_parallel("shared/attn/wo")
        norm(2 * d * e)                                      # shared ln2
        for w in ("w_gate", "w_up"):
            packed_product(f"shared/mlp/{w}", cfg.d_ff // model)
        row_parallel("shared/mlp/w_down")
    norm(d * e)                                              # final norm
    packed_product("embed/head", v // model)
    ag(model, rows * v * e)                                  # the logits
    out = {}
    for op, n, b in ops:
        acc = out.setdefault(op, {"count": 0, "bytes_moved": 0.0,
                                  "tensor_bytes": 0.0})
        acc["count"] += 1
        acc["bytes_moved"] += b * _ring(op, n)
        acc["tensor_bytes"] += b
    return out


def tp2d_ssm_fault_buckets(fault: str, buckets: tuple, data: int) -> tuple:
    """Where a control acts: ``state_rows`` at the buckets whose state
    rows lie on ``data``, the others at every bucket of the mode."""
    if fault == "state_rows":
        return tuple(b for b in buckets if b % data == 0)
    return buckets


def tp2d_ssm_planted(eng, cfg, spec: dict, mode: str, data: int,
                     model: int) -> dict:
    """The controls of the logits bound of one mode (``faults``), each
    planted alone on every rank alike, so the ranks stay in step: {fault:
    {bucket: its side}} at each bucket where it acts
    (``tp2d_ssm_fault_buckets``).  Raises unless each fault's site ran as
    often as a side reaches it (the prefill forward, generate's prefill
    and its one decode step).

    * ``state_rows``: each Mamba2 layer's per-row ``y`` gathered in the
      reverse data order (2D, where the state's rows lie on ``data``);
    * ``shared_x0``: the shared block's input ``[x, x]`` in place of
      ``[x, x0]``, so the data rank that contracts the ``x0`` half takes
      ``x`` (2D);
    * ``fsdp_reverse``: each ``w_in`` piece's data halves gathered in the
      reverse order (FSDP)."""
    import torch
    from repro_torch.core import tsmm
    from repro_torch.models import hybrid, mamba2
    calls = [0]
    seg = _ssm_segment(cfg, model)
    apps = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
            else 0)

    def reversed_rows(sound):
        def gather(lay, t):
            calls[0] += 1
            return torch.cat(sound(lay, t).chunk(data, dim=0)[::-1])
        return gather

    def x_for_x0(sound):
        def cat(x, x0):
            calls[0] += 1
            return sound(x, x)
        return cat

    def reversed_w_in(sound):
        def gathered(b, split):
            out, keep = sound(b, split)
            if split == "rows" and b.orig_cols == seg:
                calls[0] += 1
                out = dataclasses.replace(out, blocks=torch.cat(
                    out.blocks.chunk(data, dim=-4)[::-1], dim=-4))
            return out, keep
        return gathered

    # (module, attribute, the fault, its calls a side)
    sites = {"state_rows": (mamba2, "gather_rows", reversed_rows,
                            3 * cfg.num_layers),
             "shared_x0": (hybrid, "shared_in", x_for_x0, 3 * 2 * apps),
             "fsdp_reverse": (tsmm, "_gathered", reversed_w_in,
                              3 * cfg.num_layers)}
    m = spec["modes"][mode]
    out = {}
    for fault in m["faults"]:
        mod, attr, plant, per_side = sites[fault]
        buckets = tp2d_ssm_fault_buckets(fault, m["buckets"], data)
        sound = getattr(mod, attr)
        calls[0] = 0
        setattr(mod, attr, plant(sound))
        try:
            out[fault] = {}
            for b in buckets:
                batch, group = tp2d_moe_rows(eng, cfg, b, spec["prompt"])
                out[fault][b] = tp_family_side(eng, cfg, b, spec, batch,
                                               group)
        finally:
            setattr(mod, attr, sound)
        if not buckets or calls[0] != per_side * len(buckets):
            raise AssertionError(f"tp2d.ssm {mode}: the planted {fault} ran "
                                 f"{calls[0]} times, not "
                                 f"{per_side * len(buckets)}")
    return out


def tp2d_ssm_serve(mesh, name: str, mode: str, res: dict) -> dict:
    """One ``TP2D_SSM`` path in one mode on ``mesh``: load from the rank's
    pieces, the groups (the main path, counted), each group's comparison
    side, the planted controls.  Fills ``res``; returns {"sides": {bucket:
    side}, "planted": ...} (rank 0 compares them with a one-rank engine
    after every path has run)."""
    spec = TP2D_SSM[name]
    m = spec["modes"][mode]
    cfg = tp2d_ssm_cfg(name)
    dev = mesh.device
    eng = tp2d_load(mesh, cfg, mode, m, spec["prompt"],
                    tp2d_ssm_max_len(spec), res)
    stack = "layers" if cfg.family == "ssm" else "mamba_layers"
    p = eng.params
    res["pieces"] = {"w_in": list(p[stack]["mamba"]["w_in"].shape),
                     "w_out": list(p[stack]["mamba"]["w_out"].shape),
                     "ln1": list(p[stack]["ln1"].shape),
                     "tok": list(p["embed"]["tok"].shape)}
    if cfg.family == "hybrid":
        res["pieces"]["shared_wq"] = list(p["shared"]["attn"]["wq"].shape)
        res["pieces"]["shared_ln1"] = list(p["shared"]["ln1"].shape)
    res["cache"] = {b: {k: list(v.shape) for k, v in eng.programs.static_cache(
        b, eng.max_len).items() if k in ("ssm", "conv", "k")}
        for b in m["buckets"]}
    res["layouts"] = {b: repr(eng.cache_layout(b)) for b in m["buckets"]}
    res["graphed"] = eng.programs.stats()["graphed"]
    tp2d_main_path(eng, cfg, mode, m, spec["prompt"], tp2d_ssm_contract,
                   res)
    sides = {}
    for b in m["buckets"]:
        batch, group = tp2d_moe_rows(eng, cfg, b, spec["prompt"])
        sides[b] = tp_family_side(eng, cfg, b, spec, batch, group)
    planted = tp2d_ssm_planted(eng, cfg, spec, mode, mesh.shape["data"],
                               mesh.shape["model"])
    del eng, p
    _free(dev.type)
    return {"sides": sides, "planted": planted}


def tp2d_side_compare(mesh, cfg, spec: dict, max_len: int, kept: dict,
                      batch_of, seeded=None) -> dict:
    """Rank 0's sides of every mode of one ``TP2D_SSM`` or
    ``TP2D_FAMILIES`` path (``kept``: {mode: its serve's return}) against
    a one-rank engine on the same seeded weights (``seeded``: the
    redrawing ``tp2d_load`` applied), on the rows rank 0's side reads (the
    data line's under FSDP) of ``batch_of``'s groups, as
    ``tp_family_compare`` holds them: every prefill position's logits,
    the first decode step's on the rows whose input agrees, an
    encoder-decoder's cross cache on rank 0's rows and heads, and each
    planted control's distance in bounds."""
    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore

    model = build_model(cfg)
    dev = mesh.device
    params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
    if seeded is not None:
        params = seeded(params, axes)
    rows = sorted({s["logits"].shape[0] for k in kept.values()
                   for s in k["sides"].values()})
    one = Engine(model, params, axes, max_len=max_len, buckets=tuple(rows),
                 max_prompt=spec["prompt"], device=dev.type)
    del params
    one.programs = ProgramStore(model, device=dev, capture=False)

    def mine(side, want):
        """The one-rank side cut to rank 0's rows of the cross cache
        (under 2D the bucket's first rows where they lie on ``data``)."""
        if "cross" not in side:
            return want
        return {**want, "cross": want["cross"][:, :side["cross"].shape[1]]}

    out, wants = {}, {}
    for mode, k in kept.items():
        out[mode] = {}
        for b, got in k["sides"].items():
            n = got["logits"].shape[0]
            if (b, n) not in wants:
                batch = {key: v[:n] for key, v in batch_of(
                    cfg, b, spec["prompt"], dev).items()}
                wants[b, n] = tp_family_side(one, cfg, n, spec, batch)
            out[mode][b] = {
                **tp_family_compare(cfg, got, mine(got, wants[b, n]),
                                    {f: p[b] for f, p in
                                     k["planted"].items() if b in p}),
                "rows_compared": n}
    del one
    _free(dev.type)
    return out


def tp2d_ssm_compare(mesh, name: str, kept: dict) -> dict:
    """``tp2d_side_compare`` of a ``TP2D_SSM`` path."""
    spec = TP2D_SSM[name]
    return tp2d_side_compare(mesh, tp2d_ssm_cfg(name), spec,
                             tp2d_ssm_max_len(spec), kept, tp_moe_tokens)


def tp2d_compare_checks(name: str, mode: str, cmp: dict,
                        faults: tuple) -> list:
    """What rank 0's comparisons of one path in one mode (``cmp``: {bucket:
    ``tp_family_compare``'s row}) break: no decode row compared, a bucket
    outside ``TP_LOGITS_TOL``, a planted control of ``faults`` not over
    one bound outside at its least bucket."""
    bad = []
    if not sum(c["decode_rows"] for c in cmp.values()):
        bad.append(f"{name} {mode}: rank 0 compared no decode row")
    for b, c in cmp.items():
        if not c["within"]:
            bad.append(f"{name} {mode} b={b}: rank 0 vs the one-rank "
                       f"engine {c}")
    for fault in faults:
        read = [c["planted"][fault] for c in cmp.values()
                if fault in c["planted"]]
        least = min((p["bounds_outside"] for p in read), default=0.0)
        if not least > 1.0:
            bad.append(f"{name} {mode}: the planted {fault} lands "
                       f"{least} bounds outside at its least bucket")
    return bad


def tp2d_ssm_checks(ranks: list) -> list:
    """What the four ranks' results break of the tp2d.ssm paths'
    contract."""
    bad = []
    for name, spec in TP2D_SSM.items():
        cfg = tp2d_ssm_cfg(name)
        d, di, n = cfg.d_model, cfg.d_inner, cfg.num_layers
        gn = cfg.ssm_groups * cfg.ssm_state
        for mode, m in spec["modes"].items():
            for rank in ranks:
                rk, res = rank["rank"], rank["ssm"][name][mode]
                where = f"{name} {mode} rank {rk}"
                bad += tp2d_path_checks(where, res, mode, spec["flash"])
                pieces = {"w_in": [n, d // 2, _ssm_segment(cfg, 2)],
                          "w_out": [n, di // 2, d // 2],
                          "ln1": [n, d // 2],
                          "tok": [cfg.vocab_size // 2, d // 2]}
                if cfg.family == "hybrid":
                    pieces["shared_wq"] = [d, cfg.num_heads
                                           * cfg.head_dim // 2]
                    pieces["shared_ln1"] = [d]
                if res["pieces"] != pieces:
                    bad.append(f"{where}: pieces {res['pieces']} != {pieces}")
                for b, c in res["cache"].items():
                    rows = int(b) // 2 if int(b) % 2 == 0 else int(b)
                    if c["conv"][-3:] != [rows, cfg.ssm_conv - 1,
                                          di // 2 + 2 * gn]:
                        bad.append(f"{where} b={b}: conv cache {c['conv']}")
            bad += tp2d_compare_checks(
                name, mode, ranks[0]["ssm"][name]["compare"][mode],
                m["faults"])
        bad += tp2d_bytes_checks(name, ranks, "ssm")
    return bad


# ---------------------------------------------------------------------------
# tp2d.family: the VLM and encoder-decoder families under 2D tensor
# parallelism and FSDP, in the tp2d phase's ranks
# ---------------------------------------------------------------------------

# Each at its published widths, bf16, seeded, each rank drawing every leaf
# whole on the card and keeping its piece under the mode's rules
# (``init_pieces(mesh, cfg, opts)``: every ``embed`` dim on ``data``, the
# LayerNorms' scales and biases and whisper's ``b_out`` among them; heads
# and MLP columns on ``model``), the norms and the GELU MLPs' biases then
# redrawn away from their init (``tp2d_family_seeded``): the LLaVA-NeXT
# backbone at 2 layers (2880 seeded image embeddings ahead of 192 tokens,
# 3072 positions; flash at D 128 on 16 query and 4 KV heads a rank) under
# 2D at buckets 1 (the cache's slots on ``data``) and 2 (its rows on
# ``data``), 4 decode steps, and under FSDP at bucket 2, 2 steps;
# whisper-base whole (6 + 6 layers, 1500 seeded frames, 4 of 8 heads a
# rank, flash at D 64 on the decoder's 256-token prompt, its odd
# vocabulary whole on every rank) under 2D at buckets 1 (the
# self-attention slots on ``data``, the cross cache whole) and 2 (both
# caches' rows on ``data``), 4 steps, and under FSDP at bucket 2, 2
# steps.  ``faults``: the planted controls of each mode
# (``tp2d_family_planted``).
TP2D_FAMILIES = {
    "llava": dict(arch="llava_next_mistral_7b", cut={"num_layers": 2},
                  prompt=192, flash=True, modes={
        "tp2d": dict(buckets=(1, 2), steps=4, faults=("embeds",)),
        "fsdp": dict(buckets=(2,), steps=2, faults=("fsdp_reverse",))}),
    "whisper": dict(arch="whisper_base", cut={}, prompt=256, flash=True,
                    modes={
        "tp2d": dict(buckets=(1, 2), steps=4,
                     faults=("cross_rows", "gelu_partial")),
        "fsdp": dict(buckets=(2,), steps=2, faults=("fsdp_reverse",))}),
}
# each path's per-rank pieces, (rows, cols, the dim FSDP puts on ``data``,
# bias, epilogue[, whether ``model`` takes the other dim]) as
# ``TP2D_LEAVES``, a rank's 2D piece (rows/2, cols/2): LLaVA's ``wq`` /
# ``wk`` (``wv`` is ``wk``'s shape, ``w_up`` ``w_gate``'s), ``wo``,
# ``w_gate`` / ``w_down`` and its head; whisper's ``wq`` (every attention
# projection of its self- and cross-attention is this shape), ``wo``, the
# GELU MLP's ``w_in`` (its bias and GELU in the epilogue under FSDP, after
# the data sum under 2D: its 2D partial runs with no epilogue) and
# ``w_out`` (``b_out``'s piece in the first ``model`` rank's epilogue),
# and its tied head, whose odd vocabulary stays off ``model``
TP2D_FAMILY_LEAVES = {
    "llava": {"wq": (4096, 4096, "rows", False, None),
              "wk": (4096, 1024, "rows", False, None),
              "wo": (4096, 4096, "cols", False, None),
              "w_gate": (4096, 14336, "rows", False, "silu"),
              "w_down": (14336, 4096, "cols", False, None),
              "head": (4096, 32000, "rows", False, None)},
    "whisper": {"wq": (512, 512, "rows", False, None),
                "wo": (512, 512, "cols", False, None),
                "w_in": (512, 2048, "rows", True, "gelu"),
                "w_out": (2048, 512, "cols", True, None),
                "head": (512, 51865, "rows", False, None, False)},
}


def tp2d_family_cfg(name: str):
    from repro_torch.configs.base import get_config
    spec = TP2D_FAMILIES[name]
    return dataclasses.replace(get_config(spec["arch"]), **spec["cut"])


def tp2d_family_max_len(cfg, spec: dict) -> int:
    """The image embeddings, the prompt, the most decode steps of a mode
    and 8 spare slots, a multiple of 8."""
    image = cfg.num_image_tokens if cfg.embeds_input else 0
    steps = max(m["steps"] for m in spec["modes"].values())
    return -(-(image + spec["prompt"] + steps + 8) // 8) * 8


def tp2d_family_rows(cfg, rows: tuple, prompt: int) -> tuple:
    """The rows the path's products run at from its decode ``rows``: each
    decode row count, and each group's prefill, ``rows`` x (the image
    embeddings and the prompt), or whisper's decoder prompt and its
    encoder's 1500 frames."""
    per = [prompt]
    if cfg.embeds_input:
        per = [cfg.num_image_tokens + prompt]
    if cfg.is_encoder_decoder:
        per.append(cfg.encoder_seq)
    return tuple(sorted({*rows, *(r * n for r in rows for n in per)}))


def tp2d_family_batch(cfg, b: int, prompt: int, device) -> dict:
    """``tp_family_batch``'s group, each utterance's frames given a
    direction of its own (a seeded N(0, 1) d_model vector added to every
    frame of the row): seeded frames alone average out over 1500 frames,
    so every row's cross-attention would read about the same mean, and a
    mix-up of the cross cache's rows would hide."""
    import torch
    out = tp_family_batch(cfg, b, prompt, device)
    if cfg.is_encoder_decoder:
        g = torch.Generator(device="cpu").manual_seed(500 + b)
        u = torch.randn((b, 1, cfg.d_model), generator=g).to(device)
        out["enc_frames"] = (out["enc_frames"].float() + u).to(
            out["enc_frames"].dtype)
    return out


def tp2d_family_seeded(cfg):
    """A ``seeded(params, axes, mesh=None, opts=None)`` for ``tp2d_load``
    and the one-rank engine: ``params`` with every norm's scale (1 + 0.1
    N(0, 1)), every LayerNorm's bias and the GELU MLPs' ``b_in`` /
    ``b_out`` (0.1 N(0, 1)) redrawn from a generator seeded by the leaf's
    path, away from their init (ones, zeros), so that a bias added once
    per data rank, or a piece gathered out of order, would show.  Each
    such leaf is drawn whole (on the CPU, at ``cfg``'s full shape) and, on
    a ``mesh``, cut to the rank's piece under ``opts`` as ``init_pieces``
    cuts it."""
    import zlib

    import torch
    from repro_torch.models.param import MetaGenerator
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import (ShardingOptions, local_shard,
                                            pspec_for)

    def walk(p, a, full, path, mesh, opts):
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = walk(v, a[k], full[k], path + (k,), mesh, opts)
                continue
            scale = k.endswith("_s") or k in ("ln1", "ln2", "final_norm")
            if not (scale or k.endswith("_b") or k in ("b_in", "b_out")):
                out[k] = v
                continue
            g = torch.Generator(device="cpu").manual_seed(
                zlib.crc32("/".join(path + (k,)).encode()))
            t = 0.1 * torch.randn(tuple(full[k].shape), generator=g)
            if scale:
                t = t + 1
            if mesh is not None:
                t = local_shard(t, pspec_for(tuple(a[k]), tuple(t.shape),
                                             mesh, opts), mesh, mesh.coords)
            out[k] = t.to(device=v.device, dtype=v.dtype)
        return out

    def seeded(params, axes, mesh=None, opts=None):
        full = build_model(cfg).init(MetaGenerator())[0]
        return walk(params, axes, full, (), mesh,
                    opts or ShardingOptions())

    return seeded


def tp2d_family_fault_buckets(fault: str, buckets: tuple, data: int) -> tuple:
    """Where a control is read: the least bucket where it acts
    (``cross_rows`` where the cross cache's rows lie on ``data``)."""
    acts = [b for b in buckets if fault != "cross_rows" or b % data == 0]
    return tuple(acts[:1])


def tp2d_family_planted(mesh, eng, cfg, spec: dict, mode: str) -> dict:
    """The controls of the logits bound of one mode (``faults``), each
    planted alone on every rank alike (the ranks stay in step), read at
    the least bucket where it acts (``tp2d_family_fault_buckets``):
    {fault: {bucket: its side}}.  Raises unless each fault's site ran as
    often as a side reaches it (the prefill forward, generate's prefill
    and its one decode step).

    * ``embeds``: the image embeddings zeroed on rank 1 (2D);
    * ``cross_rows``: ``cross_decode`` reading the cross cache's first
      rows instead of the rank's rows (2D, where they lie on ``data``):
      after the prefill every data rank's cross cache holds the first data
      rank's rows (a query mismatch alone would hide: at random weights
      the cross-attention's softmax over 1500 frames is near uniform);
    * ``gelu_partial``: ``w_in``'s bias and GELU applied to each data
      partial before the sum (2D);
    * ``fsdp_reverse``: each MLP in-projection piece's data halves
      (LLaVA's ``w_gate`` / ``w_up``, whisper's ``w_in``) gathered in the
      reverse order (FSDP)."""
    import torch
    from repro_torch.core import linear, tsmm
    from repro_torch.models import encdec
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import (axis_group, cache_layout,
                                              dp_group)
    data, model = mesh.shape["data"], mesh.shape["model"]
    calls = [0]
    # MLP in-projections a forward runs, and a decode step
    enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    per_fwd = (enc + cfg.num_layers if cfg.is_encoder_decoder
               else 2 * cfg.num_layers)
    per_step = (cfg.num_layers if cfg.is_encoder_decoder
                else 2 * cfg.num_layers)

    def first_rows(sound):
        def prefill(params, cfg_, batch, cache, **kw):
            out = sound(params, cfg_, batch, cache, **kw)
            calls[0] += 1
            group = axis_group(cache_layout().rows)[0]
            rows = cache["cross_k"].shape[1]
            for key in ("cross_k", "cross_v"):
                every = comm.all_gather(cache[key], group, dim=1)
                cache[key].copy_(every[:, :rows])
            return out
        return prefill

    def epilogue_first(sound):
        def ksplit_sum(part, bias, act, dtype):
            if act != "gelu":
                return sound(part, bias, act, dtype)
            calls[0] += 1
            return tsmm._data_sum(tsmm._epilogue(part, bias, act, dtype),
                                  dp_group())
        return ksplit_sum

    def reversed_in(sound):
        def gathered(b, split):
            out, keep = sound(b, split)
            if split == "rows" and b.orig_cols == cfg.d_ff // model:
                calls[0] += 1
                out = dataclasses.replace(out, blocks=torch.cat(
                    out.blocks.chunk(data, dim=-4)[::-1], dim=-4))
            return out, keep
        return gathered

    # (the sites patched, the fault, its calls a side)
    sites = {"cross_rows": (((encdec, "encdec_prefill"),), first_rows, 1),
             "gelu_partial": (((tsmm, "ksplit_sum"), (linear, "ksplit_sum")),
                              epilogue_first, 2 * per_fwd + per_step),
             "fsdp_reverse": (((tsmm, "_gathered"),), reversed_in,
                              2 * per_fwd + per_step),
             "embeds": ((), None, 1 if mesh.rank == 1 else 0)}
    m = spec["modes"][mode]
    out = {}
    for fault in m["faults"]:
        where, plant, per_side = sites[fault]
        buckets = tp2d_family_fault_buckets(fault, m["buckets"], data)
        sound = [getattr(mod, attr) for mod, attr in where]
        calls[0] = 0
        for (mod, attr), f in zip(where, sound):
            setattr(mod, attr, plant(f))
        try:
            out[fault] = {}
            for b in buckets:
                batch, group = tp2d_moe_rows(eng, cfg, b, spec["prompt"],
                                             tp2d_family_batch)
                if fault == "embeds" and mesh.rank == 1:
                    calls[0] += 1
                    batch = {**batch,
                             "embeds": torch.zeros_like(batch["embeds"])}
                out[fault][b] = tp_family_side(eng, cfg, b, spec, batch,
                                               group)
        finally:
            for (mod, attr), f in zip(where, sound):
                setattr(mod, attr, f)
        if not buckets or calls[0] != per_side * len(buckets):
            raise AssertionError(f"tp2d.family {mode}: the planted {fault} "
                                 f"ran {calls[0]} times, not "
                                 f"{per_side * len(buckets)}")
    return out


def tp2d_family_serve(mesh, name: str, mode: str, res: dict) -> dict:
    """One ``TP2D_FAMILIES`` path in one mode on ``mesh``: load from the
    rank's pieces, the groups (the main path, counted), each group's
    comparison side, the planted controls.  Fills ``res``; returns
    {"sides": {bucket: side}, "planted": ...} (rank 0 compares them with
    a one-rank engine after every mode has run)."""
    spec = TP2D_FAMILIES[name]
    m = spec["modes"][mode]
    cfg = tp2d_family_cfg(name)
    dev = mesh.device
    eng = tp2d_load(mesh, cfg, mode, m, spec["prompt"],
                    tp2d_family_max_len(cfg, spec), res,
                    seeded=tp2d_family_seeded(cfg))
    p = eng.params
    if cfg.is_encoder_decoder:
        lp = p["dec_layers"]
        res["pieces"] = {"wq": list(lp["self_attn"]["wq"].shape),
                         "w_in": list(lp["mlp"]["w_in"].shape),
                         "w_out": list(lp["mlp"]["w_out"].shape),
                         "b_out": list(lp["mlp"]["b_out"].shape),
                         "ln1_s": list(lp["ln1_s"].shape),
                         "ln1_b": list(lp["ln1_b"].shape),
                         "enc_norm_b": list(p["enc_norm_b"].shape)}
    else:
        lp = p["layers"]
        res["pieces"] = {"wq": list(lp["attn"]["wq"].shape),
                         "w_gate": list(lp["mlp"]["w_gate"].shape),
                         "w_down": list(lp["mlp"]["w_down"].shape),
                         "ln1": list(lp["ln1"].shape)}
    res["pieces"]["tok"] = list(p["embed"]["tok"].shape)
    res["cache"] = {b: {k: list(v.shape) for k, v in eng.programs.static_cache(
        b, eng.max_len).items() if k in ("k", "cross_k")}
        for b in m["buckets"]}
    res["layouts"] = {b: repr(eng.cache_layout(b)) for b in m["buckets"]}
    res["graphed"] = eng.programs.stats()["graphed"]
    tp2d_main_path(eng, cfg, mode, m, spec["prompt"], tp2d_contract,
                   res, batch_of=tp2d_family_batch)
    sides = {}
    for b in m["buckets"]:
        batch, group = tp2d_moe_rows(eng, cfg, b, spec["prompt"],
                                     tp2d_family_batch)
        sides[b] = tp_family_side(eng, cfg, b, spec, batch, group)
    planted = tp2d_family_planted(mesh, eng, cfg, spec, mode)
    del eng, p, lp
    _free(dev.type)
    return {"sides": sides, "planted": planted}


def tp2d_family_compare(mesh, name: str, kept: dict) -> dict:
    """``tp2d_side_compare`` of a ``TP2D_FAMILIES`` path, its norms and
    GELU biases redrawn as the ranks' (``tp2d_family_seeded``)."""
    spec = TP2D_FAMILIES[name]
    cfg = tp2d_family_cfg(name)
    return tp2d_side_compare(mesh, cfg, spec, tp2d_family_max_len(cfg, spec),
                             kept, tp2d_family_batch,
                             tp2d_family_seeded(cfg))


def tp2d_family_checks(ranks: list) -> list:
    """What the four ranks' results break of the tp2d.family paths'
    contract."""
    bad = []
    for name, spec in TP2D_FAMILIES.items():
        cfg = tp2d_family_cfg(name)
        d, n, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
        q, v = cfg.num_heads * cfg.head_dim, cfg.vocab_size
        kh, hd = cfg.num_kv_heads // 2, cfg.head_dim
        max_len = tp2d_family_max_len(cfg, spec)
        for mode, m in spec["modes"].items():
            for rank in ranks:
                rk, res = rank["rank"], rank["family"][name][mode]
                where = f"{name} {mode} rank {rk}"
                bad += tp2d_path_checks(where, res, mode, spec["flash"])
                if cfg.is_encoder_decoder:
                    pieces = {"wq": [n, d // 2, q // 2],
                              "w_in": [n, d // 2, ff // 2],
                              "w_out": [n, ff // 2, d // 2],
                              "b_out": [n, d // 2], "ln1_s": [n, d // 2],
                              "ln1_b": [n, d // 2], "enc_norm_b": [d // 2],
                              "tok": [v, d // 2]}
                else:
                    pieces = {"wq": [n, d // 2, q // 2],
                              "w_gate": [n, d // 2, ff // 2],
                              "w_down": [n, ff // 2, d // 2],
                              "ln1": [n, d // 2], "tok": [v // 2, d // 2]}
                if res["pieces"] != pieces:
                    bad.append(f"{where}: pieces {res['pieces']} != {pieces}")
                for b, c in res["cache"].items():
                    b = int(b)
                    rows = b // 2 if b % 2 == 0 else b
                    slots = max_len // 2 if b % 2 else max_len
                    want = {"k": [n, rows, slots, kh, hd]}
                    if cfg.is_encoder_decoder:
                        # at bucket 1 the cross cache stays whole
                        want["cross_k"] = [n, rows, cfg.encoder_seq, kh, hd]
                    if c != want:
                        bad.append(f"{where} b={b}: cache {c} != {want}")
            bad += tp2d_compare_checks(
                name, mode, ranks[0]["family"][name]["compare"][mode],
                m["faults"])
        bad += tp2d_bytes_checks(name, ranks, "family")
    return bad


def phase_tp2d():
    """2D weight-stationary tensor parallelism and FSDP serving on the
    card: ``install_arch(mesh=, opts=)`` for both modes; the per-rank
    kernels against their plain versions; four ranks
    (``torch.distributed.run``) sharing the card as ``data=2,model=2``
    over gloo serve qwen1.5-4b (full width, 2 layers, bf16, seeded
    biases and norms) under ``fsdp=True, serve_2d_tp=True`` and under
    ``fsdp=True``, lookup-only, with rank 0's logits against a one-rank
    engine, a planted fault, each decode call's collectives against the
    contract and the 2D decode moving fewer bytes than FSDP's; then the
    MoE family in the same ranks (``TP2D_MOE``: OLMoE-1B-7B under both
    modes, DeepSeek-V2 under 2D, at their published widths cut to 2
    layers) lookup-only after their own sweeps, each against a one-rank
    engine routed alike with the first MoE layer's flips bounded, the
    planted controls, the contracts, no weight gathered in a 2D decode
    call; then the SSM family and the hybrid in the same ranks
    (``TP2D_SSM``: Mamba2-780m and Zamba2-2.7B under both modes) against a
    one-rank engine with their planted controls, the contracts, no weight
    gathered in a 2D decode call; then the VLM and encoder-decoder
    families in the same ranks (``TP2D_FAMILIES``: the LLaVA-NeXT backbone
    cut to 2 layers and whisper-base whole under both modes), as the SSM
    paths; the MoE, SSM and VLM / encoder-decoder paths' rank-0 sides
    compared with one-rank engines in this process while the ranks serve
    on (``tp2d_compares``); then NCCL at world size 1 with the 2D cells
    captured (qwen's, OLMoE's, Zamba2's and whisper-base's).  Returns each
    rank's launches on the main path and at load, and the kernel cases."""
    import signal

    import torch
    from repro_torch.analysis.collectives import bytes_moved
    from repro_torch.core import install, registry
    from repro_torch.serve.engine import compute_rows
    from repro_torch.sharding.rules import ShardingOptions
    t_phase = time.perf_counter()
    _free("cuda")
    t0 = time.perf_counter()
    cfg = tp2d_cfg()
    desc = install.parse_mesh("data=2,model=2")
    plans = {mode: install.install_arch(
        cfg, TP2D_BUCKETS, mesh=desc, opts=ShardingOptions(**o),
        device="cuda") for mode, o in TP2D_MODES.items()}
    registry.flush()
    emit({"phase": "tp2d.install", "seconds": time.perf_counter() - t0,
          "plans": plans})
    # the MoE paths' sweeps, each mode at its buckets and the one length
    # bucket its prompts take, written in one flush
    t0 = time.perf_counter()
    plans = {f"{name}.{mode}": install.install_arch(
        tp2d_moe_cfg(name), m["buckets"], (spec["prompt"],), mesh=desc,
        opts=ShardingOptions(**TP2D_MODES[mode]), device="cuda")
        for name, spec in TP2D_MOE.items()
        for mode, m in spec["modes"].items()}
    registry.flush()
    emit({"phase": "tp2d.moe.install", "seconds": time.perf_counter() - t0,
          "plans": plans})
    # the SSM paths' sweeps, as the MoE paths'
    t0 = time.perf_counter()
    plans = {f"{name}.{mode}": install.install_arch(
        tp2d_ssm_cfg(name), m["buckets"], (spec["prompt"],), mesh=desc,
        opts=ShardingOptions(**TP2D_MODES[mode]), device="cuda")
        for name, spec in TP2D_SSM.items()
        for mode, m in spec["modes"].items()}
    registry.flush()
    emit({"phase": "tp2d.ssm.install", "seconds": time.perf_counter() - t0,
          "plans": plans})
    # the VLM and encoder-decoder paths' sweeps, as the MoE paths'
    t0 = time.perf_counter()
    plans = {f"{name}.{mode}": install.install_arch(
        tp2d_family_cfg(name), m["buckets"], (spec["prompt"],), mesh=desc,
        opts=ShardingOptions(**TP2D_MODES[mode]), device="cuda")
        for name, spec in TP2D_FAMILIES.items()
        for mode, m in spec["modes"].items()}
    registry.flush()
    emit({"phase": "tp2d.family.install",
          "seconds": time.perf_counter() - t0, "plans": plans})
    t0 = time.perf_counter()
    shard_cases = tp2d_shard_cases()
    emit({"phase": "tp2d.kernels.seconds",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    moe_cases = {}
    for name, spec in TP2D_MOE.items():
        two, fsdp = (spec["modes"][x] if x in spec["modes"] else None
                     for x in TP2D_MODES)
        fsdp_rows = (sorted({compute_rows(b, desc, ShardingOptions(
            **TP2D_MODES["fsdp"])) for b in fsdp["buckets"]})
                     if fsdp else ())
        moe_cases[name] = tp2d_shard_cases(
            TP2D_MOE_LEAVES[name], two["buckets"],
            path_rows(two["buckets"], spec["prompt"], two["queue"]),
            tuple(fsdp_rows),
            (path_rows(fsdp_rows, spec["prompt"], fsdp["queue"]) if fsdp
             else None),
            phase="tp2d.moe", unpacked=TP2D_MOE_UNPACKED.get(name),
            path=name)
        _free("cuda")
    emit({"phase": "tp2d.moe.kernels.seconds",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ssm_cases = {}
    fsdp_opts = ShardingOptions(**TP2D_MODES["fsdp"])
    for name, spec in TP2D_SSM.items():
        two, fsdp = spec["modes"]["tp2d"], spec["modes"]["fsdp"]
        fsdp_rows = tuple(sorted({compute_rows(b, desc, fsdp_opts)
                                  for b in fsdp["buckets"]}))
        ssm_cases[name] = tp2d_shard_cases(
            TP2D_SSM_LEAVES[name], two["buckets"],
            path_rows(two["buckets"], spec["prompt"]), fsdp_rows,
            path_rows(fsdp_rows, spec["prompt"]), phase="tp2d.ssm",
            path=name)
        _free("cuda")
    emit({"phase": "tp2d.ssm.kernels.seconds",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    family_cases = {}
    for name, spec in TP2D_FAMILIES.items():
        cfg_f = tp2d_family_cfg(name)
        two, fsdp = spec["modes"]["tp2d"], spec["modes"]["fsdp"]
        fsdp_rows = tuple(sorted({compute_rows(b, desc, fsdp_opts)
                                  for b in fsdp["buckets"]}))
        family_cases[name] = tp2d_shard_cases(
            TP2D_FAMILY_LEAVES[name], two["buckets"],
            tp2d_family_rows(cfg_f, two["buckets"], spec["prompt"]),
            fsdp_rows, tp2d_family_rows(cfg_f, fsdp_rows, spec["prompt"]),
            phase="tp2d.family", path=name)
        _free("cuda")
    emit({"phase": "tp2d.family.kernels.seconds",
          "seconds": time.perf_counter() - t0})
    _free("cuda")
    out_dir = tempfile.mkdtemp(prefix="tp2d-", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", os.path.abspath(__file__),
         "--tp2d-worker", out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    # rank 0's sides are compared with one-rank engines here, while the
    # ranks serve the next paths (a few CPU threads: the ranks' own)
    compared, threads = {}, torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    host = types.SimpleNamespace(device=torch.device("cuda"),
                                 shape={"data": 2, "model": 2})
    comparer = threading.Thread(target=tp2d_compares,
                                args=(out_dir, proc, host, compared))
    comparer.start()
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        comparer.join()
        torch.set_num_threads(threads)
    ranks = []
    for r in range(4):
        path = os.path.join(out_dir, f"tp2d_rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    if proc.returncode != 0:
        raise AssertionError(f"tp2d: the ranks exited {proc.returncode}:\n"
                             f"{out[-3000:]}\n{err[-6000:]}")
    if "error" in compared:
        raise AssertionError(f"tp2d: a one-rank comparison failed:\n"
                             f"{compared['error']}")
    for key, paths, _ in TP2D_COMPARED:
        for name in globals()[paths]:
            if (key, name) not in compared:
                raise AssertionError(f"tp2d: no sides of {key} {name} "
                                     f"compared")
            # JSON's keys, as the ranks' own results read
            cmp, secs = compared[key, name]
            ranks[0][key][name]["compare"] = json.loads(json.dumps(
                cmp, default=str))
            ranks[0][key][name]["compare_seconds"] = secs
    bad = (tp2d_checks(ranks) + tp2d_moe_checks(ranks)
           + tp2d_ssm_checks(ranks) + tp2d_family_checks(ranks))
    # every skinny and pack launch of a main path at a (kernel, m, K, N)
    # (a pack's (M, K, bm, bk)) that a case held against its plain version
    for res in ranks:
        for mode in TP2D_MODES:
            unheld = unheld_shapes(res[mode]["shapes"], shard_cases)
            if unheld:
                bad.append(f"rank {res['rank']} {mode}: launched at shapes "
                           f"tp2d.kernels did not hold: {unheld}")
        for name, spec in TP2D_MOE.items():
            for mode in spec["modes"]:
                unheld = unheld_shapes(res["moe"][name][mode]["shapes"],
                                       moe_cases[name])
                if unheld:
                    bad.append(f"{name} {mode} rank {res['rank']}: launched "
                               f"at shapes tp2d.moe.kernels did not hold: "
                               f"{unheld}")
        for name, spec in TP2D_SSM.items():
            for mode in spec["modes"]:
                unheld = unheld_shapes(res["ssm"][name][mode]["shapes"],
                                       ssm_cases[name])
                if unheld:
                    bad.append(f"{name} {mode} rank {res['rank']}: launched "
                               f"at shapes tp2d.ssm.kernels did not hold: "
                               f"{unheld}")
        for name, spec in TP2D_FAMILIES.items():
            for mode in spec["modes"]:
                unheld = unheld_shapes(res["family"][name][mode]["shapes"],
                                       family_cases[name])
                if unheld:
                    bad.append(f"{name} {mode} rank {res['rank']}: launched "
                               f"at shapes tp2d.family.kernels did not hold: "
                               f"{unheld}")
    for res in ranks:
        for mode in TP2D_MODES:
            r = res[mode]
            emit({"phase": "tp2d.rank", "rank": res["rank"], "mode": mode,
                  **{k: r[k] for k in ("load", "graphed", "launches",
                                       "designs", "comm", "staged", "misses",
                                       "healthy", "queue", "peak_bytes",
                                       "layouts", "pieces", "shapes")},
                  "groups": r["groups"]})
    r0 = ranks[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, spec in TP2D_MOE.items():
        for mode in spec["modes"]:
            for res in ranks:
                m = res["moe"][name][mode]
                emit({"phase": "tp2d.moe.rank", "path": name, "mode": mode,
                      "rank": res["rank"], **{k: m[k] for k in (
                          "seconds", "load", "pieces", "layouts", "graphed",
                          "launches", "designs", "comm", "staged", "misses",
                          "healthy", "peak_bytes", "queue", "groups",
                          "shapes")}})
            emit({"phase": f"tp2d.moe.{name}.{mode}", "nvidia_smi": smi,
                  "logits_tol": TP_LOGITS_TOL,
                  "routing_bound": {"gap": TP_MOE_GAP,
                                    "flips": TP_MOE_FLIPS},
                  "faults": spec["modes"][mode]["faults"],
                  "compare": r0["moe"][name]["compare"][mode],
                  "compare_seconds": r0["moe"][name]["compare_seconds"],
                  "decode_collectives": {
                      b: g["collectives"] for b, g in
                      r0["moe"][name][mode]["groups"].items()},
                  "decode_bytes_moved": {
                      b: bytes_moved(g["collectives"]) for b, g in
                      r0["moe"][name][mode]["groups"].items()},
                  "weights_gathered_a_decode_call": {
                      b: g["weight_gathers"] for b, g in
                      r0["moe"][name][mode]["groups"].items()},
                  "peak_bytes": [r["moe"][name][mode]["peak_bytes"]
                                 for r in ranks]})
    for name, spec in TP2D_SSM.items():
        for mode in spec["modes"]:
            for res in ranks:
                m = res["ssm"][name][mode]
                emit({"phase": "tp2d.ssm.rank", "path": name, "mode": mode,
                      "rank": res["rank"], **{k: m[k] for k in (
                          "seconds", "load", "pieces", "cache", "layouts",
                          "graphed", "launches", "designs", "comm", "staged",
                          "misses", "healthy", "degradations", "peak_bytes",
                          "groups", "shapes")}})
            emit({"phase": f"tp2d.ssm.{name}.{mode}", "nvidia_smi": smi,
                  "logits_tol": TP_LOGITS_TOL,
                  "faults": spec["modes"][mode]["faults"],
                  "compare": r0["ssm"][name]["compare"][mode],
                  "compare_seconds": r0["ssm"][name]["compare_seconds"],
                  "decode_collectives": {
                      b: g["collectives"] for b, g in
                      r0["ssm"][name][mode]["groups"].items()},
                  "decode_bytes_moved": {
                      b: bytes_moved(g["collectives"]) for b, g in
                      r0["ssm"][name][mode]["groups"].items()},
                  "weights_gathered_a_decode_call": {
                      b: g["weight_gathers"] for b, g in
                      r0["ssm"][name][mode]["groups"].items()},
                  "peak_bytes": [r["ssm"][name][mode]["peak_bytes"]
                                 for r in ranks]})
    for name, spec in TP2D_FAMILIES.items():
        for mode in spec["modes"]:
            for res in ranks:
                m = res["family"][name][mode]
                emit({"phase": "tp2d.family.rank", "path": name,
                      "mode": mode, "rank": res["rank"], **{k: m[k] for k in (
                          "seconds", "load", "pieces", "cache", "layouts",
                          "graphed", "launches", "designs", "comm", "staged",
                          "misses", "healthy", "degradations", "peak_bytes",
                          "groups", "shapes")}})
            g0 = r0["family"][name][mode]["groups"]
            emit({"phase": f"tp2d.family.{name}.{mode}", "nvidia_smi": smi,
                  "logits_tol": TP_LOGITS_TOL,
                  "faults": spec["modes"][mode]["faults"],
                  "compare": r0["family"][name]["compare"][mode],
                  "compare_seconds": r0["family"][name]["compare_seconds"],
                  "decode_collectives": {
                      b: g["collectives"] for b, g in g0.items()},
                  "decode_bytes_moved": {
                      b: bytes_moved(g["collectives"]) for b, g in g0.items()},
                  "weights_gathered_a_decode_call": {
                      b: g["weight_gathers"] for b, g in g0.items()},
                  "peak_bytes": [r["family"][name][mode]["peak_bytes"]
                                 for r in ranks]})
    emit({"phase": "tp2d", "nvidia_smi": smi, "ranks": 4,
          "mesh": "data=2,model=2", "backend": r0.get("backend"),
          "note": "four ranks share one card over gloo (every collective "
                  "copied through the host): correctness, the collectives "
                  "and the kernels at per-rank shapes, not a speed",
          "logits_tol": TP2D_LOGITS_TOL, "compare": r0.get("compare"),
          "decode_bytes_moved": {
              mode: {b: bytes_moved(g["collectives"])
                     for b, g in r0[mode]["groups"].items()}
              for mode in TP2D_MODES} if r0 else None,
          "per_token_s_four_ranks_one_card": {
              mode: {b: g["per_token_s"]
                     for b, g in r0[mode]["groups"].items()}
              for mode in TP2D_MODES} if r0 else None,
          "peak_bytes": {mode: [r[mode]["peak_bytes"] for r in ranks]
                         for mode in TP2D_MODES} if r0 else None,
          "workers_s": time.perf_counter() - t0})
    if bad:
        raise AssertionError("tp2d: " + "; ".join(bad))
    for name, phase in ((None, "tp2d.nccl"), ("olmoe", "tp2d.moe.nccl"),
                        ("zamba2", "tp2d.ssm.nccl"),
                        ("whisper", "tp2d.family.nccl")):
        nccl = tp2d_nccl(out_dir, name)
        emit({"phase": phase, **nccl})
        if not (nccl["graphed"]
                and nccl["cells_bit_equal"] == nccl["cells_checked"]
                and nccl["cells_checked"] and nccl["group_tokens_equal"]
                and nccl["group_logits_equal"]
                and nccl["decode_collectives"] == nccl["contract"]):
            raise AssertionError(f"{phase}: {nccl}")
        _free("cuda")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "tp2d", "seconds": time.perf_counter() - t_phase})
    launches = {f"tp2d.rank{r['rank']}.{mode}": r[mode]["launches"]
                for r in ranks for mode in TP2D_MODES}
    load = {f"tp2d.rank{r['rank']}.{mode}.load": r[mode]["load"]["launches"]
            for r in ranks for mode in TP2D_MODES}
    for name, spec in TP2D_MOE.items():
        for mode in spec["modes"]:
            for r in ranks:
                m = r["moe"][name][mode]
                path = f"tp2d.moe.{name}.{mode}.rank{r['rank']}"
                launches[path] = m["launches"]
                load[f"{path}.load"] = m["load"]["launches"]
    for key, paths in (("ssm", TP2D_SSM), ("family", TP2D_FAMILIES)):
        for name, spec in paths.items():
            for mode in spec["modes"]:
                for r in ranks:
                    m = r[key][name][mode]
                    path = f"tp2d.{key}.{name}.{mode}.rank{r['rank']}"
                    launches[path] = m["launches"]
                    load[f"{path}.load"] = m["load"]["launches"]
    return launches, load, shard_cases + [
        c for cases in (*moe_cases.values(), *ssm_cases.values(),
                        *family_cases.values())
        for c in cases]


# ---------------------------------------------------------------------------
# train.dist: sharded training on torch.distributed
# ---------------------------------------------------------------------------

# qwen1.5-4b at its published widths cut to 2 layers, bf16 on fp32
# masters, remat, a global batch of 4 x 512 tokens, 3 steps on each mesh
TRAIN_DIST_CUT = {"num_layers": 2}
TRAIN_DIST_SHAPE = (4, 512, 3)          # global batch, tokens, steps
# mesh -> (data, model, fsdp); two ranks share the one card over gloo
TRAIN_DIST_MESHES = {"dp": (2, 1, False), "fsdp": (2, 1, True),
                     "tp": (1, 2, False)}
# the tests' optimizer (tests/test_torch_dist_train.py): a full-size first
# update, eps 1e-3 keeping it a smooth function of the gradient
TRAIN_DIST_OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-3)
# each mesh against the one-rank step on the card from the same params
# and batches (bf16 compute: the ranks round partial sums, TP's
# activations and DP's gradients, to bf16 before they are summed), set
# before the first card run (PERF.md, PR 28): the step-0 loss and
# grad_norm within these relative bounds; each piece of m and v (the
# gradient and its square) after the first update within tol x
# max|one-rank leaf| + tol x |one-rank|; each piece of the params within
# tol x lr (both start from the same masters: they differ by lr times
# the difference of the updates, each at most 1 in size at the first
# step)
TRAIN_DIST_TOL = {"loss": 1e-2, "grad_norm": 5e-2, "params": 1.0,
                  "m": 1e-1, "v": 2e-1}
# the checkpoint across meshes, on the reduced qwen at d 1024
# (``TRAIN_RESUME``; bf16): global batch, tokens, steps, the failure
TRAIN_DIST_RESUME_SHAPE = (4, 256, 4, 2)
# train.dist.moe: OLMoE-1B-7B at its published widths (d 2048, 16 heads,
# 64 experts top-8 of d_ff 1024, vocab 50304) cut to 2 layers, bf16 on
# fp32 masters, remat, a global batch of 4 x 256 tokens, 2 steps on each
# of qwen's meshes (``TRAIN_DIST_MESHES``; model=2 splits the experts: 32
# a rank); each mesh's first update against the one-rank step routed as
# the mesh routed (``moe_layer_routes``)
TRAIN_DIST_MOE_CUT = {"num_layers": 2}
TRAIN_DIST_MOE_SHAPE = (4, 256, 2)      # global batch, tokens, steps
# the step-0 aux loss (the global batch's) against the one-rank step's,
# relative, set before the first card run with the other bounds
TRAIN_DIST_AUX_TOL = 1e-2
# the planted controls, each one step on its mesh from fresh params
# against the same one-rank step: the aux taken over the rank's tokens
# (the rule before the global aux) on data=2, the *f* before the routed
# experts skipped on model=2
TRAIN_DIST_MOE_FAULTS = {"dp": "local_aux", "tp": "routed_f"}


def train_dist_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("qwen1_5_4b"), **TRAIN_DIST_CUT)


def train_dist_contract(cfg, data: int, model: int, fsdp: bool,
                        rows: int, seq: int) -> dict:
    """One step's collectives on a rank (one micro-slice), from the shapes:
    TP over ``model`` (a group of one included): all-reduces of the (rows,
    seq, d_model) activations after the lookup and ``wo`` (1 + 1 a layer),
    remat's recompute of ``wo``'s (1 a layer after the leading dense
    ones: the recompute stops at a layer's last saved tensor), *f*'s
    backward at the attention's input (GQA: q/k/v, 1 a layer; MLA: at
    ``cq``, ``c_kv`` and ``k_rope``, their low-rank widths) and at the head
    (1), and one all-gather of the (rows, seq, vocab) logits; a dense
    MLP's ``w_down`` all-reduce and *f* at w_gate/w_up; an MoE layer's
    all-gather of the (tokens, E) fp32 router logits where the router
    splits and, where ``data`` > 1, the data group's all-reduce of its E
    fp32 expert counts (both run again by the recompute), the one fp32
    all-reduce of its partial output where its routed or shared experts
    split, and *f*'s backward before each split consumer (the router,
    the routed experts, the shared experts: activations; the combine's
    (tokens, k) fp32 weights where the routed experts split); where
    ``data`` > 1, an all-reduce of the loss's sum and count (8 B; 12 B
    with an MoE model's aux share), each FSDP leaf's shard all-gathered
    and its gradient reduce-scattered, every other leaf's gradient
    all-reduced (in the compute dtype: bf16, fp32 for 1-D leaves); the
    global norm's 4 B over the world."""
    from repro_torch.analysis.collectives import collective_bytes
    from repro_torch.models.param import (MetaGenerator, torch_dtype,
                                          tree_leaves)
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import (Mesh, ShardingOptions,
                                            local_shape, param_pspecs,
                                            pspec_for, spec_leaves)
    mesh = Mesh.of((data, model), ("data", "model"))
    opts = ShardingOptions(fsdp=fsdp)
    params, axes = build_model(cfg).init(MetaGenerator())
    specs = spec_leaves(param_pspecs(axes, params, mesh, opts))
    item = torch_dtype(cfg.dtype).itemsize
    tok = rows * seq
    d, e = cfg.d_model, cfg.num_experts
    act = tok * d * item

    def split(names, shape):
        return "model" in pspec_for(names, shape, mesh, opts)

    moe = {}
    if e:
        moe = {"router": split(("embed", "experts"), (d, e)),
               "routed": split(("experts", "embed", "mlp"),
                               (e, d, cfg.d_ff_expert)),
               "shared": bool(cfg.num_shared_experts) and split(
                   ("embed", "mlp"),
                   (d, cfg.d_ff_expert * cfg.num_shared_experts))}
    attn_f = ([tok * w * item for w in (cfg.q_lora_rank, cfg.kv_lora_rank,
                                        cfg.rope_head_dim)]
              if cfg.use_mla else [act])
    rec = []
    leaves = []
    for t, sp in zip(tree_leaves(params), specs):
        size = math.prod(local_shape(tuple(t.shape), sp, mesh))
        leaves.append((size * (item if t.ndim >= 2 else 4),
                       fsdp and data > 1 and "data" in sp))
    rec += [("all-gather", b * data, data) for b, f in leaves if f]
    rec += [("all-reduce", act, model)] * 2                # lookup, head f
    rec.append(("all-gather", tok * cfg.vocab_size * item, model))
    for i in range(cfg.num_layers):
        runs = 1 if i < cfg.first_k_dense else 2           # remat
        rec += [("all-reduce", act, model)] * runs         # wo
        rec += [("all-reduce", b, model) for b in attn_f]
        if not e or i < cfg.first_k_dense:
            rec += [("all-reduce", act, model)] * 2        # w_down, f
            continue
        if moe["router"]:
            rec += [("all-gather", tok * e * 4, model)] * runs
        if data > 1:
            rec += [("all-reduce", e * 4, data)] * runs
        if moe["routed"] or moe["shared"]:
            rec.append(("all-reduce", tok * d * 4, model))
        rec += [("all-reduce", act, model)] * sum(moe.values())
        if moe["routed"]:
            rec.append(("all-reduce", tok * cfg.experts_per_token * 4,
                        model))
    if data > 1:
        rec.append(("all-reduce", 12 if e else 8, data))
        rec += [("reduce-scatter" if f else "all-reduce", b, data)
                for b, f in leaves]
    rec.append(("all-reduce", 4, data * model))
    return collective_bytes([{"op": o, "bytes": b, "group_size": n}
                             for o, b, n in rec])


def _train_dist_trees(state) -> dict:
    from repro_torch.models.param import tree_leaves
    return {"params": tree_leaves(state["params"]),
            "m": tree_leaves(state["opt"]["m"]),
            "v": tree_leaves(state["opt"]["v"])}


def _train_dist_compare(got: dict, want: dict, specs: list, mesh,
                        keys=("params", "m", "v")) -> dict:
    """This rank's pieces ``got`` (``_train_dist_trees`` of a mesh
    state) against its pieces of the one-rank state's whole leaves
    ``want`` (either side pinned on the host: a leaf at a time on the
    card): per tree, the worst |err| / bound and whether every element is
    within ``TRAIN_DIST_TOL``."""
    import torch
    from repro_torch.sharding.rules import local_shard
    t0 = time.perf_counter()
    out = {}
    for key in keys:
        tol, worst, ok = TRAIN_DIST_TOL[key], 0.0, True
        for a, w, sp in zip(got[key], want[key], specs):
            a = a.to(mesh.device)
            w = local_shard(w.to(mesh.device), sp, mesh, mesh.coords)
            err = (a.float() - w).abs()
            if key == "params":
                bound = torch.full_like(w, tol * TRAIN_DIST_OPT["lr"])
            else:
                bound = tol * float(w.abs().max()) + tol * w.abs()
            worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
            ok = (ok and bool(torch.all(err <= bound))
                  and bool(torch.all(a.isfinite())))
            del w, err, bound
        out[key] = {"worst_err_over_bound": worst, "within": ok}
    out["seconds"] = time.perf_counter() - t0
    return out


def _train_dist_params(model, device):
    """The phase's seeded params (bf16, full), drawn anew where needed:
    the same draw on every rank and in every call."""
    import torch
    return model.init(torch.Generator(device=device).manual_seed(0))[0]


def _train_dist_reference(cfg, model, ocfg, shape, device) -> dict:
    """The one-rank train step on the card: its loss and grad_norm, and
    the state after the update, kept on the host."""
    import torch
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.train.step import init_train_state, make_train_step
    state = init_train_state(model, ocfg,
                             params=_train_dist_params(model, device))
    batch = SyntheticData(cfg, shape, seed=0, device=device).batch(0)
    state, met = make_train_step(model, ocfg)(state, batch)
    pin = device.type == "cuda"
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "snapshot": {k: [torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=pin).copy_(t)
                             for t in v]
                         for k, v in _train_dist_trees(state).items()}}


def _train_dist_mesh(name, mesh, cfg, model, ocfg, shape, ref, res) -> None:
    """One mesh's run: 3 steps timed with their collectives, the first
    update compared with the one-rank snapshot."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.kernels import cuda
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import (ShardingOptions, local_params,
                                            spec_leaves)
    from repro_torch.train import loop
    from repro_torch.train.step import init_train_state, make_train_step
    t_mesh = time.perf_counter()
    d, m, fsdp = TRAIN_DIST_MESHES[name]
    opts = ShardingOptions(fsdp=fsdp)
    full, specs, _ = train_state_specs(model, ocfg, mesh, opts)
    state = init_train_state(model, ocfg, params=local_params(
        _train_dist_params(model, mesh.device), specs["params"],
        full["params"], mesh))
    data = SyntheticData(cfg, shape, seed=0, device=mesh.device, mesh=mesh,
                         batch_spec=loop._batch_spec(mesh, opts))
    step = make_train_step(model, ocfg)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launches()
    rows, compare = [], None
    with sharding_ctx(mesh, opts):
        for i in range(TRAIN_DIST_SHAPE[2]):
            batch = data.batch(i)
            _sync(dev)
            t0 = time.perf_counter()
            with comm.recording() as rec:
                state, met = step(state, batch)
                loss = float(met["loss"])
            dt = time.perf_counter() - t0
            rows.append({"step": i, "loss": loss,
                         "grad_norm": float(met["grad_norm"]), "step_s": dt,
                         "collectives": collective_bytes(rec),
                         "staged": staged_ops(rec),
                         "contract": train_dist_contract(
                             cfg, d, m, fsdp, int(batch["tokens"].shape[0]),
                             shape.seq_len)})
            if i == 0:
                compare = _train_dist_compare(
                    _train_dist_trees(state), ref["snapshot"],
                    spec_leaves(specs["params"]), mesh)
    launches = sum(cuda.launches.values())
    res["meshes"][name] = {
        "mesh": dict(mesh.shape), "fsdp": fsdp, "steps": rows,
        "compare": compare, "hand_written_launches": launches,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "seconds": time.perf_counter() - t_mesh}
    del state


def _train_dist_planted(mesh, cfg, model, ocfg, shape, ref) -> dict:
    """The control: one TP step with *f*'s backward all-reduce skipped
    (``comm._Copy``'s gradient passed through unreduced), its m against
    the one-rank snapshot's."""
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import (ShardingOptions, local_params,
                                            spec_leaves)
    from repro_torch.train import loop
    from repro_torch.train.step import init_train_state, make_train_step
    opts = ShardingOptions()
    full, specs, _ = train_state_specs(model, ocfg, mesh, opts)
    state = init_train_state(model, ocfg, params=local_params(
        _train_dist_params(model, mesh.device), specs["params"],
        full["params"], mesh))
    data = SyntheticData(cfg, shape, seed=0, device=mesh.device, mesh=mesh,
                         batch_spec=loop._batch_spec(mesh, opts))
    sound, calls = comm._Copy.backward, [0]

    def unreduced(ctx, g):
        calls[0] += 1
        return g, None

    comm._Copy.backward = staticmethod(unreduced)
    try:
        with sharding_ctx(mesh, opts):
            state, met = make_train_step(model, ocfg)(state, data.batch(0))
    finally:
        comm._Copy.backward = staticmethod(sound)
    out = _train_dist_compare(_train_dist_trees(state), ref["snapshot"],
                              spec_leaves(specs["params"]), mesh, keys=("m",))
    return {"f_backward_calls": calls[0], "loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]), **out["m"]}


def _train_dist_resume(out_dir, device, res) -> None:
    """A checkpoint saved at data=2 with FSDP (the run fails after step
    2 of 4) restores at model=2 and, on rank 0 alone, on one rank; both
    continue, against an uninterrupted one-rank run's losses."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding.rules import ShardingOptions
    from repro_torch.train.loop import LoopConfig, SimulatedFailure, run
    import torch
    cfg = get_config("qwen1_5_4b").reduced(**TRAIN_RESUME)
    model = build_model(cfg)
    b, s, total, fail_at = TRAIN_DIST_RESUME_SHAPE
    shape = ShapeSpec("train.dist.resume", s, b, "train")
    ocfg = OptConfig(**TRAIN_DIST_OPT)
    params = model.init(torch.Generator(device=device).manual_seed(1))[0]
    rank = int(os.environ.get("RANK", 0))
    t0 = time.perf_counter()

    def lcfg(name):
        return LoopConfig(total_steps=total, ckpt_every=fail_at,
                          log_every=total, ckpt_dir=os.path.join(out_dir,
                                                                 name))

    out = {"config": cfg.name, "dtype": cfg.dtype, "batch": b, "tokens": s,
           "steps": total, "fail_at": fail_at}
    if rank == 0:
        out["whole"] = run(model, shape, lcfg("whole"), ocfg, device=device,
                           params=params).losses
    mesh = make_mesh((2, 1), ("data", "model"), device=device,
                     verbose=False)
    try:
        run(model, shape, lcfg("a"), ocfg, device=device, params=params,
            mesh=mesh, opts=ShardingOptions(fsdp=True), fail_at=fail_at)
        out["failed"] = None
    except SimulatedFailure as e:
        out["failed"] = e.args[0]
    if rank == 0:
        shutil.copytree(os.path.join(out_dir, "a"),
                        os.path.join(out_dir, "b"))
    mesh = make_mesh((1, 2), ("data", "model"), device=device,
                     verbose=False)
    rep = run(model, shape, lcfg("a"), ocfg, device=device, params=params,
              mesh=mesh)
    out["model2"] = {"resumed_from": rep.resumed_from, "losses": rep.losses}
    if rank == 0:
        rep = run(model, shape, lcfg("b"), ocfg, device=device,
                  params=params)
        out["one_rank"] = {"resumed_from": rep.resumed_from,
                           "losses": rep.losses}
    out["seconds"] = time.perf_counter() - t0
    res["resume"] = out


def train_dist_moe_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("olmoe_1b_7b"), **TRAIN_DIST_MOE_CUT)


@contextlib.contextmanager
def moe_layer_routes(k: int, replay=None):
    """Each MoE layer's routing while inside, keyed by layer: a train
    step's forward runs the layers in order and remat's recompute calls
    ``moe.route`` again in the backward, in reverse, so a layer is the
    order in which its router (a view of the layer stack, the same object
    in the recompute) is first seen.  Yields ``{"experts": {layer: each
    token's k experts (t, k) on the host, from its first call},
    "flips": {...}}``.  ``replay``: such an ``experts`` record, whose
    experts every call of a layer takes in place of its own top-k (the
    weights from its own probabilities); the layer's own top-k is then
    compared, and ``flips`` counts by layer the tokens whose top-k set
    differs from the replayed one."""
    import torch
    from repro_torch.models import moe
    sound = moe.route
    seen, rec = {}, {"experts": {}, "flips": {}}

    def keyed(router, xf, k_, g, cap, gathered):
        layer = seen.setdefault(router.data_ptr(), len(seen))
        if replay is None:
            out = sound(router, xf, k_, g, cap, gathered)
            top_e = out[1].view(-1, k_)
        else:
            out = _routed_as(replay[layer], router, xf, g, cap, gathered)
            top_e = out[1].view(-1, k_)
            own = torch.topk(out[0].detach(), k_, dim=-1)[1]
            rec["flips"].setdefault(layer, int(
                (own.sort(-1).values != top_e.sort(-1).values)
                .any(-1).sum()))
        if layer not in rec["experts"]:
            rec["experts"][layer] = top_e.detach().cpu()
        return out

    moe.route = keyed
    try:
        yield rec
    finally:
        moe.route = sound


def _train_dist_moe_fault(fault: str):
    """(module attribute, its planted form, the calls counted) of one
    ``TRAIN_DIST_MOE_FAULTS`` control."""
    import torch
    from repro_torch.models import moe
    calls = [0]

    def local_aux(probs, flat_e, k, coef):
        calls[0] += 1
        t, e = probs.shape
        ce = torch.zeros((e,), dtype=torch.float32,
                         device=probs.device).index_add_(
            0, flat_e, torch.ones((t * k,), dtype=torch.float32,
                                  device=probs.device)) / (t * k)
        return e * torch.sum(probs.mean(0) * ce) * coef

    def routed_f(xk, routed):
        calls[0] += 1
        return xk

    plant = {"local_aux": ("load_balance_aux", local_aux),
             "routed_f": ("routed_input", routed_f)}[fault]
    return moe, plant[0], plant[1], calls


def _host_trees(state, keys=("params", "m", "v")) -> dict:
    """This rank's pieces of ``state``'s trees, pinned on the host."""
    import torch
    pin = torch.cuda.is_available()
    return {k: [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(t)
                for t in v]
            for k, v in _train_dist_trees(state).items() if k in keys}


def _train_dist_moe_mesh(name, mesh, cfg, model, ocfg, shape) -> dict:
    """One mesh of ``train.dist.moe``: its steps timed with their
    collectives and step 0's routing recorded; the planted control of the
    mesh, if any, one step from fresh params; then the one-rank step on
    the card routed as the mesh routed (every data rank's records in
    global row order, dispatched in the mesh's groups), against which
    each rank compares its pieces after the first update."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes, staged_ops
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.kernels import cuda
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.models import moe
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import (ShardingOptions, local_params,
                                            spec_leaves)
    from repro_torch.train import loop
    from repro_torch.train.step import init_train_state, make_train_step
    t_mesh = time.perf_counter()
    d, m, fsdp = TRAIN_DIST_MESHES[name]
    opts = ShardingOptions(fsdp=fsdp)
    dev = mesh.device
    full, specs, _ = train_state_specs(model, ocfg, mesh, opts)
    p_specs = spec_leaves(specs["params"])
    k = cfg.experts_per_token

    def fresh():
        return init_train_state(model, ocfg, params=local_params(
            _train_dist_params(model, dev), specs["params"], full["params"],
            mesh))

    data = SyntheticData(cfg, shape, seed=0, device=dev, mesh=mesh,
                         batch_spec=loop._batch_spec(mesh, opts))
    state, step = fresh(), make_train_step(model, ocfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launches()
    rows, routes, snap = [], None, None
    with sharding_ctx(mesh, opts):
        for i in range(TRAIN_DIST_MOE_SHAPE[2]):
            batch = data.batch(i)
            _sync(dev)
            t0 = time.perf_counter()
            with comm.recording() as rec, (
                    moe_layer_routes(k) if i == 0
                    else contextlib.nullcontext()) as got:
                state, met = step(state, batch)
                loss = float(met["loss"])
            dt = time.perf_counter() - t0
            if i == 0:
                routes, snap = got["experts"], _host_trees(state)
            rows.append({"step": i, "loss": loss, "aux": float(met["aux"]),
                         "grad_norm": float(met["grad_norm"]), "step_s": dt,
                         "collectives": collective_bytes(rec),
                         "staged": staged_ops(rec),
                         "contract": train_dist_contract(
                             cfg, d, m, fsdp, int(batch["tokens"].shape[0]),
                             shape.seq_len)})
    launches = sum(cuda.launches.values())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    del state
    _free(dev.type)
    planted = None
    fault = TRAIN_DIST_MOE_FAULTS.get(name)
    if fault:
        mod, attr, plant, calls = _train_dist_moe_fault(fault)
        sound = getattr(mod, attr)
        state = fresh()
        setattr(mod, attr, plant)
        try:
            with sharding_ctx(mesh, opts):
                state, met = step(state, data.batch(0))
        finally:
            setattr(mod, attr, sound)
        planted = {"fault": fault, "calls": calls[0],
                   "loss": float(met["loss"]), "aux": float(met["aux"]),
                   "grad_norm": float(met["grad_norm"]),
                   "snapshot": _host_trees(state, ("m",))}
        del state
        _free(dev.type)
    # every data rank's routing, in global row order
    if d > 1:
        routes = {layer: comm.all_gather(e, mesh.group("data"), dim=0)
                  for layer, e in sorted(routes.items())}
    t_one = time.perf_counter()
    sound_groups = moe.moe_groups
    moe.moe_groups = (lambda t: d if d > 1 and t % d == 0 and t >= d
                      else 1)
    try:
        one = init_train_state(model, ocfg,
                               params=_train_dist_params(model, dev))
        batch = SyntheticData(cfg, shape, seed=0, device=dev).batch(0)
        with moe_layer_routes(k, replay=routes) as own:
            one, met1 = make_train_step(model, ocfg)(one, batch)
    finally:
        moe.moe_groups = sound_groups
    ref = {"loss": float(met1["loss"]), "aux": float(met1["aux"]),
           "grad_norm": float(met1["grad_norm"]),
           "seconds": time.perf_counter() - t_one}
    want = _train_dist_trees(one)
    compare = _train_dist_compare(snap, want, p_specs, mesh)
    del snap
    if planted is not None:
        planted.update(_train_dist_compare(
            planted.pop("snapshot"), want, p_specs, mesh, keys=("m",))["m"])
        planted["aux_err_over_bound"] = abs(planted["aux"] - ref["aux"]) / (
            TRAIN_DIST_AUX_TOL * abs(ref["aux"]))
    del one, want
    _free(dev.type)
    t = routes[0].shape[0]
    return {"mesh": dict(mesh.shape), "fsdp": fsdp, "steps": rows,
            "one_rank": ref, "compare": compare, "planted": planted,
            "flips_by_layer": [own["flips"][i] for i in sorted(own["flips"])],
            "flip_frac_by_layer": [own["flips"][i] / t
                                   for i in sorted(own["flips"])],
            "hand_written_launches": launches, "peak_bytes": peak,
            "seconds": time.perf_counter() - t_mesh}


def train_dist_moe(device: str) -> dict:
    """train.dist.moe on this rank: OLMoE-1B-7B on each mesh of
    ``TRAIN_DIST_MESHES``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    cfg = train_dist_moe_cfg()
    model = build_model(cfg)
    ocfg = OptConfig(**TRAIN_DIST_OPT)
    b, s, _ = TRAIN_DIST_MOE_SHAPE
    shape = ShapeSpec("train.dist.moe", s, b, "train")
    out = {}
    for name, (d, m, _) in TRAIN_DIST_MESHES.items():
        out[name] = _train_dist_moe_mesh(
            name, make_mesh((d, m), ("data", "model"), device=device,
                            verbose=False), cfg, model, ocfg, shape)
    return out


def train_dist_moe_checks(rk, moe: dict) -> list:
    """What one rank's ``train.dist.moe`` results break of the contract."""
    bad = []
    for name, r in moe.items():
        s0, ref = r["steps"][0], r["one_rank"]
        for key, tol in (("loss", TRAIN_DIST_TOL["loss"]),
                         ("grad_norm", TRAIN_DIST_TOL["grad_norm"]),
                         ("aux", TRAIN_DIST_AUX_TOL)):
            if not abs(s0[key] - ref[key]) <= tol * abs(ref[key]):
                bad.append(f"rank {rk} moe {name}: step-0 {key} {s0[key]} "
                           f"vs {ref[key]}")
        if not all(c["within"] for k, c in r["compare"].items()
                   if k != "seconds"):
            bad.append(f"rank {rk} moe {name}: leaves {r['compare']}")
        for st in r["steps"]:
            if st["collectives"] != st["contract"] or st["staged"]:
                bad.append(f"rank {rk} moe {name} step {st['step']}: "
                           f"collectives {st['collectives']} != "
                           f"{st['contract']}, staged {st['staged']}")
        if r["hand_written_launches"]:
            bad.append(f"rank {rk} moe {name}: {r['hand_written_launches']} "
                       f"hand-written kernel launches")
        pl = r["planted"]
        if name in TRAIN_DIST_MOE_FAULTS and (
                pl is None or not pl["calls"]
                or (pl["within"] and pl["aux_err_over_bound"] <= 1.0)):
            bad.append(f"rank {rk} moe {name}: the planted fault {pl}")
    return bad


def train_dist_worker(out_dir: str) -> None:
    """One rank of the train.dist phase (``torch.distributed.run``): two
    ranks on the one card over gloo."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.configs.base import ShapeSpec
    job = json.load(open(os.path.join(out_dir, "job.json")))
    device = job["device"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 1), ("data", "model"), device=device)
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device), "meshes": {}}
    try:
        cfg = train_dist_cfg()
        model = build_model(cfg)
        ocfg = OptConfig(**TRAIN_DIST_OPT)
        b, s, _ = TRAIN_DIST_SHAPE
        shape = ShapeSpec("train.dist", s, b, "train")
        # every rank holds the one-rank step's state after its update (on
        # the host), to compare its own pieces with
        t0 = time.perf_counter()
        ref = _train_dist_reference(cfg, model, ocfg, shape, mesh.device)
        res["reference"] = {k: ref[k] for k in ("loss", "grad_norm")}
        res["reference"]["seconds"] = time.perf_counter() - t0
        _free(mesh.device.type)
        for name, (d, m, _) in TRAIN_DIST_MESHES.items():
            _train_dist_mesh(name, make_mesh((d, m), ("data", "model"),
                                             device=device, verbose=False),
                             cfg, model, ocfg, shape, ref, res)
            _free(mesh.device.type)
        res["planted"] = _train_dist_planted(
            make_mesh((1, 2), ("data", "model"), device=device,
                      verbose=False), cfg, model, ocfg, shape, ref)
        del ref
        _free(mesh.device.type)
        t0 = time.perf_counter()
        res["moe"] = train_dist_moe(device)
        res["moe_seconds"] = time.perf_counter() - t0
        _train_dist_resume(out_dir, device, res)
    finally:
        with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(res, f, default=str)
        mesh.close()


def train_dist_nccl(out_dir: str) -> dict:
    """One train step on a ``model=1`` process mesh under NCCL in this
    process (world size 1), against the one-rank step from the same
    params and batch."""
    import torch
    from repro_torch.analysis.collectives import collective_bytes
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import ShardingOptions
    from repro_torch.train.step import init_train_state, make_train_step
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda", rank=0,
                     world_size=1, init_file=os.path.join(out_dir,
                                                          "nccl_store"))
    try:
        cfg = train_dist_cfg()
        model = build_model(cfg)
        ocfg = OptConfig(**TRAIN_DIST_OPT)
        b, s, _ = TRAIN_DIST_SHAPE
        batch = SyntheticData(cfg, ShapeSpec("train.dist.nccl", s, b,
                                             "train"), seed=0,
                              device="cuda").batch(0)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))[0]
        one = make_train_step(model, ocfg)(
            init_train_state(model, ocfg, params=params), batch)[1]
        one = {k: float(one[k]) for k in ("loss", "grad_norm")}
        _free("cuda")
        state = init_train_state(model, ocfg, params=params)
        del params
        with sharding_ctx(mesh, ShardingOptions()), comm.recording() as rec:
            met = make_train_step(model, ocfg)(state, batch)[1]
        del state
        got = {k: float(met[k]) for k in ("loss", "grad_norm")}
        return {"backend": mesh.backend, "one_rank": one, "mesh": got,
                "within": all(abs(got[k] - one[k]) <= TRAIN_DIST_TOL[k]
                              * abs(one[k]) for k in got),
                "collectives": collective_bytes(rec),
                "contract": train_dist_contract(cfg, 1, 1, False, b, s)}
    finally:
        mesh.close()


def train_dist_checks(ranks: list) -> list:
    """What the two ranks' results break of the phase's contract."""
    bad = []
    for res in ranks:
        rk = res.get("rank")
        if res.get("backend") != "gloo":
            bad.append(f"rank {rk}: backend {res.get('backend')}")
        ref = res["reference"]
        for name, r in res["meshes"].items():
            s0 = r["steps"][0]
            for key in ("loss", "grad_norm"):
                want = ref[key]
                if not abs(s0[key] - want) <= TRAIN_DIST_TOL[key] * abs(want):
                    bad.append(f"rank {rk} {name}: step-0 {key} {s0[key]} "
                               f"vs {want}")
            if not all(c["within"] for k, c in r["compare"].items()
                       if k != "seconds"):
                bad.append(f"rank {rk} {name}: leaves {r['compare']}")
            for st in r["steps"]:
                if st["collectives"] != st["contract"] or st["staged"]:
                    bad.append(f"rank {rk} {name} step {st['step']}: "
                               f"collectives {st['collectives']} != "
                               f"{st['contract']}, staged {st['staged']}")
            if r["hand_written_launches"]:
                bad.append(f"rank {rk} {name}: {r['hand_written_launches']} "
                           f"hand-written kernel launches")
        pl = res["planted"]
        if not pl["f_backward_calls"] or pl["within"]:
            bad.append(f"rank {rk}: the planted fault {pl}")
        bad += train_dist_moe_checks(rk, res["moe"])
        rs = res["resume"]
        want = ranks[0]["resume"]["whole"][rs["fail_at"]:]
        runs = [rs["model2"]] + ([rs["one_rank"]] if "one_rank" in rs
                                 else [])
        if rs["failed"] != rs["fail_at"]:
            bad.append(f"rank {rk}: resume: failed at {rs['failed']}")
        for r in runs:
            if r["resumed_from"] != rs["fail_at"] or len(r["losses"]) != \
                    len(want) or not all(
                        abs(a - w) <= TRAIN_DIST_TOL["loss"] * abs(w)
                        for a, w in zip(r["losses"], want)):
                bad.append(f"rank {rk}: resume {r} vs {want}")
    return bad


def phase_train_dist(device="cuda"):
    """Sharded training on the card: two ranks (``torch.distributed.run``)
    sharing it over gloo train qwen1.5-4b (full width, 2 layers, bf16) on
    data=2, data=2 with FSDP and model=2, each against the one-rank step;
    the planted *f* fault; the checkpoint across meshes; then NCCL at
    world size 1 in this process."""
    import signal
    t_phase = time.perf_counter()
    _free(device)
    out_dir = tempfile.mkdtemp(prefix="train-dist-",
                               dir=os.path.join(ROOT, "build"))
    with open(os.path.join(out_dir, "job.json"), "w") as f:
        json.dump({"device": device}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", os.path.abspath(__file__),
         "--train-dist-worker", out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    ranks = []
    for r in range(2):
        path = os.path.join(out_dir, f"rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    if proc.returncode != 0:
        raise AssertionError(f"train.dist: the ranks exited "
                             f"{proc.returncode}:\n{out[-3000:]}\n"
                             f"{err[-6000:]}")
    workers_s = time.perf_counter() - t_phase
    bad = train_dist_checks(ranks)
    for res in ranks:
        emit({"phase": "train.dist.rank", "rank": res["rank"],
              "device": res["device"], "reference": res["reference"],
              "meshes": {n: {"mesh": r["mesh"], "fsdp": r["fsdp"],
                             "peak_bytes": r["peak_bytes"],
                             "step_s": [s["step_s"] for s in r["steps"]],
                             "losses": [s["loss"] for s in r["steps"]],
                             "grad_norm_step0": r["steps"][0]["grad_norm"],
                             "collectives": r["steps"][-1]["collectives"],
                             "compare": r["compare"],
                             "seconds": r["seconds"],
                             "hand_written_launches":
                                 r["hand_written_launches"]}
                         for n, r in res["meshes"].items()},
              "planted": res["planted"], "resume": res["resume"]})
        for n, r in res["moe"].items():
            emit({"phase": "train.dist.moe", "rank": res["rank"], "path": n,
                  "mesh": r["mesh"], "fsdp": r["fsdp"],
                  "peak_bytes": r["peak_bytes"],
                  "step_s": [s["step_s"] for s in r["steps"]],
                  "losses": [s["loss"] for s in r["steps"]],
                  "aux": [s["aux"] for s in r["steps"]],
                  "grad_norm_step0": r["steps"][0]["grad_norm"],
                  "one_rank": r["one_rank"],
                  "flips_by_layer": r["flips_by_layer"],
                  "flip_frac_by_layer": r["flip_frac_by_layer"],
                  "collectives": r["steps"][-1]["collectives"],
                  "contract_held": all(s["collectives"] == s["contract"]
                                       for s in r["steps"]),
                  "compare": r["compare"], "planted": r["planted"],
                  "seconds": r["seconds"],
                  "hand_written_launches": r["hand_written_launches"]})
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if device == "cuda" else None)
    mcfg = train_dist_moe_cfg()
    emit({"phase": "train.dist.moe", "nvidia_smi": smi, "ranks": 2,
          "config": mcfg.name, "d_model": mcfg.d_model,
          "experts": mcfg.num_experts, "top_k": mcfg.experts_per_token,
          "d_ff_expert": mcfg.d_ff_expert, "vocab": mcfg.vocab_size,
          "cut": TRAIN_DIST_MOE_CUT, "dtype": mcfg.dtype,
          "remat": mcfg.remat, "shape": TRAIN_DIST_MOE_SHAPE,
          "aux_tol": TRAIN_DIST_AUX_TOL,
          "seconds": [r.get("moe_seconds") for r in ranks]})
    cfg = train_dist_cfg()
    emit({"phase": "train.dist", "nvidia_smi": smi, "ranks": 2,
          "backend": ranks[0]["backend"], "config": cfg.name,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "cut": TRAIN_DIST_CUT, "dtype": cfg.dtype, "remat": cfg.remat,
          "shape": TRAIN_DIST_SHAPE, "tol": TRAIN_DIST_TOL,
          "note": "two ranks share one card over gloo: correctness and the "
                  "collectives, not a speed",
          "workers_s": workers_s})
    if bad:
        raise AssertionError("train.dist: " + "; ".join(bad))
    if device == "cuda":
        nccl = train_dist_nccl(out_dir)
        emit({"phase": "train.dist.nccl", **nccl})
        if not (nccl["backend"] == "nccl" and nccl["within"]
                and nccl["collectives"] == nccl["contract"]):
            raise AssertionError(f"train.dist.nccl: {nccl}")
    shutil.rmtree(out_dir, ignore_errors=True)
    _free(device)
    emit({"phase": "train.dist", "seconds": time.perf_counter() - t_phase})


def shape_of(case: dict) -> dict:
    """The shape fields of a kernels case, and its mode."""
    return {**{k: case[k] for k in ("L", "m", "M", "K", "N", "bm", "bk", "bn",
                                    "padded_cols", "B", "S", "H", "KH", "D")
               if k in case},
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
        if sys.argv[1:] == ["--phase", "tp"]:
            phase_build()         # the ranks load the built kernels
            phase_tp()
        elif sys.argv[1:] == ["--phase", "tp2d"]:
            phase_build()
            phase_tp2d()
        elif sys.argv[1:] == ["--phase", "train.dist"]:
            phase_train_dist()    # no hand-written kernel on the path
        else:
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
    phase_train()
    tp_launches, tp_load, tp_paper_launches, tp_cases = phase_tp()
    tp2d_launches, tp2d_load, tp2d_cases = phase_tp2d()
    phase_train_dist()
    by_path.update(tp_launches)
    by_path.update(tp_paper_launches)
    by_path.update(tp2d_launches)
    for c in tp_cases + tp2d_cases:
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0),
                                 c["max_abs_err"])

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
        **{p: ls.get("pack_blocks", 0) for p, ls in tp_load.items()},
        **{p: ls.get("pack_blocks", 0) for p, ls in tp2d_load.items()},
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
    flash_paths = {(80, 2048, 32): "serve.zamba2",
                   (64, 256, 8): "serve.whisper",
                   (128, 3072, 32): "serve.llava"}
    flash["cases"] = [
        {**shape_of(c),
         "launches_path": flash_paths[(c["D"], c["S"], c["H"])],
         "launches": by_path[flash_paths[(c["D"], c["S"], c["H"])]].get(
             "flash_attention", 0),
         **{k: c[k] for k in ("design", "max_abs_err", "ms", "device_ms",
                              "plain_ms", "library_ms", "bound_ms",
                              "bound_by")}}
        for c in cases if c["kernel"] == "flash_attention"
        and (c["D"], c["S"], c["H"]) in flash_paths]
    if (len(flash["cases"]) != len(flash_paths)
            or not all(c["launches"] for c in flash["cases"])):
        raise AssertionError(f"flash at D = 80 / 64 / 128 x 3072: "
                             f"{flash['cases']}")
    # and each tp.family path's flash on one rank's heads, with its
    # launches on each rank's main path
    fam_flash = {(s, h, d): name
                 for name, (_, s, h, _, d) in TP_FAMILY_FLASH.items()}
    flash["tp_family"] = [
        {**shape_of(c), "launches_by_path": {
            p: ls.get("flash_attention", 0) for p, ls in by_path.items()
            if p.startswith((f"tp.family.{fam_flash[(c['S'], c['H'], c['D'])]}.",
                             f"tp2d.family.{fam_flash[(c['S'], c['H'], c['D'])]}."))},
         **{k: c[k] for k in ("design", "max_abs_err", "ms", "device_ms",
                              "plain_ms", "library_ms", "bound_ms",
                              "bound_by")}}
        for c in cases if c["kernel"] == "flash_attention"
        and (c["S"], c["H"], c["D"]) in fam_flash]
    if (len(flash["tp_family"]) != len(fam_flash) or not all(
            any(c["launches_by_path"].values()) for c in flash["tp_family"])):
        raise AssertionError(f"flash on the tp.family ranks' heads: "
                             f"{flash['tp_family']}")
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
    # the skinny rows and the pack row also carry the tp path's per-shard
    # cases, each with its kernel's launches on each rank's main path (the
    # pack's at each rank's load)
    for r in line:
        if r["name"] not in SKINNY and r["name"] != "pack_blocks":
            continue
        paths = (tp_load if r["name"] == "pack_blocks" else tp_launches)
        r["tp"] = [
            {**shape_of(c), "leaf": c["tp_leaf"],
             "launches_by_path": {p: ls.get(r["name"], 0)
                                  for p, ls in paths.items()},
             **{k: c[k] for k in ("design", "max_abs_err", "ms",
                                  "device_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}}
            for c in tp_cases if c["kernel"] == r["name"]]
        # and the tp2d path's per-rank cases (2D pieces and FSDP's gathered
        # weights), with the launches on each rank's path in each mode
        paths = (tp2d_load if r["name"] == "pack_blocks" else tp2d_launches)
        r["tp2d"] = [
            {**shape_of(c), "leaf": c["tp_leaf"],
             "launches_by_path": {p: ls.get(r["name"], 0)
                                  for p, ls in paths.items()},
             **{k: c[k] for k in ("design", "max_abs_err", "ms",
                                  "device_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}}
            for c in tp2d_cases if c["kernel"] == r["name"]]
    bad = [r["name"] for r in line if r["launches"] == 0]
    if bad:
        raise AssertionError(f"kernels with no launch on a path: {bad}")
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--tp2d-worker"]:
        tp2d_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--train-dist-worker"]:
        train_dist_worker(sys.argv[2])
    else:
        main()
