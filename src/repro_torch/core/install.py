"""Install-time stage CLI — the paper's inner-kernel selector, run once per
card.

    PYTHONPATH=src python -m repro_torch.core.install [--measure]
        [--calibrate] [--check] [--archs a,b] [--iters N] [--shapes N]
        [--max-batch N] [--max-prompt S] [--reduced] [--override k=v,...]
        [--mesh data=2,model=2] [--precompile] [--device cuda|cpu]

The port of the reference package's ``core/install.py``.  It fills the
persistent plan registry with execution plans for every TSMM-shaped
matmul the serving path of the ported models will hit, over the 2D
bucket grid:

* decode: every power-of-two batch bucket (1..max_batch) x each arch's
  projection shapes;
* prefill: every (batch bucket x length bucket) cell's token count
  (``bb * lb``) x the same shapes, and the rows a prefill cell runs
  besides them (:func:`prefill_rows`: a VLM's image embeddings before
  the prompt, an encoder-decoder's encoder over its frames).

An Engine started afterwards on the same shapes makes registry lookups
only.  With ``--measure`` the evaluator times the model-ranked short list
of every problem on ``--device`` (on a CUDA device: the hand-written
kernels, CUDA-event timed; on the CPU: their plain versions), recording
each timing in the persistent measurement cache.  With ``--calibrate`` the
roofline coefficients are least-squares fitted from that cache and the
whole sweep is re-ranked under the fitted model (measured winners are
kept by the registry's provenance guard).  With ``--check`` the sweep
runs against a fresh in-memory registry and fails on any miss, then the
grammar's self-checks (``verify_variants``, ``verify_schedules``) run on
``--device``; any failure exits non-zero.

With ``--precompile`` each model's engine is built at the swept shapes
(seeded random weights) and its whole serving grid captured as CUDA
graphs (``serve/programs.py``); every cell is then replayed once against
its eager run, which must be bit-equal, and the cells, capture seconds
and graph-pool bytes per model are printed.  Unlike the reference's,
this persists nothing: a CUDA graph cannot outlive its process, so a
serving process captures its own grid at load (``launch/serve.py
--precompile``).  On the CPU the cells are eager and the check trivial.

With ``--mesh`` (``data=2,model=2``) every packable leaf's per-shard
problems under that mesh are swept too, keyed by their shard count
(:func:`sharded_serving_shapes`), so a tensor-parallel engine's start is
lookup-only as well (an MoE model's expert stacks never pack; MLA's
``wq_b``, ``wkv_b`` and ``wo`` are swept as a rank's whole heads of
them, its whole ``wq_a`` / ``wkv_a`` at their full shapes).  The mesh is
a description of names and sizes: the install host needs no processes
and no more than one device.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core import registry
from repro_torch.core.autotuner import (make_plan, make_plan_grid,
                                        make_plan_set)
from repro_torch.core.plan import (BucketGrid, Problem, buckets_for, is_tsmm,
                                   length_buckets_for)

# the configurations the port serves
ARCHS = ("qwen1_5_4b", "glm4_9b", "olmoe_1b_7b", "deepseek_v2_236b",
         "mamba2_780m", "zamba2_2_7b", "h2o_danube_1_8b",
         "llava_next_mistral_7b", "whisper_base", "llama3_405b")
# serving batch buckets swept at install time: every power of two up to
# the largest batch
MAX_SERVE_BATCH = 128
SERVE_BUCKETS = buckets_for(MAX_SERVE_BATCH)
# prompt-length buckets swept for the prefill path
MAX_SERVE_PROMPT = 512
SERVE_LENGTHS = length_buckets_for(MAX_SERVE_PROMPT)


def serving_shapes(cfg) -> set:
    """The (k, n) weight shapes the serving path hits for one arch.

    Every shape of the reference's copy, and for MLA also ``wq_b``
    (q_lora_rank, H * (head_dim + rope_head_dim)), ``wkv_a`` (d_model,
    kv_lora_rank + rope_head_dim) and ``wo`` (H * v_head_dim, d_model),
    and for the hybrid's shared block, which reads [x, x0], its
    (2 d_model, H * head_dim), (2 d_model, KH * head_dim) and
    (2 d_model, d_ff) projections: the reference's copy leaves them out,
    and without them an MLA or hybrid engine's packed leaves would miss
    the registry at serve."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = set()
    if h:
        shapes |= {(d, h * hd), (d, kh * hd), (h * hd, d)}
    if cfg.d_ff:
        shapes |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    if cfg.num_experts:
        shapes |= {(d, cfg.d_ff_expert), (cfg.d_ff_expert, d)}
    if cfg.ssm_state:
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        shapes |= {(d, 2 * di + 2 * g * n + cfg.ssm_heads), (di, d)}
    if cfg.use_mla:
        shapes |= {(d, cfg.q_lora_rank), (cfg.kv_lora_rank,
                                          h * (cfg.head_dim + cfg.v_head_dim))}
        dr = cfg.rope_head_dim
        shapes |= {(cfg.q_lora_rank, h * (cfg.head_dim + dr)),
                   (d, cfg.kv_lora_rank + dr), (h * cfg.v_head_dim, d)}
    if cfg.shared_block:
        shapes |= {(2 * d, h * hd), (2 * d, kh * hd), (2 * d, cfg.d_ff)}
    shapes.add((d, cfg.vocab_size))
    return shapes


def sharded_serving_shapes(cfg, mesh, opts=None, buckets=None,
                           lengths: tuple = ()) -> set:
    """Per-shard (k_shard, n_shard, num_shards) of every packable weight
    leaf of the arch under ``mesh``: the pieces a rank packs (the same
    walk, ``serve/engine.py::iter_packable``, over the model's ``meta``
    shapes: nothing is allocated).  A tied model also packs its head
    (``serve/engine.py::tied_head``); an SSM ``w_in`` piece is its
    segments' width (``models/mamba2.py::tp_segments``: Mamba2-780m's
    3352 of 6448 columns at ``model=2``, not 3224).

    With ``buckets``, the (m, k, n, num_shards) problems a sharded
    engine's pre-pack plans and looks up at them
    (``serve/engine.py::shard_problem``): the piece at every bucket,
    except where FSDP (not 2D tensor parallelism) gathers a piece over
    the data axis first, at the rank's compute rows.  Under
    ``ShardingOptions(fsdp=True, serve_2d_tp=True)`` on ``data=2,
    model=2`` a (K, N) leaf with rows on ``data`` gives (bucket, K/2,
    N/2, 4); under ``fsdp=True`` alone (bucket/2, K, N/2, 2); an SSM
    ``w_in`` the same with its segments' width for N/2 (Mamba2-780m's
    (bucket, 768, 3352, 4) and (bucket/2, 1536, 3352, 2)).  And the
    piece of every weight too small to pack (LLaVA's reduced ``wk``) at
    the rank's compute rows, and with ``lengths`` at the rows its prefill
    cells run (:func:`rank_prefill_rows`), where TSMM-shaped: one shard,
    as ``core/linear.py`` looks an unpacked product up, so that lookup
    does not miss.  (A packed piece's prefill rows past the buckets are a
    registry peek, never a miss: ``core/tsmm.py::tsmm_dot``.)"""
    from repro_torch.models.mamba2 import leaf_segments
    from repro_torch.models.param import MetaGenerator
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import (compute_rows, iter_packable,
                                          shard_problem, tied_head)
    from repro_torch.sharding.rules import ShardingOptions, pspec_for

    opts = opts or ShardingOptions()
    shapes, axes = tied_head(*build_model(cfg).init(MetaGenerator()))
    prefill = (rank_prefill_rows(cfg, buckets, lengths, mesh, opts)
               if buckets is not None and lengths else [])
    out = set()
    for path, leaf, (rows, cols, rs, cs) in iter_packable(
            shapes, axes, mesh, opts):
        if rows % rs or cols % cs:
            continue                # prepack_for refuses these outright
        a = axes
        for key in path:
            a = a[key]
        if buckets is None:
            segs = leaf_segments(cfg, a, tuple(leaf.shape), pspec_for(
                a, tuple(leaf.shape), mesh, opts), mesh)
            out.add((rows // rs, sum(b - a_ for a_, b in segs) if segs
                     else cols // cs, rs * cs))
            continue
        ms, k, n, s, _ = shard_problem(a, tuple(leaf.shape), tuple(buckets),
                                       mesh, opts, cfg)
        out |= {(m, k, n, s) for m in ms}
    if buckets is not None:
        # a leaf too small to pack stays unpacked: the rank's products
        # look its piece up at their rows (one shard)
        rows = {compute_rows(b, mesh, opts) for b in buckets} | set(prefill)
        for a, leaf in _unpacked_leaves(shapes, axes, mesh, opts):
            _, k, n, _, _ = shard_problem(a, tuple(leaf.shape), (1,), mesh,
                                          opts, cfg)
            out |= {(m, k, n, 1) for m in rows if is_tsmm(m, k, n)}
    return out


def _unpacked_leaves(shapes, axes, mesh, opts):
    """(axes, leaf) of every weight consumed through ``core/linear.py``
    (``serve/engine.py::PACKABLE``, two or three dims) that the engine
    leaves unpacked on ``mesh``: under ``MIN_ROWS`` x ``MIN_COLS``
    (``packable_divisors``: as LLaVA's (4096, 1024) ``wk`` is not but a
    reduced GQA's narrow ``wk`` is), or a piece no block tiles
    (``core/tsmm.py::blocks_tile``, the rule ``prepack_for`` refuses by:
    DeepSeek-V2's (5120, 576) ``wkv_a``, whose rank's row piece under
    FSDP or 2D tensor parallelism is gathered, or contracted where it
    lies, at every call)."""
    from repro_torch.core.tsmm import blocks_tile
    from repro_torch.serve.engine import PACKABLE, PAD_COLS, packable_divisors

    def walk(p, a, path):
        if isinstance(p, dict):
            for key in p:
                yield from walk(p[key], a[key], path + (key,))
            return
        if not (path[-1] in PACKABLE and 2 <= p.ndim <= 3
                and (p.ndim == 2 or a[0] in ("layers", "groups"))):
            return
        div = packable_divisors(path, a, p, mesh, opts)
        if div is None or not blocks_tile(div[0] // div[2], div[1] // div[3],
                                          path[-1] in PAD_COLS):
            yield a, p

    yield from walk(shapes, axes, ())


def rank_prefill_rows(cfg, buckets: tuple, lengths: tuple, mesh,
                      opts=None) -> list:
    """The rows a rank's prefill cells run through the projections on
    ``mesh``: each grid cell's ``rows * lb`` and the :func:`prefill_rows`
    of its kind (a VLM's ``rows * (num_image_tokens + lb)``, an
    encoder-decoder's ``rows * encoder_seq``), ``rows`` the bucket's
    compute rows on the rank (``serve/engine.py::compute_rows``: its data
    line's piece where a data axis splits the bucket, under FSDP too;
    the whole bucket under 2D tensor parallelism, where every rank
    encodes all of whisper-base's bucket x 1500 frames and runs all of
    LLaVA's bucket x (2880 + prompt) positions)."""
    from repro_torch.serve.engine import compute_rows
    from repro_torch.sharding.rules import ShardingOptions
    opts = opts or ShardingOptions()
    grid = BucketGrid(tuple(buckets), tuple(lengths))
    out = set()
    for bb, lb in grid.cells():
        r = compute_rows(bb, mesh, opts)
        out.add(r * lb)
        out |= set(prefill_rows(cfg, (r,), (lb,)))
    return sorted(out)


def parse_mesh(spec: str):
    """``data=4,model=2`` -> a ``sharding/rules.py::Mesh`` of those axis
    names and sizes: the sharding divisors need nothing else, so the
    sweep runs on any host for any target mesh."""
    from repro_torch.sharding.rules import Mesh
    axes = []
    for part in spec.split(","):
        name, size = part.split("=")
        axes.append((name.strip(), int(size)))
    return Mesh(tuple(axes))


def prefill_rows(cfg, buckets: tuple, lengths: tuple) -> list:
    """The rows a prefill cell runs through the projections besides the
    grid's ``bb * lb`` (which the reference's sweep plans alone): a VLM's
    ``bb * (num_image_tokens + lb)``, the image embeddings going first,
    and an encoder-decoder's ``bb * encoder_seq``, its encoder layers and
    the decoder's cross K/V over the frames.  Empty without ``lengths``
    (a decode-only sweep)."""
    if not lengths:
        return []
    grid = BucketGrid(tuple(buckets), tuple(lengths))
    rows = set()
    if cfg.embeds_input:
        rows |= {bb * (cfg.num_image_tokens + lb) for bb, lb in grid.cells()}
    if cfg.is_encoder_decoder:
        rows |= {bb * cfg.encoder_seq for bb in buckets}
    return sorted(rows)


def serving_problems(cfg, buckets: tuple = SERVE_BUCKETS,
                     lengths: tuple = ()) -> list[Problem]:
    """The (m, k, n) set the serving path hits for one architecture:
    every batch bucket (decode, m = bb) plus, when ``lengths`` is given,
    every grid cell's token count (prefill, m = bb * lb) and the
    :func:`prefill_rows` (a superset of the reference's set)."""
    shapes = sorted(serving_shapes(cfg))
    ms = list(buckets)
    if lengths:
        grid = BucketGrid(tuple(buckets), tuple(lengths))
        ms = sorted(set(ms) | set(grid.token_buckets())
                    | set(prefill_rows(cfg, buckets, lengths)))
    out = []
    for m in ms:
        for (k, n) in shapes:
            if is_tsmm(m, k, n):
                out.append(Problem(m, k, n, cfg.dtype))
    return out


def install_arch(cfg, buckets: tuple = SERVE_BUCKETS, lengths: tuple = (), *,
                 mesh=None, opts=None, measure: bool = False, hw=None,
                 iters: int = 5, limit_shapes: int = 0, force: bool = False,
                 device="cuda") -> int:
    """Sweep one arch's serving shapes over the bucket grid on ``device``.
    Plans land in the in-memory registry; the caller flushes once.  With
    ``mesh`` the per-shard shapes of every packable leaf are swept too
    (keyed by their shard count), so a sharded engine's start is also
    lookup-only.  ``hw``/``force`` drive the calibrated re-rank pass;
    ``limit_shapes`` caps the (k, n) shapes per arch.  Returns the number
    of distinct plans."""
    n_plans = 0
    mm = "wallclock" if measure else None
    shapes = sorted(serving_shapes(cfg))
    shard_rows: dict = {}
    piece_rows: set = set()
    if mesh is not None:
        prefill = set(rank_prefill_rows(cfg, buckets, lengths, mesh, opts)
                      if lengths else ())
        for (m, ks, ns, s) in sharded_serving_shapes(cfg, mesh, opts,
                                                     buckets, lengths):
            if s == 1 and m in prefill:
                piece_rows.add(Problem(m, ks, ns, cfg.dtype))
            elif s > 1 or (ks, ns) not in shapes:
                shard_rows.setdefault((ks, ns, s), set()).add(m)
    if limit_shapes:
        shapes = shapes[:limit_shapes]
    # the rows the decode buckets and the grid's token counts leave out
    # (:func:`prefill_rows`), planned through the serving set
    grid_rows = set(buckets) | (set(BucketGrid(
        tuple(buckets), tuple(lengths)).token_buckets()) if lengths else set())
    extra = [p for p in serving_problems(cfg, buckets, lengths)
             if p.m not in grid_rows and (p.k, p.n) in shapes]
    for (k, n) in shapes:
        pset = make_plan_set(k, n, buckets, cfg.dtype, hw=hw, measure=mm,
                             persist=False, iters=iters, force=force,
                             device=device)
        n_plans += len(pset.plans)
        if lengths:
            grid = BucketGrid(tuple(buckets), tuple(lengths))
            pg = make_plan_grid(k, n, grid, cfg.dtype, hw=hw, measure=mm,
                                persist=False, iters=iters, force=force,
                                device=device)
            # cells sharing a token count share a plan; count distinct
            n_plans += len({p.problem.m for p in pg.plans.values()
                            if p.problem.m not in buckets})
    for p in extra + sorted(piece_rows, key=Problem.key):
        make_plan(p, hw, measure=mm, persist=False, iters=iters, force=force,
                  device=device)
    for (ks, ns, s), ms in sorted(shard_rows.items()):
        pset = make_plan_set(ks, ns, tuple(sorted(ms)), cfg.dtype, hw=hw,
                             measure=mm, persist=False, iters=iters,
                             force=force, device=device, num_shards=s)
        n_plans += len(pset.plans)
    return n_plans + len(extra) + len(piece_rows)


def precompile_arch(cfg, buckets: tuple, lengths: tuple, *, max_len: int,
                    device="cuda") -> dict:
    """Build an engine of ``cfg`` at these shapes on ``device`` (seeded
    random weights), capture its serving grid, and replay every cell once
    against its eager run.  Returns ``{"rows", "checks", "stats"}``; a
    cell that is not bit-equal to its eager run raises.  Nothing is
    persisted (the restart contract of ``serve/programs.py``)."""
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import check_cells, precompile_grid

    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    eng = Engine(model, params, axes, max_len=max_len, buckets=buckets,
                 max_prompt=lengths[-1] if lengths else None, device=device)
    del params
    rows = precompile_grid(model, eng.params, buckets=eng.buckets,
                           lengths=lengths, max_len=max_len,
                           store=eng.programs)
    checks = check_cells(eng.programs)
    bad = [c for c in checks if not c["equal"]]
    if bad:
        raise AssertionError(f"precompile: {len(bad)} cells differ from their "
                             f"eager runs: {bad[:3]}")
    return {"rows": rows, "checks": checks, "stats": eng.programs.stats()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--measure", action="store_true",
                    help="time the short list (evaluator stage; records "
                         "land in the persistent measurement cache and are "
                         "reused across runs)")
    ap.add_argument("--calibrate", action="store_true",
                    help="least-squares fit the roofline coefficients from "
                         "the measurement cache and re-rank the sweep under "
                         "the calibrated model (measured winners are kept)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed iterations per measured candidate")
    ap.add_argument("--shapes", type=int, default=0,
                    help="cap (k, n) serving shapes per arch (0 = all)")
    ap.add_argument("--archs", default="",
                    help=f"comma-separated, of {', '.join(ARCHS)} "
                         f"(default: all)")
    ap.add_argument("--max-batch", type=int, default=MAX_SERVE_BATCH,
                    help="largest serving batch; buckets are powers of two "
                         "up to this")
    ap.add_argument("--max-prompt", type=int, default=MAX_SERVE_PROMPT,
                    help="largest prompt-length bucket for the prefill "
                         "sweep (0 disables the length axis)")
    ap.add_argument("--check", action="store_true",
                    help="verify only: re-run the sweep against the cache "
                         "file with a fresh memory and fail on any registry "
                         "miss, then self-check the kernel grammar on the "
                         "device")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) configs")
    ap.add_argument("--override", default="",
                    help="comma-separated int config overrides, as the "
                         "serving launcher's (with --reduced applied with "
                         "reduced(), else to the published config)")
    ap.add_argument("--mesh", default="",
                    help="target mesh axis sizes, e.g. data=2,model=2: also "
                         "sweeps every packable leaf's per-shard shapes so a "
                         "sharded engine's start is lookup-only (the sweep "
                         "needs no processes)")
    ap.add_argument("--precompile", action="store_true",
                    help="also capture each model's serving grid as CUDA "
                         "graphs and check every cell against its eager run "
                         "(persists nothing: a graph lives in its process)")
    ap.add_argument("--device", default="cuda",
                    help="the device to plan, measure and check on")
    ap.add_argument("--find-db", default="",
                    help="attach a fleet find-db artifact before the sweep: "
                         "sets REPRO_TORCH_FIND_DB so the registry overlays "
                         "the exported plans (--check then validates "
                         "serving coverage against it, not just the local "
                         "cache)")
    args = ap.parse_args(argv)
    if args.find_db:
        from repro_torch.tuning.find_db import attach
        attach(args.find_db)
    import torch

    from repro_torch.core.hw import for_device
    from repro_torch.launch.serve import config_for
    from repro_torch.serve.engine import resolve_device
    device = resolve_device(args.device)
    archs = ([a.strip() for a in args.archs.split(",") if a.strip()]
             or list(ARCHS))
    buckets = buckets_for(args.max_batch)
    lengths = length_buckets_for(args.max_prompt) if args.max_prompt else ()
    mesh = parse_mesh(args.mesh) if args.mesh else None

    def cfg_of(arch):
        return config_for(arch, reduced=args.reduced, override=args.override)

    if args.check:
        registry.clear_memory()

    t0 = time.time()
    n_plans, seconds = 0, {}
    for arch in archs:
        ta = time.time()
        n = install_arch(cfg_of(arch), buckets, lengths, mesh=mesh,
                         measure=args.measure and not args.check,
                         iters=args.iters, limit_shapes=args.shapes,
                         device=device)
        if not args.check:
            registry.flush()   # one write per arch: an interrupted sweep
        n_plans += n           # keeps its work
        seconds[arch] = time.time() - ta
        print(f"{arch:24s} {n:3d} plans  {seconds[arch]:.1f}s")
    result = {"plans": n_plans, "seconds": seconds, "device": str(device)}

    if args.check:
        stats = registry.stats()
        result["stats"] = stats
        if stats["misses"]:
            print(f"CHECK FAILED: {stats['misses']} registry misses — the "
                  f"cache at {registry.cache_path()} does not cover the "
                  f"serving sweep (hits={stats['hits']})")
            sys.exit(1)
        print(f"check ok: {stats['hits']} lookups, all hits "
              f"-> {registry.cache_path()}")
        # the kernel grammar's self-check on the device: an unemittable or
        # numerically broken grammar point or schedule fails the workflow
        # before a tuned registry can point serving at it.  The card runs
        # both dtypes (fp32: the f32 and tf32x3 designs, bf16: wgmma and
        # stream)
        from repro_torch.kernels.variants import (verify_schedules,
                                                  verify_variants)
        rows = []
        for dt in (("float32", "bfloat16") if device.type == "cuda"
                   else ("float32",)):
            rows += [{"check": "variant", "dtype": dt, **r}
                     for r in verify_variants(str(device), dtype=dt)]
            rows += [{"check": "schedule", "dtype": dt, **r}
                     for r in verify_schedules(str(device), dtype=dt)]
        bad = [r for r in rows if not r["ok"]]
        for r in bad:
            print(f"{r['check']} {r['dtype']} {r['spec']:24s} "
                  f"{r.get('schedule', ''):20s} {r['orientation']:9s} "
                  f"FAILED ({r['error']})")
        result["grammar"] = {"rows": len(rows), "failed": len(bad)}
        if bad:
            print(f"CHECK FAILED: {len(bad)}/{len(rows)} grammar points or "
                  f"schedules broken on {device}")
            sys.exit(1)
        print(f"grammar check ok: {len(rows)} (point or schedule) x dtype "
              f"combinations verified on {device}")
        return result

    if args.calibrate:
        from repro_torch.core.evaluator import MIN_FIT_RECORDS, calibrated_hw
        hw_cal = calibrated_hw(for_device(device), device=device)
        n_rec = len(registry.measurements(device))
        result["hw"] = hw_cal
        if not hw_cal.calibrated:
            if n_rec < MIN_FIT_RECORDS:
                print(f"calibrate: only {n_rec} cached measurements "
                      f"(need >= {MIN_FIT_RECORDS}) — skipped; run with "
                      f"--measure first")
            else:
                print(f"calibrate: fit over {n_rec} measurements is "
                      f"degenerate (collinear roofline features) — "
                      f"skipped; measure a more shape-diverse sweep")
        else:
            print(f"calibrated from {n_rec} measurements: "
                  f"eff_hbm={hw_cal.hbm_bw * hw_cal.hbm_efficiency / 1e9:.2f}"
                  f"GB/s (x{hw_cal.hbm_efficiency:.3g}) "
                  f"mxu_eff=x{hw_cal.mxu_efficiency:.3g} "
                  f"grid_overhead={hw_cal.grid_overhead_s:.3g}s")
            for arch in archs:
                install_arch(cfg_of(arch), buckets, lengths, mesh=mesh,
                             hw=hw_cal, force=True, limit_shapes=args.shapes,
                             device=device)
            registry.flush()
            print("re-ranked sweep under the calibrated model "
                  "(measured winners preserved)")

    if args.precompile:
        # the engine cache capacity the grid is captured at (the
        # reference's default)
        max_len = 2 * (lengths[-1] if lengths else 64)
        result["precompile"] = {}
        for arch in archs:
            pre = precompile_arch(cfg_of(arch), buckets, lengths,
                                  max_len=max_len, device=device)
            st = pre["stats"]
            result["precompile"][arch] = st
            print(f"{arch:24s} {st['programs']:3d} cells ({st['captured']} "
                  f"captured, {st['eager']} eager) capture_s="
                  f"{st['capture_s']:.1f} pool_bytes={st['pool_bytes']}, "
                  f"{len(pre['checks'])} bit-equal to their eager runs")
        print("precompiled serving grids: nothing persisted (a CUDA graph "
              "lives in its process; serve with --precompile to capture "
              "at load)")

    print(f"\ninstalled {n_plans} execution plans over buckets {buckets} "
          f"x lengths {lengths or '(none)'} in {time.time() - t0:.1f}s "
          f"on {torch.device(device)} -> {registry.cache_path()}")
    return result


if __name__ == "__main__":
    main()
