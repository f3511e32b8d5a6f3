"""Compile-once serving: the program store, as captured CUDA graphs.

The port of the reference's ``serve/programs.py`` (DESIGN.md §13).  The
engine's grid of cells — per batch bucket one decode step, per (batch
bucket x prompt length) one prefill without and one with a per-row
``pad`` mask, and one ``prefill_row`` (the continuous-batching
scheduler's admission of one request into a row of the bucket's live
cache) — is acquired through a :class:`ProgramStore`.  Where the
reference AOT-compiles each cell into an XLA executable, the port
captures it as one CUDA graph: a replay launches the cell's few thousand
kernels (the same kernels, in the same order, as the eager call) with
one host call, so a decode step no longer waits on Python dispatch.

* **miss** — one warm-up call of the cell on a side stream, then the
  capture (``torch.cuda.graph`` under ``serving_ctx()``).  Every one-time
  host step (kernel attribute calls, launch plans, registry lookups, lazy
  inits) runs in the warm-up, so the capture records launches only.
  A ``prefill_row`` warm-up writes the same cache row, positions and
  ``valid_from`` entry as the replay that follows it, from the same
  inputs: it is idempotent, and nothing is undone.
  ``source='captured'``; with ``capture=False`` nothing is captured and
  the cell runs eagerly (``source='eager'``).
* **memory** — re-acquiring a key returns the held program
  (``source='memory'``).

A graph replays the device addresses it was captured with: the tensor
maps of the TMA kernels are encoded on the host at capture and baked into
the graph.  So every input, output and cache of a cell is a STATIC buffer
that the store owns and hands out (:meth:`ProgramStore.static_batch`,
:meth:`~ProgramStore.static_cache`, :meth:`~ProgramStore.static_tokens`,
:meth:`~ProgramStore.static_scalar` for the admission's row and clock);
the engine copies each group into them, and a program called with any
other buffers raises.  The decode position is a device tensor in the
cache (``models/lm.py``), advanced in place, so one decode graph serves
every step.  All graphs of a store share one memory pool
(``torch.cuda.graph_pool_handle()``): cells never replay concurrently,
and the engine reads (or copies) each output before it replays another
cell, so no live output is overwritten by another graph's scratch.

Keys are structural, as in the reference: the kind, bucket, tokens and a
digest of the arguments' structure (each tensor's shape and dtype, each
``PackedTensor``'s block shape and its ``kernel_specs`` stamps), with the
config, the grammar version, the torch version and the device name.
Values never take part.  A plan that the background tuner commits after
a cell was captured is not seen by that cell (the reference's compiled
programs behave the same); a re-packed weight carries a new stamp and so
a new key.

**Restart contract.**  The reference persists executables on disk, so a
restarted engine traces nothing.  A CUDA graph cannot outlive its
process.  The port's counterpart is to capture the whole grid into the
engine's own store at load (:func:`precompile_grid`; ``install
--precompile``, ``launch/serve.py --precompile``): after that step,
traffic captures nothing.  Nothing is persisted.

**Mesh mode.**  A store of a tensor-parallel engine (``mesh``, a
``launch/mesh.py::ProcessMesh``, and its ``ShardingOptions``) runs every
cell inside the mesh's sharding context, so the model's explicit
collectives (``sharding/context.py``) run in it, and
:func:`mesh_signature` goes into every key.  Its static caches are the
rank's pieces (``cache_init``).  Under NCCL the cells are captured, the
collectives in the graph; gloo's collectives cannot be captured, so a
gloo store runs its cells eagerly and reports ``graphed: false``, and
asking it to capture raises.  Each cell keeps the collective record of
one call (its capture, or its last eager call; ``sharding/comm.py``),
which :meth:`ProgramStore.collectives` turns into the reference's
per-op accounting.

Launch counts: a capture launches nothing, so its launches are counted
into a recorder (``kernels/cuda.py::recording``) and added once per
replay (``cuda.replayed``): counts under graphs equal the eager counts.
There is no fallback: a capture or a replay that fails raises, and
eager cells run only where the caller passes ``capture=False``.  A
ladder demotion inside a cell (``core/tsmm.py``) happens on the host
before any launch, so the cell captures the fallback rung; it is
counted once per capture (by the warm-up) and replays add no count.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import time
from typing import Callable, Optional

import torch

from repro_torch.core.linear import serving_ctx
from repro_torch.core.packing import PackedTensor
from repro_torch.kernels import cuda
from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION
from repro_torch.models.lm import cache_slabs
from repro_torch.resilience import degrade
from repro_torch.sharding import comm
from repro_torch.sharding.context import sharding_ctx

# bump when what a cell captures changes shape
PROGRAM_SCHEMA = 1
KINDS = ("prefill", "decode", "prefill_row")
# the cache entries a decode step reads and rewrites whole: the position
# and an SSM layer's recurrent state (an attention cache's step writes one
# slot, the same one again on a second run, and needs no restore)
RECURRENT = ("pos", "ssm", "conv")


def recurrent_state(cache: dict) -> dict:
    """Copies of the cache entries a decode step advances in place
    (:data:`RECURRENT`), to put back with :func:`restore`."""
    return {k: cache[k].clone() for k in RECURRENT if k in cache}


def restore(cache: dict, state: dict) -> None:
    for k, v in state.items():
        cache[k].copy_(v)


def config_fingerprint(cfg, device: torch.device) -> str:
    """Every config field, the grammar version, the torch version and the
    device name (a graph is captured for one card)."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return (f"{cfg!r}|grammar={GRAMMAR_VERSION}|torch={torch.__version__}"
            f"|device={name}")


def mesh_signature(mesh, opts) -> str:
    """Key component for the mesh: axis names and sizes, the backend (a
    mesh description has none) and every ShardingOptions knob."""
    if mesh is None:
        return "unsharded"
    axes = ",".join(f"{k}={v}" for k, v in dict(mesh.shape).items())
    return f"{axes}|{getattr(mesh, 'backend', 'abstract')}|{opts!r}"


def _describe(x) -> str:
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_describe(x[k])}" for k in sorted(x)) + "}"
    if isinstance(x, (tuple, list)):
        return "(" + ",".join(_describe(v) for v in x) + ")"
    if isinstance(x, PackedTensor):
        stamps = ";".join(f"{e[0]}:{e[1].key()}:{e[2].key()}"
                          for e in x.kernel_specs)
        return (f"P{tuple(x.blocks.shape)}:{x.blocks.dtype}:{x.orig_rows}x"
                f"{x.orig_cols}:[{stamps}]")
    if torch.is_tensor(x):
        return f"T{tuple(x.shape)}:{x.dtype}"
    return type(x).__name__


def tree_digest(tree) -> str:
    """Structure digest of an argument tree: each tensor's shape and dtype,
    each PackedTensor's block shape, logical shape and stamps.  Values
    never take part."""
    return hashlib.sha256(_describe(tree).encode()).hexdigest()


@dataclasses.dataclass
class Program:
    """One serving cell.

    ``fn(*args)`` runs it: a replay of the captured graph (on the static
    buffers it was captured with; other buffers raise), or the eager
    call.  ``cold`` is True the first time this store hands out the key;
    ``source`` says what happened: ``captured``, ``eager`` or ``memory``.
    ``compile_s`` is the acquire cost (warm-up + capture), ``launches``
    the kernel launches of one call (recorded at capture), ``pool_bytes``
    what the capture added to the shared graph pool."""
    kind: str
    key: str
    fn: Callable
    cold: bool
    source: str
    compile_s: float
    bucket: int = 0
    tokens: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    pool_bytes: int = 0
    args: tuple = dataclasses.field(default=(), repr=False)
    # the collectives of one call: recorded at capture, or by the last
    # eager call
    comm: list = dataclasses.field(default_factory=list, repr=False)


class ProgramStore:
    """Serving cells of one model on one device.

    ``capture`` defaults to True on a CUDA device (off a gloo mesh); on
    the CPU cells run eagerly (the CPU has no graphs) and ``capture=True``
    raises, as it does on a gloo mesh.  ``mesh`` / ``opts``: a
    tensor-parallel engine's process mesh and options (the module's "Mesh
    mode"); ``cache_init(bucket, max_len, device)`` builds a static
    cache (default the model's ``init_cache``; a sharded engine's builds
    the rank's piece of it), and ``layout_of(bucket)`` gives the
    ``CacheLayout`` a bucket's cells run in (``Engine.cache_layout``)."""

    def __init__(self, model, *, device, capture: Optional[bool] = None,
                 mesh=None, opts=None, cache_init: Optional[Callable] = None,
                 layout_of: Optional[Callable] = None):
        self.model = model
        self.device = torch.device(device)
        self.mesh, self.opts = mesh, opts
        self._layout_of = layout_of
        gloo = mesh is not None and getattr(mesh, "backend", None) == "gloo"
        if capture is None:
            capture = self.device.type == "cuda" and not gloo
        if capture and (self.device.type != "cuda"
                        or not torch.cuda.is_available()):
            raise RuntimeError(f"CUDA graphs need a CUDA device, not "
                               f"{self.device}; pass capture=False to run "
                               f"the cells eagerly")
        if capture and gloo:
            raise RuntimeError("gloo's collectives cannot be captured in a "
                               "CUDA graph: a gloo mesh's cells run eagerly "
                               "(capture=False); capture needs NCCL")
        self.capture = capture
        self._cache_init = cache_init or model.init_cache
        self._fns = {"prefill": model.prefill, "decode": model.decode_step,
                     "prefill_row": model.prefill_row}
        self._fingerprint = config_fingerprint(model.cfg, self.device)
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self._programs: dict[str, Program] = {}
        self._buffers: dict = {}
        self._stats = {"captured": 0, "eager": 0, "reused": 0,
                       "capture_s": 0.0, "pool_bytes": 0}

    # -- keys ------------------------------------------------------------

    def key_for(self, kind: str, args, *, bucket: int, tokens: int) -> str:
        if kind not in KINDS:
            raise ValueError(f"unknown program kind {kind!r}")
        h = hashlib.sha256(self._fingerprint.encode())
        h.update(f"|{PROGRAM_SCHEMA}|{kind}".encode())
        h.update(mesh_signature(self.mesh, self.opts).encode())
        for a in args:
            h.update(tree_digest(a).encode())
        return f"{kind}_b{bucket}_t{tokens}_{h.hexdigest()[:16]}"

    # -- static buffers --------------------------------------------------
    # plain (not inference-mode) tensors, so a caller may write them in or
    # out of ``torch.inference_mode()``

    @torch.inference_mode(False)
    def static_cache(self, bucket: int, max_len: int) -> dict:
        """The decode cache of ``bucket`` rows and ``max_len`` slots, one
        per (bucket, max_len), kept across groups: a graph replays its
        addresses."""
        key = ("cache", bucket, max_len)
        if key not in self._buffers:
            self._buffers[key] = self._cache_init(bucket, max_len,
                                                  self.device)
        return self._buffers[key]

    @torch.inference_mode(False)
    def static_tokens(self, bucket: int):
        """The decode cell's (bucket, 1) int32 token buffer."""
        key = ("tokens", bucket)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros((bucket, 1), dtype=torch.int32,
                                             device=self.device)
        return self._buffers[key]

    @torch.inference_mode(False)
    def static_scalar(self, name: str):
        """A 0-d int32 input of the ``prefill_row`` cells (``"row"``,
        ``"t_end"``); the caller fills it before a call."""
        key = ("scalar", name)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros((), dtype=torch.int32,
                                             device=self.device)
        return self._buffers[key]

    @torch.inference_mode(False)
    def static_batch(self, batch: dict) -> dict:
        """The prefill cell's input buffers for a batch of ``batch``'s
        structure (keys, shapes, dtypes); the caller copies values in."""
        key = ("batch", tree_digest(batch))
        if key not in self._buffers:
            self._buffers[key] = {k: torch.zeros(v.shape, dtype=v.dtype,
                                                 device=self.device)
                                  for k, v in batch.items()}
        return self._buffers[key]

    # -- acquire ---------------------------------------------------------

    def program(self, kind: str, args, *, bucket: int, tokens: int) -> Program:
        """The cell for ``fn(*args)``: a memory hit, or a capture (an
        eager cell with ``capture=False``).  ``args`` are the static
        buffers (and the params) the cell will be called with."""
        key = self.key_for(kind, args, bucket=bucket, tokens=tokens)
        prog = self._programs.get(key)
        if prog is not None:
            self._stats["reused"] += 1
            return dataclasses.replace(prog, cold=False, source="memory",
                                       compile_s=0.0)
        t0 = time.perf_counter()
        fn = self._fns[kind]
        rec: list = []
        if self.capture:
            run, launches, pool_bytes = self._capture(kind, fn, args, rec,
                                                      bucket)
            source = "captured"
        else:
            run, launches, pool_bytes = self._eager(fn, rec, bucket), {}, 0
            source = "eager"
        dt = time.perf_counter() - t0
        self._stats[source] += 1
        self._stats["capture_s"] += dt
        self._stats["pool_bytes"] += pool_bytes
        prog = Program(kind=kind, key=key, fn=run, cold=True, source=source,
                       compile_s=dt, bucket=bucket, tokens=tokens,
                       launches=launches, pool_bytes=pool_bytes,
                       args=tuple(args), comm=rec)
        self._programs[key] = prog
        return prog

    def context(self, bucket: Optional[int] = None):
        """The mesh's sharding context, with ``bucket``'s cache layout (a
        no-op off a mesh)."""
        layout = (self._layout_of(bucket) if self._layout_of is not None
                  and bucket is not None else None)
        return sharding_ctx(self.mesh, self.opts, layout)

    def _eager(self, fn, rec: list, bucket: int) -> Callable:
        if self.mesh is None:
            def run(*args):
                with torch.inference_mode(), serving_ctx():
                    return fn(*args)
            return run

        def run_on_mesh(*args):
            with torch.inference_mode(), serving_ctx(), \
                    self.context(bucket), comm.recording() as calls:
                out = fn(*args)
            rec[:] = calls
            comm.replayed(calls)
            return out
        return run_on_mesh

    @torch.inference_mode()
    def _capture(self, kind: str, fn, args, comm_rec: list,
                 bucket: int) -> tuple:
        dev = self.device
        main = torch.cuda.current_stream(dev)
        # a decode step advances the cache's position (and an SSM's state)
        # in place: the warm-up's advance is undone, so the capture (and
        # the first replay) decodes the step the cache is at
        state = recurrent_state(args[1]) if kind == "decode" else {}
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), serving_ctx(), self.context(bucket):
            fn(*args)
        main.wait_stream(side)
        restore(args[1], state)
        # what torch.cuda.graph does on entry, done first so the reserved
        # bytes before the capture are read after it: the growth is the
        # shared pool's
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a background tuner timing on its own thread and
        # stream does not invalidate the capture.  A ladder demotion was
        # counted by the warm-up: the capture's pass counts none
        with cuda.recording() as rec, serving_ctx(), self.context(bucket), \
                comm.recording() as calls, \
                degrade.use(degrade.current().capture()), \
                torch.cuda.graph(graph, pool=self.pool,
                                 capture_error_mode="thread_local"):
            out = fn(*args)
        comm_rec[:] = calls
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        return (_replay(graph, tuple(args), out, rec, comm_rec),
                dict(rec[0]), pool_bytes)

    # -- telemetry -------------------------------------------------------

    def stats(self) -> dict:
        out = dict(self._stats)
        out["programs"] = len(self._programs)
        out["graphed"] = bool(self.capture)
        return out

    def collectives(self, prog: Program) -> dict:
        """Per-rank collective accounting of one call of ``prog`` (the
        reference's ``{op: {count, bytes_moved, tensor_bytes}}``): what
        its capture recorded, or its last eager call."""
        from repro_torch.analysis.collectives import collective_bytes
        if (prog.source != "captured" and not prog.comm
                and self.mesh is not None):
            raise ValueError(f"eager cell {prog.key} has not run yet: its "
                             f"collectives are recorded by a call")
        return collective_bytes(prog.comm)

    def report(self) -> list:
        """Per-cell rows (kind, bucket, tokens, key, source, acquire
        seconds, launches per call, pool bytes) — the cold-start tool's
        breakdown."""
        return [{"kind": p.kind, "bucket": p.bucket, "tokens": p.tokens,
                 "key": p.key, "source": p.source, "compile_s": p.compile_s,
                 "launches": sum(p.launches.values()),
                 "pool_bytes": p.pool_bytes}
                for p in self._programs.values()]

    def programs(self) -> list:
        """The held cells (their first acquire's handles)."""
        return list(self._programs.values())


def _replay(graph, args: tuple, out, rec, comm_rec=()) -> Callable:
    def replay(*call):
        if len(call) != len(args) or any(a is not b
                                         for a, b in zip(call, args)):
            raise ValueError("a captured program replays the static buffers "
                             "it was captured with; pass those (the store's "
                             "static_batch / static_cache / static_tokens)")
        graph.replay()
        cuda.replayed(rec)
        if comm_rec:
            comm.replayed(comm_rec)
        return out
    return replay


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def input_dtypes(cfg=None) -> dict:
    """The dtype of each input a prefill batch carries, as the reference
    feeds them: int32 ``tokens`` and ``pad``, and for ``cfg`` bf16
    ``embeds`` (a VLM's image embeddings) and ``enc_frames`` (an
    encoder-decoder's frames)."""
    out = {"tokens": torch.int32, "pad": torch.int32}
    if cfg is not None and cfg.embeds_input:
        out["embeds"] = torch.bfloat16
    if cfg is not None and cfg.is_encoder_decoder:
        out["enc_frames"] = torch.bfloat16
    return out


def prompt_positions(cfg, length: int) -> int:
    """Cache positions a prefill of ``length`` tokens fills: a VLM's
    image embeddings go before its tokens."""
    return length + (cfg.num_image_tokens if cfg.embeds_input else 0)


def batch_template(bucket: int, length: int, *, pad: bool,
                   cfg=None) -> dict:
    """A prefill batch's structure, as the engine feeds it, each input in
    its :func:`input_dtypes` type: tokens (bucket, length), for ragged
    groups ``pad`` (bucket,), and for ``cfg`` ``embeds`` (bucket,
    num_image_tokens, d_model) and ``enc_frames`` (bucket, encoder_seq,
    d_model): a captured prefill cell owns static buffers for them too."""
    shapes = {"tokens": (bucket, length), "pad": (bucket,)}
    if cfg is not None:
        shapes["embeds"] = (bucket, cfg.num_image_tokens, cfg.d_model)
        shapes["enc_frames"] = (bucket, cfg.encoder_seq, cfg.d_model)
    return {k: torch.zeros(shapes[k], dtype=dt)
            for k, dt in input_dtypes(cfg).items() if pad or k != "pad"}


def ragged_supported(model) -> bool:
    """An attention-cache LM fed tokens: ragged groups prefill with pad."""
    cfg = model.cfg
    return (model.prefill_row is not None and not cfg.embeds_input
            and not getattr(cfg, "is_encoder_decoder", False))


def row_args(store: ProgramStore, params, cache, length: int) -> tuple:
    """The static arguments of a ``prefill_row`` cell of ``length``
    tokens on ``cache``: (params, the (1, length) batch with its pad,
    cache, row, t_end)."""
    return (params, store.static_batch(batch_template(1, length, pad=True)),
            cache, store.static_scalar("row"), store.static_scalar("t_end"))


def precompile_grid(model, params, *, buckets, lengths, max_len: int,
                    store: ProgramStore, rows_of: Optional[Callable] = None
                    ) -> list:
    """Acquire every cell a same-shaped engine serves into ``store``: per
    batch bucket one decode step; per (bucket x length) a prefill without
    and (ragged families) with per-row pad masking, and (ragged families)
    the scheduler's one-row admission ``prefill_row`` on that bucket's
    cache, as the reference does.

    ``params`` is the engine's packed param tree (the reference takes the
    logical axes and builds an abstract tree: a graph captures real
    addresses).  ``rows_of(bucket)``: the rows a rank of a data-sharded
    engine computes of a bucket (``Engine.rows_of``; default all); its
    static cache is the store's piece of the bucket's.  Returns the
    per-cell rows."""
    ragged = ragged_supported(model)
    rows = []

    def acquire(kind, args, bucket, tokens):
        prog = store.program(kind, args, bucket=bucket, tokens=tokens)
        rows.append({"kind": kind, "bucket": bucket, "tokens": tokens,
                     "pad": kind == "prefill" and "pad" in args[1],
                     "key": prog.key, "source": prog.source,
                     "compile_s": prog.compile_s})

    with torch.inference_mode():
        for bb in buckets:
            n = rows_of(bb)[0] if rows_of is not None else bb
            cache = store.static_cache(bb, max_len)
            acquire("decode", (params, cache, store.static_tokens(n)), bb, 1)
            for lb in lengths:
                for pad in ((False, True) if ragged else (False,)):
                    batch = store.static_batch(
                        batch_template(n, lb, pad=pad, cfg=model.cfg))
                    acquire("prefill", (params, batch, cache), bb, lb)
                if ragged:
                    # the warm-up admits into row 0 at [0, lb): in range
                    args = row_args(store, params, cache, lb)
                    args[3].fill_(0)
                    args[4].fill_(lb)
                    acquire("prefill_row", args, bb, lb)
    return rows


def _row_views(cfg, cache, row: int, t0: int, t_end: int) -> list:
    """Views of the cache entries a ``prefill_row`` at ``row``,
    ``[t0, t_end)`` writes in every layer's slabs (GQA's k / v, MLA's
    c / kr, the dense layers' ``dense{i}_*``)."""
    return [slab[row, t0:t_end] for pair in cache_slabs(cfg, cache)
            for slab in pair]


def _row_state(cfg, cache, row: int, t0: int, t_end: int) -> list:
    """Copies of what a ``prefill_row`` at ``row``, ``[t0, t_end)``
    writes: its rows of every cache slab, ``valid_from`` and
    ``slot_pos``."""
    return ([v.clone() for v in _row_views(cfg, cache, row, t0, t_end)]
            + [cache["valid_from"].clone(), cache["slot_pos"].clone()])


def check_cells(store: ProgramStore, *, seed: int = 0) -> list:
    """Run every held cell once eagerly and once through its program, on
    its static buffers filled from ``seed`` (random tokens, pads; for a
    ``prefill_row`` a random row and clock), and compare the logits bit
    for bit.  A decode cell runs at the cache's position both times.  A
    ``prefill_row`` cell's written cache row (its entries in every
    layer's slabs, ``valid_from``, ``slot_pos``) is compared too: between
    the two runs it is scrubbed, so the program must write it again.
    A decode cell's recurrent entries (``pos``, an SSM's ``ssm`` and
    ``conv``) are put back before the replay and after it, so both runs
    step from the same state.  Returns one row per cell: key, ``equal``,
    ``max_abs_err``."""
    g = torch.Generator().manual_seed(seed)
    cfg = store.model.cfg
    rows = []

    def randint(lo, hi, shape=()):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    with torch.inference_mode(), serving_ctx():
        for prog in store.programs():
            with store.context(prog.bucket):
                rows.append(_check_cell(store, prog, cfg, randint))
    return rows


def _check_cell(store: ProgramStore, prog, cfg, randint) -> dict:
    """:func:`check_cells` of one cell, in its context."""
    vocab = cfg.vocab_size
    args = prog.args
    fn = store._fns[prog.kind]
    if prog.kind in ("prefill", "prefill_row"):
        batch = args[1]
        toks = batch["tokens"]
        toks.copy_(randint(0, vocab, tuple(toks.shape)))
        if "pad" in batch:
            batch["pad"].copy_(randint(0, toks.shape[1],
                                       tuple(batch["pad"].shape)))
    written = True
    if prog.kind == "prefill":
        want = fn(*args)[0].clone()
        got = prog.fn(*args)[0].clone()
    elif prog.kind == "prefill_row":
        cache = args[2]
        lb = args[1]["tokens"].shape[1]
        bucket = cache["valid_from"].shape[0]
        max_len = cache["slot_pos"].shape[0]
        row = int(randint(0, bucket))
        t_end = int(randint(lb, max_len + 1))
        t0 = t_end - lb
        args[3].fill_(row)
        args[4].fill_(t_end)
        want = fn(*args)[0].clone()
        want_row = _row_state(cfg, cache, row, t0, t_end)
        for v in _row_views(cfg, cache, row, t0, t_end):
            v.zero_()
        cache["valid_from"][row] = -1
        cache["slot_pos"][t0:t_end] = -1
        got = prog.fn(*args)[0].clone()
        written = all(torch.equal(a, b) for a, b in zip(
            _row_state(cfg, cache, row, t0, t_end), want_row))
    else:
        cache, tok = args[1], args[2]
        tok.copy_(randint(0, vocab, tuple(tok.shape)))
        state = recurrent_state(cache)
        want = fn(*args)[0].clone()
        restore(cache, state)
        got = prog.fn(*args)[0].clone()
        restore(cache, state)
    return {"key": prog.key, "kind": prog.kind,
            "equal": bool(torch.equal(got, want)) and written,
            "max_abs_err": float((got.float() - want.float())
                                 .abs().max())}
