"""Ambient sharding context.

The port of the reference's ``sharding/context.py``.  Model code names
the logical axes of an activation (``shard_act(x, "batch", "seq",
"embed")``); the ambient :class:`ShardCtx` (entered by the engine and the
scheduler around their cells) resolves logical names to mesh axes with
the reference's two passes (:meth:`ShardCtx.spec_for`).  Where the
reference then pins the layout with ``with_sharding_constraint`` and
leaves the collectives to GSPMD, the port's activations are already
rank-local, so :func:`shard_act` returns its input, and the collectives
of tensor parallelism run explicitly at their sites: :func:`tp_sum`
after a row-parallel projection (``wo``, ``w_down``) and after the
vocab-sharded token lookup, :func:`tp_gather` of the vocab-sharded
logits.  Where autograd records (training), those two run their
``sharding/comm.py`` forms with gradients, and :func:`tp_copy` (the
identity, its gradient all-reduced) stands at the input of each
column-parallel group: q/k/v, ``w_gate``/``w_up``, the head.  Under
``torch.inference_mode`` (serving) :func:`tp_copy` is the identity and
the others the plain collectives.  With no context set (unit tests,
single-device serving) or on a mesh description without process groups
(the install sweep's), every one of them is a no-op.

Serving under FSDP (``fsdp=True``) or 2D weight-stationary tensor
parallelism (``fsdp=True, serve_2d_tp=True``) adds the data axis's
sites, each answering only inside ``serving_ctx`` (training gathers its
whole tree at step start): :func:`fsdp_split` (the rules put ``data`` on
an ``embed`` dim), :func:`kblocks_split` (a packed weight's row blocks
contracted where they lie, the partial outputs summed over
:func:`dp_group`), :func:`dp_slice` (an activation's K slice for an
unpacked row piece contracted where it lies), :func:`dp_gather_cols`
(an output's ``embed`` columns gathered over ``data`` under 2D),
:func:`dp_weight`, :func:`dp_weight_cols` and :func:`dp_full` (an
unpacked FSDP piece gathered before use).  A
serving cell runs in its bucket's :class:`CacheLayout`
(:func:`cache_layout`): the axis of the cache's rows, whether every
rank computes the whole bucket over a piece of them, and the axis of
its slots.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from repro_torch.sharding.rules import (P, ShardingOptions, axis_size,
                                        pspec_for)

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx",
                                                      default=None)

# logical activation axis -> role
_TP_ACT = {"heads", "kvheads", "mlp", "vocab", "experts", "ssm_inner",
           "ssm_heads"}
_DP_ACT = {"batch"}
_SP_ACT = {"seq"}


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Where one bucket's decode cache lies against the rows a rank
    computes (``Engine.cache_layout``, from ``cache_pspecs``):

    * ``rows``: the axis the cache's rows are split over (each rank of
      its line holds ``rows / n`` of them), or None;
    * ``gathered``: every rank computes the whole bucket while its cache
      holds a piece of the rows (2D tensor parallelism): a decode step
      attends over its rows and gathers the attention output over
      ``rows``;
    * ``seq``: the axis the cache's slots are split over (each rank holds
      ``slots / n`` of them, and the softmax is combined over its line),
      or None."""
    rows: Optional[str] = None
    gathered: bool = False
    seq: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: object
    opts: ShardingOptions
    layout: Optional[CacheLayout] = None

    def spec_for(self, names: tuple, shape: tuple) -> P:
        assign: list = [None] * len(names)
        used: set = set()

        def try_assign(i, cand, dim):
            cand = tuple(a for a in cand if a not in used)
            if not cand:
                return
            n = axis_size(self.mesh, cand)
            if n > 1 and dim % n == 0 and dim >= n:
                assign[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)

        dp_axes = tuple(a for a in self.opts.dp_axes if a in self.mesh.shape)
        # pass 1: primary assignments (batch -> dp, tp-logical -> model)
        for i, (name, dim) in enumerate(zip(names, shape)):
            if name == "cache_batch":
                try_assign(i, dp_axes, dim)        # caches always dp-shard
                if assign[i] is None:              # multi-pod: axis subsets
                    for a in dp_axes:
                        try_assign(i, (a,), dim)
            elif name == "kblocks" and self.opts.serve_2d_tp:
                try_assign(i, dp_axes, dim)        # 2D-TP contraction dim
                if assign[i] is None:
                    for a in dp_axes:
                        try_assign(i, (a,), dim)
            elif name in _DP_ACT:
                if not self.opts.serve_2d_tp:      # 2D-TP: batch replicated
                    try_assign(i, dp_axes, dim)
            elif name in _TP_ACT:
                try_assign(i, (self.opts.tp_axis,), dim)
            elif name in _SP_ACT and self.opts.sequence_parallel:
                # 'model' (Megatron-SP: residual/norm activations shard seq
                # over the TP axis) or truthy (the dp axes)
                if self.opts.sequence_parallel == "model":
                    cand = (self.opts.tp_axis,)
                else:
                    cand = tuple(a for a in self.opts.dp_axes
                                 if a in self.mesh.shape)
                try_assign(i, cand, dim)
        # pass 2: cache_seq soaks up whatever is left (model first: the
        # long-KV fallback when kv_heads < tp; then unused dp axes)
        for i, (name, dim) in enumerate(zip(names, shape)):
            if name == "cache_seq" and assign[i] is None:
                try_assign(i, (self.opts.tp_axis,), dim)
                if assign[i] is None:
                    for a in self.opts.dp_axes:
                        if a in self.mesh.shape:
                            try_assign(i, (a,), dim)
        return P(*assign)

    def group(self, axis: str):
        """The process group of the calling rank's line along ``axis``, or
        None on a mesh description (no processes)."""
        fn = getattr(self.mesh, "group", None)
        return fn(axis) if fn is not None else None


@contextlib.contextmanager
def sharding_ctx(mesh, opts: Optional[ShardingOptions] = None,
                 layout: Optional[CacheLayout] = None):
    prev = _CTX.get()
    tok = _CTX.set(ShardCtx(mesh, opts or ShardingOptions(), layout)
                   if mesh is not None else None)
    try:
        yield
    finally:
        try:
            _CTX.reset(tok)
        except ValueError:
            # entered and exited in different asyncio task contexts (the
            # async front end may open the scheduler in a submitter's task
            # and close it in the serve loop's); tokens don't cross task
            # contexts, so restore the captured value directly
            _CTX.set(prev)


def get_ctx() -> Optional[ShardCtx]:
    return _CTX.get()


def shard_act(x, *names: str):
    """The reference's activation constraint: ``x``'s dims carry logical
    ``names``.  A port activation is already rank-local, so ``x`` is
    returned as it is (the names are checked against its rank)."""
    if _CTX.get() is not None:
        assert len(names) == x.ndim, (names, tuple(x.shape))
    return x


def tp_group():
    """The ambient tensor-parallel group, or None (no context, or a mesh
    description)."""
    ctx = _CTX.get()
    return None if ctx is None else ctx.group(ctx.opts.tp_axis)


def tp_split(axis: str, dim: int) -> bool:
    """Whether the rules (``pspec_for``) put the TP axis on a weight dim
    of logical ``axis`` and full size ``dim`` on the ambient process mesh:
    then the rank holds a piece of that dim, and its site's collective
    runs (at a TP size of 1 too, where the rules still assign the axis)."""
    ctx = _CTX.get()
    if ctx is None or ctx.group(ctx.opts.tp_axis) is None:
        return False
    return pspec_for((axis,), (dim,), ctx.mesh,
                     ctx.opts)[0] == ctx.opts.tp_axis


def _records(x) -> bool:
    """Whether autograd records through ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def tp_copy(x, axis: str, dim: int):
    """The input of a column-parallel group whose output dim (logical
    ``axis``, full size ``dim``) is split over the TP group: ``x`` itself
    forward, and where autograd records, its gradient (each rank's
    partial, from its columns) all-reduced backward (Megatron's *f*)."""
    return tp_copy_where(x, tp_split(axis, dim))


def tp_copy_where(x, split: bool):
    """:func:`tp_copy` where the caller knows whether its consumer's
    weight is split over the TP group (``split``; an MoE leaf's layout,
    :func:`tp_leaf_split`)."""
    if not (split and _records(x)):
        return x
    from repro_torch.sharding import comm
    return comm.tp_copy(x, tp_group())


def tp_sum(x, axis: str, dim: int):
    """The partial sums of a row-parallel product whose contraction dim
    (logical ``axis``, full size ``dim``) is split over the TP group,
    summed (``wo`` over the heads, ``w_down`` over ``mlp``, the
    vocab-sharded token lookup): in place under serving, with the
    gradient passed through where autograd records (*g*); ``x`` itself
    where the dim is whole."""
    return tp_sum_where(x, tp_split(axis, dim))


def tp_sum_where(x, split: bool):
    """:func:`tp_sum` where the caller knows whether the contraction is
    split over the TP group (``split``)."""
    if not split:
        return x
    from repro_torch.sharding import comm
    if _records(x):
        return comm.tp_sum(x, tp_group())
    return comm.all_reduce(x, tp_group())


def tp_gather(x, axis: str, dim: int):
    """A tensor whose last dim is this rank's piece of a split dim
    (logical ``axis``, full size ``dim``: the vocab-sharded logits)
    gathered to full width over the TP group (where autograd records, the
    gradient of the rank's piece flows back); ``x`` itself where the dim
    is whole."""
    return tp_gather_where(x, tp_split(axis, dim))


def tp_gather_where(x, split: bool):
    """:func:`tp_gather` where the caller knows whether the last dim is
    split over the TP group (``split``)."""
    if not split:
        return x
    from repro_torch.sharding import comm
    if _records(x):
        return comm.tp_gather(x, tp_group(), dim=-1)
    return comm.all_gather(x, tp_group(), dim=-1)


# the families that serve on every layout: over ``model``, with or
# without a plain data axis, and under FSDP and 2D tensor parallelism
_EVERY_LAYOUT = {"dense", "moe", "ssm", "hybrid", "vlm", "encdec"}
# the families a train step runs on a process mesh
_TRAINED = {"dense", "moe"}


def _ssm_split(cfg, mesh, opts: ShardingOptions, tp: int) -> bool:
    """Whether the rules split the Mamba2 block over the TP axis: its
    ``ssm_inner`` leaves (``w_in``, the conv, ``norm`` / ``w_out``) and
    its ``ssm_heads`` all, or none; split, the heads divide into whole
    heads a rank and the ``B`` / ``C`` groups (kept whole on every rank)
    are one."""
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    cut = {pspec_for((ax,), (w,), mesh, opts)[0] == opts.tp_axis
           for ax, w in (("ssm_inner", 2 * di + 2 * gn + h),
                         ("ssm_inner", di + 2 * gn), ("ssm_inner", di),
                         ("ssm_heads", h))}
    if len(cut) > 1:
        raise ValueError(f"{cfg.name}: the rules split some of the Mamba2 "
                         f"block's leaves over {tp} ranks, not all")
    split = cut.pop()
    if split and h % tp:
        raise ValueError(f"{cfg.name}: {h} ssm_heads do not split into "
                         f"whole heads over {tp} ranks")
    if split and cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.ssm_groups} B/C groups under a split of the "
            f"heads (each rank keeps the groups whole; one group is ported)")
    return split


def check_dense_mesh(cfg, mesh, opts: ShardingOptions, what: str, *,
                     serving: bool = False) -> dict:
    """Refuse, for ``what`` (serving, or training where ``serving`` is
    False), a mesh description with no ranks, a backend that cannot run
    the collectives on the rank's tensors, a family other than the dense
    and MoE ones in training, an unknown family, sequence parallelism,
    2D tensor parallelism outside serving, data or FSDP axes other than
    one data axis where FSDP or 2D tensor parallelism would use them,
    and heads the TP axis would split unevenly, each with a message of
    its own.
    Serving takes every family on every layout.  Returns which head dims the
    rules split ({"qheads": bool, "kvheads": bool}, and for a model with
    Mamba2 blocks "ssm_heads")."""
    if not hasattr(mesh, "group"):
        raise TypeError(f"{what} runs on a process mesh (launch/mesh.py::"
                        f"make_mesh); a mesh description has no ranks")
    if mesh.backend == "nccl" and mesh.device.type != "cuda":
        raise RuntimeError(f"NCCL runs collectives on CUDA tensors, not on "
                           f"{mesh.device}")
    if cfg.family not in _TRAINED and not serving:
        raise NotImplementedError(f"{cfg.name}: {what} runs the dense and "
                                  f"MoE families only, not {cfg.family!r}")
    if cfg.family not in _EVERY_LAYOUT:
        raise ValueError(f"unknown model family {cfg.family!r}")
    if opts.sequence_parallel:
        raise NotImplementedError(
            f"{what} with sequence parallelism (sequence_parallel="
            f"{opts.sequence_parallel!r}: the prefill's sequence split over "
            f"the {'model' if opts.sequence_parallel == 'model' else 'data'}"
            f" axis) is not ported")
    if opts.serve_2d_tp and not serving:
        raise NotImplementedError(f"{what}: 2D tensor parallelism "
                                  f"(serve_2d_tp) is a serving layout")
    if serving and (opts.fsdp or opts.serve_2d_tp):
        live = {a for a in opts.dp_axes + opts.fsdp_axes if a in mesh.shape}
        if len(live) > 1 or (live and tuple(opts.fsdp_axes) !=
                             tuple(opts.dp_axes)):
            raise NotImplementedError(
                f"{what} with FSDP or 2D tensor parallelism runs over one "
                f"data axis that is both the data and the FSDP axis, not "
                f"dp_axes={opts.dp_axes}, fsdp_axes={opts.fsdp_axes}")
    tp = axis_size(mesh, opts.tp_axis) if opts.tp_axis in mesh.shape else 1
    split = {}
    if cfg.use_mla:
        # wq_b, wkv_b and wo carry the heads: all split, or none
        widths = (cfg.head_dim + cfg.rope_head_dim,
                  cfg.head_dim + cfg.v_head_dim, cfg.v_head_dim)
        cut = {pspec_for(("qheads",), (cfg.num_heads * w,), mesh,
                         opts)[0] == opts.tp_axis for w in widths}
        if len(cut) > 1:
            raise ValueError(f"{cfg.name}: the rules split some of MLA's "
                             f"head projections over {tp} ranks, not all")
        heads = {"qheads": (cfg.num_heads, cut.pop())}
    else:
        heads = {ax: (n, pspec_for((ax,), (n * cfg.head_dim,), mesh,
                                   opts)[0] == opts.tp_axis)
                 for ax, n in (("qheads", cfg.num_heads),
                               ("kvheads", cfg.num_kv_heads))}
    for ax, (n, cut) in heads.items():
        split[ax] = cut
        if cut and n % tp:
            raise ValueError(f"{cfg.name}: {n} {ax} do not split into "
                             f"whole heads over {tp} ranks")
    if cfg.ssm_state:
        split["ssm_heads"] = _ssm_split(cfg, mesh, opts, tp)
    return split


def tp_leaf_split(axes: tuple, shape: tuple) -> Optional[str]:
    """The logical axis of a whole weight leaf (``axes``, full ``shape``)
    that the rules (``pspec_for``) put the TP axis on, on the ambient
    process mesh; None where the leaf is whole or there is no process
    mesh.  Unlike :func:`tp_split`, which asks about one logical axis
    alone, this reads the leaf's spec, so an MoE expert stack tells its
    layouts apart: ``experts`` (a rank holds some experts) or ``mlp``
    (every expert's columns split)."""
    ctx = _CTX.get()
    if ctx is None or ctx.group(ctx.opts.tp_axis) is None:
        return None
    spec = pspec_for(tuple(axes), tuple(shape), ctx.mesh, ctx.opts)
    for ax, entry in zip(axes, spec):
        if entry == ctx.opts.tp_axis:
            return ax
    return None


_ROWS_WHOLE: contextvars.ContextVar = contextvars.ContextVar(
    "rows_whole", default=False)


@contextlib.contextmanager
def whole_rows():
    """Inside: the rows the rank computes are not its data line's piece of
    a bucket, whatever the cell's cache layout says (a queue admission
    runs its one request on every rank)."""
    tok = _ROWS_WHOLE.set(True)
    try:
        yield
    finally:
        _ROWS_WHOLE.reset(tok)


def moe_groups(tokens: int) -> int:
    """The MoE dispatch-group count of ``tokens`` rank-local tokens (the
    reference's ``models/moe.py::_dp_groups``, which dispatches per data
    shard: ``n`` groups of a global batch over ``n`` data ranks where
    ``n`` divides its tokens).  Where the rank computes its data line's
    rows (a train step, where autograd records: each rank holds its rows
    of the global batch; or a serving cell whose cache rows are split
    over the data axis, outside 2D tensor parallelism), those rows are
    exactly one group; where every rank computes the whole bucket, it
    dispatches the ``n`` groups over its tokens itself.  1 off a mesh."""
    ctx = _CTX.get()
    if ctx is None or not hasattr(ctx.mesh, "group"):
        return 1
    dp = tuple(a for a in ctx.opts.dp_axes if a in ctx.mesh.shape)
    n = axis_size(ctx.mesh, dp) if dp else 1
    lay = ctx.layout
    if (n <= 1 or torch.is_grad_enabled()
            or (lay is not None and lay.rows is not None
                and not lay.gathered and not _ROWS_WHOLE.get())):
        return 1
    return n if tokens % n == 0 and tokens >= n else 1


def tp_rank() -> int:
    """The calling rank's index along the TP axis (0 off a process
    mesh)."""
    ctx = _CTX.get()
    if ctx is None or tp_group() is None:
        return 0
    return ctx.mesh.coords[ctx.opts.tp_axis]


# ---------------------------------------------------------------------------
# The data axis under FSDP and 2D tensor parallelism (serving)
# ---------------------------------------------------------------------------


def _data_axis(ctx) -> Optional[str]:
    """The ambient mesh's data axis (the first of ``dp_axes`` it has)."""
    for a in ctx.opts.dp_axes:
        if a in ctx.mesh.shape:
            return a
    return None


def dp_group():
    """The calling rank's line along the data axis, or None (no context,
    a mesh description, or no data axis)."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    ax = _data_axis(ctx)
    return None if ax is None else ctx.group(ax)


def dp_rank() -> int:
    """The calling rank's coordinate along the data axis (0 off it)."""
    ctx = _CTX.get()
    if ctx is None or dp_group() is None:
        return 0
    return ctx.mesh.coords[_data_axis(ctx)]


def dp_size() -> int:
    ctx = _CTX.get()
    if ctx is None or dp_group() is None:
        return 1
    return ctx.mesh.shape[_data_axis(ctx)]


def _serving() -> bool:
    from repro_torch.core.linear import in_serving_ctx
    return in_serving_ctx()


def fsdp_split(dim: int) -> bool:
    """Whether a serving rank holds a piece of an ``embed`` dim of full
    size ``dim``: FSDP put the data axis on it (``pspec_for``; at a data
    size of 1 too).  Training gathers its whole tree at step start
    (``train/step.py``), so this answers only inside ``serving_ctx``."""
    ctx = _CTX.get()
    if ctx is None or not ctx.opts.fsdp or dp_group() is None \
            or not _serving():
        return False
    return pspec_for(("embed",), (dim,), ctx.mesh,
                     ctx.opts)[0] == _data_axis(ctx)


def serve_2d() -> bool:
    """Whether the ambient options serve 2D tensor-parallel on a process
    mesh with a data axis: compute rows replicated over data."""
    ctx = _CTX.get()
    return (ctx is not None and ctx.opts.serve_2d_tp
            and dp_group() is not None)


def kblocks_split(k: int) -> bool:
    """Whether the ambient options split a packed weight's row blocks (an
    ``embed`` contraction dim of full size ``k``) over the data axis and
    contract them where they lie: 2D tensor parallelism (the reference's
    ``kblocks`` on the data axes, ``sharding/context.py:57-64`` there),
    each rank multiplying its K slice of the activation panel, the
    partial outputs summed over the data group."""
    return serve_2d() and fsdp_split(k)


def data_split_of(spec) -> Optional[str]:
    """``"rows"`` or ``"cols"``: which dim of a serving weight whose
    (row, col) spec entries are ``spec`` (a ``PackedTensor``'s ``spec``)
    the data axis splits, or None."""
    ctx = _CTX.get()
    if ctx is None or not spec or dp_group() is None or not _serving():
        return None
    ax = _data_axis(ctx)
    for name, entry in zip(("rows", "cols"), spec):
        if entry == ax or (isinstance(entry, tuple) and ax in entry):
            return name
    return None


def dp_gather_cols(x, dim: int):
    """Under 2D tensor parallelism, an output whose last dim is this
    rank's piece of an FSDP-split ``embed`` dim of full size ``dim``
    (``wo``, ``w_down`` and the looked-up embeddings: their columns lie
    on the data axis) gathered to full width over the data group; ``x``
    itself otherwise."""
    if not (serve_2d() and fsdp_split(dim)):
        return x
    from repro_torch.sharding import comm
    return comm.all_gather(x, dp_group(), dim=-1)


def dp_weight(w, full: int, dim: int):
    """Under FSDP (not 2D tensor parallelism), an unpacked serving weight
    whose dim ``dim`` is this rank's piece of an ``embed`` dim of full
    size ``full`` (the MoE router's and shared experts' rows, an expert
    stack's ``embed`` dim), gathered over the data group before use;
    ``w`` itself otherwise."""
    if serve_2d() or not fsdp_split(full):
        return w
    from repro_torch.sharding import comm
    return comm.all_gather(w, dp_group(), dim=dim)


def dp_weight_cols(w, dim: int):
    """Under FSDP (not 2D tensor parallelism), an unpacked serving weight
    whose columns are this rank's piece of an ``embed`` dim of full size
    ``dim`` (``wo``, ``w_down``), gathered over the data group before
    use; ``w`` itself otherwise (a packed piece is gathered in
    ``core/tsmm.py::tsmm_dot``)."""
    return w if hasattr(w, "blocks") else dp_weight(w, dim, -1)


def dp_slice(x, full: int):
    """Under 2D tensor parallelism, this rank's K slice of an activation
    whose last dim (an ``embed`` dim of full size ``full``) meets weight
    pieces whose rows lie on the data axis: the rank contracts its slice
    with its piece where the piece lies, and the partial products are
    summed over the data group.  ``x`` itself otherwise."""
    if not kblocks_split(full):
        return x
    w = full // dp_size()
    return x[..., dp_rank() * w:(dp_rank() + 1) * w]


def dp_full(t, dim: int):
    """An FSDP-split serving leaf (a norm's scale) whose last dim is this
    rank's piece of an ``embed`` dim of full size ``dim``, gathered over
    the data group before use; ``t`` itself where it is whole (a piece
    is always narrower than ``dim``: MLA's low-rank norms are whole)."""
    if t.shape[-1] == dim or not fsdp_split(dim):
        return t
    from repro_torch.sharding import comm
    return comm.all_gather(t, dp_group(), dim=-1)


def cache_layout() -> Optional[CacheLayout]:
    """The ambient cell's cache layout (None: the cache is whole)."""
    ctx = _CTX.get()
    return None if ctx is None else ctx.layout


def row_start(lay: CacheLayout, rows: int) -> int:
    """The first row of the bucket whose cache this rank holds, where
    every rank computes the whole bucket over a piece of the cache's rows
    (``lay``, the cell's ``CacheLayout``, ``gathered``; ``rows`` the
    piece's): its coordinate on the rows' axis times the piece.  With
    :func:`gather_rows`, the one way a cell combines a row-split cache
    with whole-bucket compute (the attention caches and the SSM state)."""
    return axis_group(lay.rows)[1] * rows


def gather_rows(lay: CacheLayout, t):
    """A per-row result ``t`` (its leading dim the rank's rows of the
    bucket, from :func:`row_start`) gathered over the rows' group into
    the whole bucket, the pieces in the axis's coordinate order."""
    from repro_torch.sharding import comm
    return comm.all_gather(t, axis_group(lay.rows)[0], dim=0)


def axis_group(axis: str):
    """(group, index, count) of the calling rank's line along ``axis``."""
    ctx = _CTX.get()
    return (ctx.group(axis), ctx.mesh.coords[axis], ctx.mesh.shape[axis])
