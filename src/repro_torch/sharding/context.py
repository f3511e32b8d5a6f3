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
class ShardCtx:
    mesh: object
    opts: ShardingOptions

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
def sharding_ctx(mesh, opts: Optional[ShardingOptions] = None):
    prev = _CTX.get()
    tok = _CTX.set(ShardCtx(mesh, opts or ShardingOptions())
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
    if not (tp_split(axis, dim) and _records(x)):
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
    if not tp_split(axis, dim):
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
    if not tp_split(axis, dim):
        return x
    from repro_torch.sharding import comm
    if _records(x):
        return comm.tp_gather(x, tp_group(), dim=-1)
    return comm.all_gather(x, tp_group(), dim=-1)


def check_dense_mesh(cfg, mesh, opts: ShardingOptions, what: str) -> dict:
    """Refuse, for ``what`` (serving or training), a mesh description with
    no ranks, a backend that cannot run the collectives on the rank's
    tensors, a family other than the dense one, 2D tensor parallelism or
    sequence parallelism, and heads the TP axis would split unevenly.
    Returns which head dims the rules split ({"qheads": bool,
    "kvheads": bool})."""
    if not hasattr(mesh, "group"):
        raise TypeError(f"{what} runs on a process mesh (launch/mesh.py::"
                        f"make_mesh); a mesh description has no ranks")
    if mesh.backend == "nccl" and mesh.device.type != "cuda":
        raise RuntimeError(f"NCCL runs collectives on CUDA tensors, not on "
                           f"{mesh.device}")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: {what} runs the dense "
                                  f"family only, not {cfg.family!r}")
    if opts.serve_2d_tp or opts.sequence_parallel:
        raise NotImplementedError(f"{what} with 2D tensor parallelism or "
                                  f"sequence parallelism is not ported")
    tp = axis_size(mesh, opts.tp_axis) if opts.tp_axis in mesh.shape else 1
    split = {}
    for ax, heads in (("qheads", cfg.num_heads), ("kvheads",
                                                  cfg.num_kv_heads)):
        split[ax] = pspec_for((ax,), (heads * cfg.head_dim,), mesh,
                              opts)[0] == opts.tp_axis
        if split[ax] and heads % tp:
            raise ValueError(f"{cfg.name}: {heads} {ax} do not split into "
                             f"whole heads over {tp} ranks")
    return split


def tp_rank() -> int:
    """The calling rank's index along the TP axis (0 off a process
    mesh)."""
    ctx = _CTX.get()
    if ctx is None or tp_group() is None:
        return 0
    return ctx.mesh.coords[ctx.opts.tp_axis]
