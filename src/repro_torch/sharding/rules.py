"""Logical-axis -> partition rules.

The port of the reference's ``sharding/rules.py``.  The paper's
multi-thread optimizer rule (never split the skinny dimension of a TSMM
across workers) generalizes to the **skinny no-shard rule**: an axis
assignment is dropped whenever the dimension is smaller than
``SKINNY_MIN_PER_SHARD * axis_size`` or not divisible by the axis size.
Small dims are replicated so every rank holds the whole skinny operand,
and parallelism comes from the tall dimension only.

TP lives on the ``model`` axis, DP/FSDP on ``data`` (and ``pod`` when
present).  In place of ``jax.sharding.Mesh`` the rules take a
:class:`Mesh`, an ordered description of axis names and sizes (any
object with an ordered ``shape`` mapping does: the process mesh of
``launch/mesh.py`` too), and return :class:`P` tuples: one entry per
dim, ``None`` (replicated), an axis name, or a tuple of axis names (the
first the major one).  :func:`local_shard` cuts a full tensor to one
rank's piece of such a spec: the port holds rank-local tensors and
moves data only through explicit collectives (``sharding/comm.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Logical axes that take the tensor-parallel ('model') axis.
TP_AXES = {"qheads", "kvheads", "mlp", "vocab", "experts", "ssm_inner",
           "ssm_heads"}
# Logical axes eligible for FSDP-style sharding on the data axis.
FSDP_AXES = {"embed"}

# The skinny no-shard rule: require >= this many elements per shard.
SKINNY_MIN_PER_SHARD = 8


class P(tuple):
    """A partition spec: one entry per dim, ``None`` (replicated), an axis
    name, or a tuple of axis names (the first the major one)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ordered axis names and sizes; no devices (the rules need none)."""
    axes: tuple                     # ((name, size), ...)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(n for n, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    @staticmethod
    def of(shape: tuple, names: tuple) -> "Mesh":
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} vs axes {names}")
        return Mesh(tuple(zip(names, (int(s) for s in shape))))


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    tp_axis: str = "model"
    dp_axes: tuple = ("data",)            # ("pod","data") on a multi-pod mesh
    fsdp: bool = False                    # shard "embed" dims of params on dp
    fsdp_axes: tuple = ("data",)          # which dp axes FSDP uses
    # activation sequence sharding: False | True (dp axes) | "model"
    # ("model" = Megatron-SP: residual-stream seq over the TP axis)
    sequence_parallel: object = False
    # 2D weight-stationary tensor parallelism for serving: weights stay
    # sharded (rows on dp, cols on tp); compute-path activations are
    # replicated over dp and the packed contraction k-shards over dp
    # ("kblocks") with a sum of the skinny output.  KV caches keep their
    # dp batch sharding (cache_batch).
    serve_2d_tp: bool = False


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(mesh, n) for n in name)
    return mesh.shape[name]


def _fits(dim: int, n_shards: int) -> bool:
    """Divisible and not skinny (the no-shard rule)."""
    return dim % n_shards == 0 and dim // n_shards >= SKINNY_MIN_PER_SHARD


def pspec_for(axes: tuple, shape: tuple, mesh, opts: ShardingOptions) -> P:
    """The spec of one param leaf from its logical axes and shape."""
    assign: list = [None] * len(axes)
    used = set()
    # 1. tensor-parallel assignments
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if (ax in TP_AXES and opts.tp_axis not in used
                and _fits(dim, axis_size(mesh, opts.tp_axis))):
            assign[i] = opts.tp_axis
            used.add(opts.tp_axis)
    # 2. FSDP on the remaining largest eligible dim
    if opts.fsdp:
        fs = tuple(a for a in opts.fsdp_axes if a not in used)
        if fs:
            n = axis_size(mesh, fs)
            cands = [(dim, i) for i, (ax, dim) in enumerate(zip(axes, shape))
                     if assign[i] is None and ax in FSDP_AXES
                     and _fits(dim, n)]
            if cands:
                _, i = max(cands)
                assign[i] = fs if len(fs) > 1 else fs[0]
    return P(*assign)


def _packed_pspec(axes: tuple, leaf, mesh, opts: ShardingOptions) -> P:
    """The spec of a PackedTensor leaf: the logical (row, col) assignment
    moves to the block-count dims (n0, n1); block dims and lead dims
    replicate.  The fit check runs on block counts (divisible)."""
    blocks_shape = leaf.blocks.shape
    lead = len(blocks_shape) - 4
    n0, n1 = blocks_shape[lead], blocks_shape[lead + 1]
    row_ax, col_ax = axes[-2], axes[-1]
    assign = [None] * len(blocks_shape)
    used = set()
    for pos, (ax, cnt) in ((lead, (row_ax, n0)), (lead + 1, (col_ax, n1))):
        if ax in TP_AXES and opts.tp_axis not in used:
            if cnt % axis_size(mesh, opts.tp_axis) == 0:
                assign[pos] = opts.tp_axis
                used.add(opts.tp_axis)
    if opts.fsdp:
        avail = tuple(a for a in opts.fsdp_axes if a not in used)
        # the joint axes first, then single-axis subsets (multi-pod meshes
        # where the block count divides only one axis)
        for fs in (avail,) + tuple((a,) for a in avail):
            if not fs:
                continue
            n = axis_size(mesh, fs)
            done = False
            for pos, (ax, cnt) in ((lead, (row_ax, n0)),
                                   (lead + 1, (col_ax, n1))):
                if assign[pos] is None and ax in FSDP_AXES and cnt % n == 0:
                    assign[pos] = fs if len(fs) > 1 else fs[0]
                    done = True
                    break
            if done:
                break
    return P(*assign)


def spec_leaves(specs) -> list:
    """The specs of a spec tree (nested dicts of :class:`P`) in the order
    of ``models/param.py::tree_leaves`` (dict keys sorted at every level;
    a spec is a tuple, which ``tree_leaves`` would walk into)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [specs]


def param_pspecs(axes_tree, shapes_tree, mesh, opts: ShardingOptions):
    """The spec tree of a params tree (tensors, ``meta`` tensors or
    PackedTensor leaves); ``axes_tree`` leads the walk."""
    from repro_torch.core.packing import is_packed

    def walk(a, leaf):
        if isinstance(a, dict):
            return {k: walk(a[k], leaf[k]) for k in a}
        if is_packed(leaf):
            return _packed_pspec(a, leaf, mesh, opts)
        return pspec_for(a, tuple(leaf.shape), mesh, opts)

    return walk(axes_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Cache specs (serving KV / SSM state placement)
# ---------------------------------------------------------------------------

# logical axes per decode-cache leaf (leading "dense{i}_" prefixes strip to
# the base name; hybrid stacks add a leading 'groups' dim)
CACHE_AXES = {
    "pos": (),
    "slot_pos": (None,),
    # cache_seq falls back to the model axis when kvheads can't take it
    # (GQA kv < tp): the sequence-sharded KV cache for long-context decode.
    # cache_batch is dp-sharded even under serve_2d_tp.
    "k": ("layers", "cache_batch", "cache_seq", "kvheads", "headdim"),
    "v": ("layers", "cache_batch", "cache_seq", "kvheads", "headdim"),
    "c": ("layers", "cache_batch", "cache_seq", "lora"),
    "kr": ("layers", "cache_batch", "cache_seq", "rope"),
    "ssm": ("layers", "cache_batch", "ssm_heads", "headdim", "state"),
    "conv": ("layers", "cache_batch", "conv", "ssm_inner"),
    "cross_k": ("layers", "cache_batch", "seq", "kvheads", "headdim"),
    "cross_v": ("layers", "cache_batch", "seq", "kvheads", "headdim"),
}


def cache_axes_for(cfg, key: str, ndim: int):
    base = key
    if key.startswith("dense") and "_" in key:
        base = key.split("_", 1)[1]
    ax = CACHE_AXES.get(base)
    if ax is None:
        return (None,) * ndim
    if len(ax) == ndim:
        return ax
    if len(ax) == ndim - 1:          # hybrid: extra leading 'groups' dim
        return ("groups",) + ax
    if len(ax) == ndim + 1:          # dense{i}_* lack the layer dim
        return ax[1:]
    return (None,) * ndim


def cache_pspecs(cfg, cache, mesh, opts: ShardingOptions) -> dict:
    """The spec of each decode-cache leaf (tensors or shapes)."""
    from repro_torch.sharding.context import ShardCtx  # context imports us
    ctx = ShardCtx(mesh, opts)
    return {key: ctx.spec_for(cache_axes_for(cfg, key, len(leaf.shape)),
                              tuple(leaf.shape))
            for key, leaf in cache.items()}


# ---------------------------------------------------------------------------
# Activation specs
# ---------------------------------------------------------------------------


def batch_pspec(global_batch: int, mesh, opts: ShardingOptions) -> P:
    """Batch dim over the dp axes, honouring the divisibility rule (a
    batch of 1 replicates)."""
    dp = tuple(a for a in opts.dp_axes if a in mesh.shape)
    n = axis_size(mesh, dp)
    if dp and global_batch % n == 0 and global_batch >= n:
        return P(dp if len(dp) > 1 else dp[0])
    # a prefix of the dp axes (batch 32 on a 2x16x16 mesh: pod x data)
    for k in range(len(dp), 0, -1):
        sub = dp[:k]
        n = axis_size(mesh, sub)
        if global_batch % n == 0 and global_batch >= n:
            return P(sub if len(sub) > 1 else sub[0])
    return P(None)


def tokens_pspec(global_batch: int, seq: int, mesh,
                 opts: ShardingOptions) -> P:
    b = batch_pspec(global_batch, mesh, opts)
    if opts.sequence_parallel and b == P(None):
        # batch unshardable (long-context batch=1): shard seq on data
        dp = tuple(a for a in opts.dp_axes if a in mesh.shape)
        n = axis_size(mesh, dp)
        if seq % n == 0:
            return P(None, dp if len(dp) > 1 else dp[0])
    return P(*b, None)


# ---------------------------------------------------------------------------
# Rank-local pieces
# ---------------------------------------------------------------------------


def shard_index(entry, mesh, coords: dict) -> tuple:
    """(index, count) of a rank's piece along a dim whose spec entry is
    ``entry`` (None, a name, or a tuple of names, the first major), at
    mesh coordinates ``coords`` ({axis name: index})."""
    if entry is None:
        return 0, 1
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    idx, count = 0, 1
    for n in names:
        size = axis_size(mesh, n)
        idx = idx * size + coords[n]
        count *= size
    return idx, count


def local_shape(shape: tuple, spec, mesh, segments=None) -> tuple:
    """The shape of one rank's piece of a ``shape`` tensor under ``spec``;
    with ``segments`` (``[start, stop)`` ranges), the last dim is those
    ranges' total instead (a segmented cut, ``models/mamba2.py::
    tp_segments``)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = axis_size(mesh, entry) if entry is not None else 1
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry} ({n})")
        out.append(dim // n)
    if segments is not None:
        out[-1] = sum(b - a for a, b in segments)
    return tuple(out)


def local_shard(tensor, spec, mesh, coords: dict, segments=None):
    """One rank's piece of the full ``tensor`` under ``spec`` at mesh
    coordinates ``coords``: a contiguous copy (a view would keep the full
    tensor alive).  With ``segments`` the last dim takes those ``[start,
    stop)`` ranges, in order, in place of its contiguous piece.  Works on
    torch tensors and numpy arrays."""
    index = []
    for dim, entry in zip(tensor.shape, tuple(spec) + (None,) * tensor.ndim):
        i, n = shard_index(entry, mesh, coords)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"divide over {entry} ({n})")
        w = dim // n
        index.append(slice(i * w, (i + 1) * w))
    if segments is not None:
        index[-1] = slice(None)
    piece = tensor[tuple(index)]
    if segments is not None:
        parts = [piece[..., a:b] for a, b in segments]
        if hasattr(piece, "clone"):
            import torch
            return torch.cat(parts, dim=-1)
        import numpy as np
        return np.concatenate(parts, axis=-1)
    if hasattr(piece, "clone"):
        import torch
        return piece.clone(memory_format=torch.contiguous_format)
    return piece.copy()


def local_params(params, specs, full, mesh, path: tuple = (), *,
                 cut=None):
    """This rank's pieces of a params tree under its spec tree: a leaf of
    its full shape (``full``'s, any device, ``meta`` included) is cut
    (:func:`local_shard`), a leaf already of the piece's shape is kept,
    anything else raises.  ``cut(path, spec, full_shape)``: the rank's
    ``segments`` of a leaf cut by ranges (or None), where the caller has
    such leaves (``serve/engine.py``: the SSM ones)."""
    if isinstance(params, dict):
        return {k: local_params(params[k], specs[k], full[k], mesh,
                                path + (k,), cut=cut) for k in params}
    fs = tuple(full.shape)
    segs = cut(path, specs, fs) if cut is not None else None
    ls = local_shape(fs, specs, mesh, segs)
    if tuple(params.shape) == ls:
        return params
    if tuple(params.shape) == fs:
        return local_shard(params, specs, mesh, mesh.coords, segs)
    raise ValueError(f"{'/'.join(path)}: shape {tuple(params.shape)} is "
                     f"neither the full {fs} nor this rank's piece {ls} "
                     f"under {specs}")
