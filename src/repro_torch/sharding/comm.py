"""The port's only route to a collective.

Every collective the port runs goes through this module: ``all_reduce``
(a sum, in place where the tensor is contiguous), ``all_gather``
(concatenated along a dim), ``reduce_scatter`` (a sum, each rank keeping
its piece along a dim), ``broadcast`` and ``ring_shift`` (an ``isend`` /
``irecv`` pair: send to the next rank of the group, receive from the
previous one; the counterpart of ``jax.lax.ppermute`` over a ring).
Each call is recorded by op (the reference's HLO names: ``all-reduce``,
``all-gather``, ``reduce-scatter``, ``broadcast``,
``collective-permute``), tensor bytes (an all-gather's and a
reduce-scatter's output, as HLO counts them) and group size, into the
recorder the calling context has open (:func:`recording`, a context
variable: what a CUDA graph capture records runs on every replay,
:func:`replayed` adds it once), else into the global :data:`records`.  ``analysis/collectives.py`` turns a record into the
reference's ``{op: {count, bytes_moved, tensor_bytes}}``.

No collective falls back quietly.  gloo runs ``all_reduce``,
``all_gather`` and ``broadcast`` on CUDA tensors itself (it copies them
through the host inside the op), but its point-to-point ``send`` /
``recv`` take host memory only: those are staged here through a host
copy, explicitly, and every staged op is named in its record
(``staged=True``) and in :data:`STAGED`.  gloo runs ``reduce_scatter``
on CUDA tensors itself too (fp32 and bf16, on the H100's torch 2.11).
Any other refusal of a backend (NCCL given a host tensor, an unsupported
dtype) raises through.

Training differentiates through four of them, each an
``autograd.Function`` whose forward and backward both run through the
recorded calls (Megatron's *f* and *g*, and FSDP's gather):

* :func:`tp_copy` (*f*, at the input of a column-parallel group): the
  identity forward, the gradient all-reduced backward;
* :func:`tp_sum` (*g*, after a row-parallel product): all-reduce forward,
  the identity backward.  ``torch.distributed.nn``'s all-reduce is not
  *g*: its backward all-reduces the gradient again, which multiplies
  every gradient upstream by the group's size;
* :func:`tp_gather`: all-gather forward, the rank's own slice of the
  gradient backward;
* :func:`fsdp_gather`: all-gather of a parameter shard forward, the
  gradient reduce-scattered back onto the shards (summed over the group).

On a CUDA tensor autograd runs the backward on a device thread of its
own, outside the caller's context: each of these functions takes the
recorder open at its forward and records its backward's collective
there (``models/layers.py::remat`` carries the caller's context into a
recomputed forward the same way).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

# (backend, device type, op) staged through host memory by this module
STAGED = {("gloo", "cuda", "send"), ("gloo", "cuda", "recv")}

records: list = []
_REC: contextvars.ContextVar = contextvars.ContextVar("comm_recorder",
                                                     default=None)


def reset() -> None:
    records.clear()


def _sink() -> list:
    """The list a collective is recorded into here: the open recorder's,
    else the global :data:`records`."""
    rec = _REC.get()
    return rec if rec is not None else records


@contextlib.contextmanager
def _into(sink: list):
    """Record into ``sink`` (an autograd backward on another thread)."""
    tok = _REC.set(sink)
    try:
        yield sink
    finally:
        _REC.reset(tok)


def recording():
    """Record the calling context's collectives into a list of its own
    instead of the global :data:`records` (a context manager yielding
    the list)."""
    return _into([])


def replayed(rec: list) -> None:
    """Add a recorder's collectives once: one replay of what it recorded
    (a CUDA graph's replay runs its captured collectives)."""
    _sink().extend(rec)


def _record(op: str, nbytes: int, group, staged: bool = False) -> None:
    _sink().append({"op": op, "bytes": int(nbytes),
                    "group_size": group_size(group), "staged": staged})


def group_size(group) -> int:
    return dist.get_world_size(group)


def backend_of(group) -> str:
    return str(dist.get_backend(group))


def staged(op: str, tensor, group) -> bool:
    return (backend_of(group), tensor.device.type, op) in STAGED


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def all_reduce(tensor, group):
    """Sum ``tensor`` over ``group`` (in place when it is contiguous, else
    on a contiguous copy); returns the sum."""
    if not tensor.is_contiguous():
        tensor = tensor.contiguous()
    dist.all_reduce(tensor, group=group)
    _record("all-reduce", _nbytes(tensor), group)
    return tensor


def all_gather(tensor, group, dim: int = -1):
    """The group's tensors concatenated along ``dim``, in rank order."""
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(group_size(group))]
    dist.all_gather(parts, tensor, group=group)
    out = torch.cat(parts, dim=dim)
    _record("all-gather", _nbytes(out), group)
    return out


def reduce_scatter(tensor, group, dim: int = 0):
    """The sum of the group's ``tensor``s, of which this rank keeps its
    piece along ``dim`` (the dim cut into group-size equal pieces, in
    rank order)."""
    n = group_size(group)
    src = tensor.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of "
                         f"{tuple(tensor.shape)} does not divide over {n}")
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    _record("reduce-scatter", _nbytes(out), group)
    return out.movedim(0, dim).contiguous()


def gather_full(tensor, spec, mesh):
    """A rank's piece of a tensor under ``spec`` on the process ``mesh``
    gathered to the full tensor over each axis that splits it (the minor
    axis of a joint entry first; an axis of one rank splits nothing);
    every rank of those groups takes part."""
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        for name in reversed(names):
            if name is not None and mesh.shape[name] > 1:
                tensor = all_gather(tensor, mesh.group(name), dim=dim)
    return tensor


def broadcast(tensor, src: int, group):
    """``tensor`` from global rank ``src`` to every rank of ``group``, in
    place; returns it."""
    dist.broadcast(tensor, src=src, group=group)
    _record("broadcast", _nbytes(tensor), group)
    return tensor


def ring_shift(tensor, group, *, wait: bool = True):
    """Send ``tensor`` to the next rank of ``group`` and receive what the
    previous rank sent (a ring of ``isend`` / ``irecv``).  Returns the
    received tensor, or with ``wait=False`` a function that waits for it
    (the exchange runs meanwhile)."""
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    stage = staged("send", tensor, group)
    src = tensor.contiguous()
    if stage:
        src = src.cpu()
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, nxt, group),
                                   dist.P2POp(dist.irecv, out, prv, group)])
    _record("collective-permute", _nbytes(tensor), group, staged=stage)

    def finish():
        for req in reqs:
            req.wait()
        return out.to(tensor.device) if stage else out

    return finish() if wait else finish


# ---------------------------------------------------------------------------
# Collectives with gradients (training)
# ---------------------------------------------------------------------------


def _own(t):
    """A contiguous tensor of our own: an incoming gradient may be shared
    with another node of the graph, and the collectives write in place."""
    return t.clone(memory_format=torch.contiguous_format)


class _Copy(torch.autograd.Function):
    """Megatron's *f*: the identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.sink = group, _sink()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _into(ctx.sink):
            return all_reduce(_own(g), ctx.group), None


class _Sum(torch.autograd.Function):
    """Megatron's *g*: all-reduce forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(_own(x), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward; backward keeps the rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None


class _FsdpGather(torch.autograd.Function):
    """All-gather of a shard forward; reduce-scatter of the gradient
    backward."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim, ctx.sink = group, dim, _sink()
        return all_gather(shard, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        with _into(ctx.sink):
            return reduce_scatter(g, ctx.group, ctx.dim), None, None


def tp_copy(x, group):
    """``x`` unchanged; its gradient all-reduced over ``group``."""
    return _Copy.apply(x, group)


def tp_sum(x, group):
    """``x`` summed over ``group``; its gradient passed through."""
    return _Sum.apply(x, group)


def tp_gather(x, group, dim: int = -1):
    """The group's ``x`` concatenated along ``dim``; the gradient of this
    rank's slice flows back to ``x``."""
    return _Gather.apply(x, group, dim % x.ndim)


def fsdp_gather(shard, group, dim: int):
    """A parameter's shards concatenated along ``dim``; the gradient summed
    over ``group`` and cut back to this rank's shard."""
    return _FsdpGather.apply(shard, group, dim)
