"""The port's only route to a collective.

Every collective the port runs goes through this module: ``all_reduce``
(a sum, in place where the tensor is contiguous), ``all_gather``
(concatenated along a dim), ``broadcast`` and ``ring_shift`` (an
``isend`` / ``irecv`` pair: send to the next rank of the group, receive
from the previous one; the counterpart of ``jax.lax.ppermute`` over a
ring).  Each call is recorded by op (the
reference's HLO names: ``all-reduce``, ``all-gather``, ``broadcast``,
``collective-permute``), tensor bytes (an all-gather's output, as HLO
counts it) and group size, into the calling thread's recorder while one
is open (:func:`recording`: what a CUDA graph capture records runs on
every replay, :func:`replayed` adds it once), else into the global
:data:`records`.  ``analysis/collectives.py`` turns a record into the
reference's ``{op: {count, bytes_moved, tensor_bytes}}``.

No collective falls back quietly.  gloo runs ``all_reduce``,
``all_gather`` and ``broadcast`` on CUDA tensors itself (it copies them
through the host inside the op), but its point-to-point ``send`` /
``recv`` take host memory only: those are staged here through a host
copy, explicitly, and every staged op is named in its record
(``staged=True``) and in :data:`STAGED`.  Any other refusal of a backend
(NCCL given a host tensor, an unsupported dtype) raises through.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

# (backend, device type, op) staged through host memory by this module
STAGED = {("gloo", "cuda", "send"), ("gloo", "cuda", "recv")}

records: list = []
_recorder = threading.local()


def reset() -> None:
    records.clear()


@contextlib.contextmanager
def recording():
    """Record the calling thread's collectives into a list of its own
    instead of the global :data:`records`."""
    prev = getattr(_recorder, "rec", None)
    _recorder.rec = []
    try:
        yield _recorder.rec
    finally:
        _recorder.rec = prev


def replayed(rec: list) -> None:
    """Add a recorder's collectives once: one replay of what it recorded
    (a CUDA graph's replay runs its captured collectives)."""
    target = getattr(_recorder, "rec", None)
    (target if target is not None else records).extend(rec)


def _record(op: str, nbytes: int, group, staged: bool = False) -> None:
    rec = getattr(_recorder, "rec", None)
    (rec if rec is not None else records).append(
        {"op": op, "bytes": int(nbytes), "group_size": group_size(group),
         "staged": staged})


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
