"""Collective accounting from ``sharding/comm.py``'s record.

The counterpart of the reference's ``analysis/hlo_collectives.py``.  The
reference parses post-SPMD HLO text and weights each collective by its
loop trip counts; the port runs its collectives explicitly, so the
record of one call of a program (``sharding/comm.py::recording``) is
already the executed list.  Byte multipliers are the reference's
ring-algorithm costs (n = group size): all-reduce 2(n-1)/n,
all-gather / all-to-all (n-1)/n, reduce-scatter (n-1)x output,
collective-permute 1x; and, the port's addition, broadcast (n-1)/n.  All
numbers are per rank.
"""

from __future__ import annotations


def _factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    return {"all-reduce": 2 * (n - 1) / n,
            "all-gather": (n - 1) / n,
            "all-to-all": (n - 1) / n,
            "reduce-scatter": float(n - 1),
            "collective-permute": 1.0,
            "broadcast": (n - 1) / n}[op]


def collective_bytes(record: list) -> dict:
    """{op: {count, bytes_moved, tensor_bytes}} of a collective record
    (``{"op", "bytes", "group_size"}`` entries)."""
    out: dict = {}
    for r in record:
        op, size = r["op"], float(r["bytes"])
        rec = out.setdefault(op, {"count": 0, "bytes_moved": 0.0,
                                  "tensor_bytes": 0.0})
        rec["count"] += 1
        rec["bytes_moved"] += size * _factor(op, r["group_size"])
        rec["tensor_bytes"] += size
    return out


def staged_ops(record: list) -> list:
    """The ops of a record that ``sharding/comm.py`` staged through host
    memory, in order."""
    return [r["op"] for r in record if r.get("staged")]


def bytes_moved(acc: dict) -> float:
    """The ring bytes a rank moves in one call, over every op of its
    :func:`collective_bytes` accounting (one decode call's, to compare
    two sharding layouts)."""
    return sum(op["bytes_moved"] for op in acc.values())
