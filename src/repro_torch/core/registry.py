"""In-memory plan registry — the runtime stage's plan cache.

Keyed like the reference (``core/registry.py``): ``platform/problem.key()``
with one winning :class:`~repro_torch.core.plan.Plan` each.  The platform
part comes from the torch device the plan serves: ``"cpu"`` or the CUDA
device's name, where the reference uses ``jax.default_backend()``.

A measured plan is never replaced by a model-ranked one unless forced
(the reference's provenance guard).  Persistence, the measurement cache,
the miss log and the find-db overlay are later slices.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.plan import Plan


def platform(device) -> str:
    """The registry's platform key for a torch device."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class Registry:
    """One in-memory plan map with hit/miss counters, guarded by a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._mem: dict[str, Plan] = {}
        self._stats = {"hits": 0, "misses": 0}

    def get(self, problem_key: str, device) -> Optional[Plan]:
        key = f"{platform(device)}/{problem_key}"
        with self._lock:
            plan = self._mem.get(key)
            self._stats["hits" if plan is not None else "misses"] += 1
            return plan

    def peek(self, problem_key: str, device) -> Optional[Plan]:
        """Lookup without touching the hit/miss counters."""
        key = f"{platform(device)}/{problem_key}"
        with self._lock:
            return self._mem.get(key)

    def put(self, plan: Plan, device, force: bool = False) -> Plan:
        """Insert ``plan``; returns the plan that stands afterwards."""
        key = f"{platform(device)}/{plan.problem.key()}"
        with self._lock:
            cur = self._mem.get(key)
            if (force or cur is None or cur.chosen_by != "measured"
                    or plan.chosen_by == "measured"):
                self._mem[key] = plan
            return self._mem[key]

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def reset_stats(self) -> None:
        with self._lock:
            self._stats["hits"] = self._stats["misses"] = 0

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._stats["hits"] = self._stats["misses"] = 0


_DEFAULT = Registry()


def default() -> Registry:
    return _DEFAULT


def get(problem_key: str, device) -> Optional[Plan]:
    return _DEFAULT.get(problem_key, device)


def peek(problem_key: str, device) -> Optional[Plan]:
    return _DEFAULT.peek(problem_key, device)


def put(plan: Plan, device, force: bool = False) -> Plan:
    return _DEFAULT.put(plan, device, force=force)


def stats() -> dict:
    return _DEFAULT.stats()


def reset_stats() -> None:
    _DEFAULT.reset_stats()
