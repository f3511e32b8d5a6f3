"""Parameter creation, logical-axis bookkeeping, and conversion from the
reference package's parameters.

Every leaf is created with an explicit tuple of logical axis names,
building a parameter tree and an axes tree of identical structure (nested
dicts), as in the reference (``models/param.py`` there).  Values come
from an explicit ``torch.Generator``; they differ from the reference's
``jax.random`` values for the same seed, so comparisons with the
reference carry its parameters over with :func:`params_from_numpy`.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted: a
    tree built from it lives on the ``meta`` device and allocates nothing
    (``models/registry.py::param_count``)."""

    device = torch.device("meta")


def _normal(gen, shape, dtype, scale):
    x = torch.randn(shape, device=gen.device, dtype=torch.float32,
                    generator=None if gen.device.type == "meta" else gen)
    # scaled in place: a stacked expert leaf's fp32 draw is held once
    return x.mul_(scale).to(torch_dtype(dtype))


class ParamTree:
    """Collects ``(value, logical_axes)`` pairs under string names; every
    random leaf draws from the one generator in creation order."""

    def __init__(self, gen: torch.Generator, dtype):
        self.gen = gen
        self.dtype = torch_dtype(dtype)
        self._params: dict = {}
        self._axes: dict = {}

    def add(self, name: str, value, axes: tuple):
        if name in self._params:
            raise ValueError(f"duplicate param {name}")
        if len(axes) != value.ndim:
            raise ValueError(f"{name}: axes {axes} vs shape {tuple(value.shape)}")
        self._params[name] = value
        self._axes[name] = axes
        return value

    def dense(self, name, shape, axes, fan_in=None, dtype=None):
        """A scaled normal leaf in the tree's dtype, or in ``dtype`` (the
        MoE router is float32 in a bf16 model)."""
        fan_in = fan_in if fan_in is not None else shape[0]
        return self.add(name, _normal(self.gen, shape, dtype or self.dtype,
                                      1.0 / math.sqrt(max(fan_in, 1))), axes)

    def embed(self, name, shape, axes):
        return self.add(name, _normal(self.gen, shape, self.dtype, 0.02), axes)

    def zeros(self, name, shape, axes):
        return self.add(name, torch.zeros(shape, dtype=self.dtype,
                                          device=self.gen.device), axes)

    def ones(self, name, shape, axes):
        return self.add(name, torch.ones(shape, dtype=self.dtype,
                                         device=self.gen.device), axes)

    def sub(self, name: str, params_axes: tuple):
        """Attach a ``(params, axes)`` pair from a nested init call."""
        params, axes = params_axes
        self._params[name] = params
        self._axes[name] = axes
        return params

    def build(self):
        return self._params, self._axes


def stack_inits(init_fn: Callable, n: int, stacked_axis: str = "layers"):
    """Initialize ``n`` structurally-identical layers and stack their
    params along a new leading axis.  ``init_fn() -> (params, axes)``.

    The layers are drawn one at a time, in order, each copied into its
    slot of the preallocated stack and then freed, so the peak is the
    stack plus one layer (a layer of 160 experts is 7.5 GB in bf16)."""
    params0, axes0 = init_fn()
    stacked = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                             device=t.device), params0)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(stacked, params0, 0)
    del params0
    for i in range(1, n):
        put(stacked, init_fn()[0], i)

    def prepend(a):
        if isinstance(a, dict):
            return {k: prepend(v) for k, v in a.items()}
        return (stacked_axis,) + a

    return stacked, prepend(axes0)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_torch(a: np.ndarray, device):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # e.g. a view of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch.from_numpy path: move the bits
        t = torch.from_numpy(a.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """Carry the reference's parameters (nested dicts of numpy arrays,
    layer-stacked) into the port unchanged in layout and bit-exact in
    value, on ``device``."""
    return tree_map(lambda a: _to_torch(np.asarray(a), device), tree)
