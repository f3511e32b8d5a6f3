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


def _normal(gen, shape, dtype, scale):
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(torch_dtype(dtype))


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

    def dense(self, name, shape, axes, fan_in=None):
        fan_in = fan_in if fan_in is not None else shape[0]
        return self.add(name, _normal(self.gen, shape, self.dtype,
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
    params along a new leading axis.  ``init_fn() -> (params, axes)``."""
    trees = [init_fn() for _ in range(n)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    def prepend(a):
        if isinstance(a, dict):
            return {k: prepend(v) for k, v in a.items()}
        return (stacked_axis,) + a

    return stack(*(t[0] for t in trees)), prepend(trees[0][1])


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
