"""Model-facing linear op.

Every dense layer goes through :func:`linear`, where the paper's
technique meets the model:

* a pre-packed weight (the serving path) routes to the planned skinny-A
  kernel through ``tsmm_dot``;
* a plain weight whose matmul is TSMM-shaped routes through ``tsmm_dot``
  only inside :func:`serving_ctx` (the engine enters it around prefill and
  decode): the kernels have no backward, so training matmuls must never
  reach them;
* a serving rank's unpacked row piece of a weight whose rows lie on the
  data axis is gathered before use under FSDP, and contracted where it
  lies under 2D tensor parallelism;
* everything else is a plain ``torch.matmul``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.core.packing import is_packed
from repro_torch.core.plan import is_tsmm
from repro_torch.core.tsmm import ksplit_sum, tsmm_dot
from repro_torch.kernels.ref import act_ref
from repro_torch.sharding.context import (dp_group, dp_slice, fsdp_split,
                                          serve_2d)

_SERVING = threading.local()


@contextlib.contextmanager
def serving_ctx():
    """Mark the enclosed model calls as inference: TSMM-shaped unpacked
    matmuls may route through the planned kernels."""
    prev = getattr(_SERVING, "on", False)
    _SERVING.on = True
    try:
        yield
    finally:
        _SERVING.on = prev


def in_serving_ctx() -> bool:
    return getattr(_SERVING, "on", False)


def linear(x, w, b=None, act: Optional[str] = None):
    """act(x @ w + b).  ``w``: (k, n) tensor or PackedTensor."""
    if is_packed(w):
        return tsmm_dot(x, w, bias=b, act=act)
    if w.ndim == 2 and x.shape[-1] != w.shape[0] and fsdp_split(x.shape[-1]):
        if serve_2d():
            # 2D: an unpacked row piece (DeepSeek-V2's wkv_a, whose 576
            # columns no block width divides) contracted where it lies,
            # as a packed one (``tsmm_dot``'s k-split): the weights never
            # move
            part = linear(dp_slice(x, x.shape[-1]).contiguous(), w)
            return ksplit_sum(part, b, act, x.dtype)
        # FSDP: an unpacked piece of the rows, gathered before use
        from repro_torch.sharding import comm
        w = comm.all_gather(w, dp_group(), dim=0)
    if (in_serving_ctx() and w.ndim == 2
            and is_tsmm(math.prod(x.shape[:-1]), *w.shape)):
        return tsmm_dot(x, w, bias=b, act=act)
    out = torch.matmul(x, w)
    if b is not None:
        out = out + b.to(out.dtype)
    if act is not None:
        out = act_ref(out.float(), act).to(x.dtype)
    return out
