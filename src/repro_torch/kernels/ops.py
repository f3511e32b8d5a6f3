"""Wrappers around the skinny-A TSMM kernel.

Responsibilities, as in the reference package's ``kernels/ops.py``:
  * pad operands to the packed layout's shapes and slice the result back;
  * pick the implementation: ``cuda`` (the hand-written kernel) for CUDA
    tensors, ``torch`` (the plain blocked einsum, same math on the same
    packed layout) for CPU tensors;
  * pack/unpack as layout transforms.

The kernel masks ragged rows itself, so unlike the TPU wrappers nothing
here pads X rows to a sublane multiple.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tsmm as _k


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def pad2(x, m, n):
    pm, pn = m - x.shape[0], n - x.shape[1]
    if pm == 0 and pn == 0:
        return x
    return F.pad(x, (0, pn, 0, pm))


def pack_blocks(a, bm: int, bk: int, alpha: float = 1.0):
    """(M, K) -> (nm, nk, bm, bk) block-major, zero-padded, alpha folded:
    a reshape, bit-identical to the reference's layout."""
    return _ref.pack_ref(a, bm, bk, alpha=alpha)


def unpack_blocks(ap, m: int, k: int):
    return _ref.unpack_ref(ap, m, k)


def _torch_skinny_a(x, wp, bias, act):
    """The plain blocked twin of the baseline kernel (the reference's
    ``_xla_skinny_a``): an einsum over the packed blocks with fp32
    accumulation, bias and activation on the fp32 result, one cast."""
    return _k._torch_skinny(x, wp, bias, act, natural=False, splits=1,
                            mode=_k.EPILOGUE)


def _pad_bias(bias, npad: int):
    if bias is None:
        return None
    return F.pad(bias, (0, npad - bias.shape[0]))


def tsmm_skinny(x, wp, bias=None, *, act=None):
    """Skinny-A x packed-W with fused epilogue: act(X @ W + bias).

    X (m, K) — m is the skinny dim; Wp (nk, nn, bk, bn).  Returns
    (m, bias width) with a bias, else (m, nn*bn)."""
    m = x.shape[0]
    nk, nn, bk, bn = wp.shape
    n = nn * bn
    xp = pad2(x, m, nk * bk).contiguous()
    out = _k.tsmm_skinny_a(xp, wp, _pad_bias(bias, n), act=act)
    return out[:, : (bias.shape[0] if bias is not None else n)]
