"""Wrappers around the TSMM kernels.

Responsibilities, as in the reference package's ``kernels/ops.py``:
  * pad operands to the kernels' shapes and slice the result back;
  * pick the implementation: the hand-written CUDA kernel for CUDA
    tensors, the plain PyTorch version (the same math on the same layout)
    for CPU tensors — the choice lives in each ``kernels/tsmm.py``
    wrapper;
  * pack/unpack as layout transforms (a CUDA tensor packs through the
    pack kernel).

The skinny kernel masks ragged rows itself, so nothing here pads X rows
to a sublane multiple; the tall wrappers keep the reference's padding of
M to the row block and pad N to the tall designs' width
(``kernels/tsmm.py::tall_width``: 128 columns for bf16, as the reference
pads every dtype; a multiple of 8 for fp32).
"""

from __future__ import annotations

import torch
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


def sublane(dtype) -> int:
    """The reference's row granularity per dtype (its TPU sublane tile),
    kept so the tall wrappers pad M exactly as the reference does."""
    return {torch.float32: 8, torch.bfloat16: 16, torch.float16: 16}.get(
        dtype, 8)


def pack_blocks(a, bm: int, bk: int, alpha: float = 1.0):
    """(M, K) -> (nm, nk, bm, bk) block-major, zero-padded, alpha folded,
    bit-identical to the reference's layout: the pack kernel for a CUDA
    tensor, the plain reshape/transpose on the CPU."""
    return _k.pack_blocks_kernel(a, bm, bk, alpha=alpha)


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


def tall_row_block(m: int, bm: int, dtype) -> int:
    """The row block a natural tall A of ``m`` rows is padded to: ``bm``,
    capped at ``m`` rounded up to the reference's sublane."""
    return min(bm, _ceil_to(m, sublane(dtype)))


def pad_tall(a, b, bm: int, bk: int):
    """Pad a natural tall-A pair to the kernel's shapes: M to the row block
    (itself capped at M rounded up to the sublane), K to bk, N to
    :func:`~repro_torch.kernels.tsmm.tall_width`.  Returns (a_pad, b_pad,
    bm_eff)."""
    m, k = a.shape
    bm_ = tall_row_block(m, bm, a.dtype)
    mp, kp = _ceil_to(m, bm_), _ceil_to(k, bk)
    return (pad2(a, mp, kp).contiguous(),
            pad2(b, kp, _k.tall_width(b.shape[1], b.dtype)).contiguous(), bm_)


def pad_b_for_packed(ap, b):
    """Pad B to a packed A's K (nk * bk) and its columns to
    :func:`~repro_torch.kernels.tsmm.tall_width`."""
    _, nk, _, bk = ap.shape
    return pad2(b, nk * bk, _k.tall_width(b.shape[1], b.dtype)).contiguous()


def tsmm(a, b, bias=None, *, bm: int = 512, bk: int = 512, act=None,
         dims: tuple = (), m_split: int = 1):
    """Unpacked tall-A TSMM: act(A @ B + bias), fused into the kernel's
    store (padded by :func:`pad_tall`, sliced back).  ``dims``/``m_split``
    (the plan's TPU grid schedule) have no effect on the card."""
    m, n = a.shape[0], b.shape[1]
    ap, bp, bm_ = pad_tall(a, b, bm, bk)
    out = _k.tsmm_tall_a(ap, bp, _pad_bias(bias, bp.shape[1]), bm=bm_, bk=bk,
                         act=act, dims=dims, m_split=m_split)
    return out[:m, :n]


def tsmm_packed(ap, b, bias=None, *, act=None, dims: tuple = (),
                m_split: int = 1):
    """Packed tall-A TSMM: act(unpack(Ap) @ B + bias) with Ap (nm, nk, bm,
    bk); returns (nm*bm, N) (the caller slices rows)."""
    n = b.shape[1]
    bp = pad_b_for_packed(ap, b)
    out = _k.tsmm_packed_a(ap, bp, _pad_bias(bias, bp.shape[1]), act=act,
                           dims=dims, m_split=m_split)
    return out[:, :n]
