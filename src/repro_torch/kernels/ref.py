"""Plain PyTorch oracles, with the reference package's fp32 semantics
(``kernels/ref.py`` there): accumulate in fp32, apply bias and the
activation to the fp32 result, cast once."""

from __future__ import annotations

import torch


def act_ref(x, act: str | None):
    if act in (None, "none"):
        return x
    if act == "relu":
        return torch.clamp_min(x, 0)
    if act == "silu":
        return x * (1 / (1 + torch.exp(-x)))
    if act == "gelu":
        # tanh approximation, as in the kernels' epilogue
        return 0.5 * x * (1 + torch.tanh(0.7978845608028654
                                         * (x + 0.044715 * x ** 3)))
    raise ValueError(act)


def tsmm_ref(a, b, *, alpha=1.0, beta=0.0, c=None, bias=None, act=None):
    """C = act(alpha * A @ B + beta * C + bias), fp32 accumulation."""
    acc = alpha * (a.float() @ b.float())
    if beta != 0.0 and c is not None:
        acc = acc + beta * c.float()
    if bias is not None:
        acc = acc + bias.float()[None, :]
    return act_ref(acc, act).to(a.dtype)


def pack_ref(a, bm, bk, *, alpha=1.0):
    """Block-major pre-pack: (..., M, K) -> (..., nm, nk, bm, bk),
    zero-padded, alpha folded in (the paper's PACKA)."""
    m, k = a.shape[-2:]
    nm, nk = -(-m // bm), -(-k // bk)
    ap = torch.nn.functional.pad(a, (0, nk * bk - k, 0, nm * bm - m))
    if alpha != 1.0:
        ap = ap * alpha
    return ap.reshape(*a.shape[:-2], nm, bm, nk, bk).transpose(-3, -2).contiguous()


def unpack_ref(ap, m, k):
    nm, nk, bm, bk = ap.shape[-4:]
    full = ap.transpose(-3, -2).reshape(*ap.shape[:-4], nm * bm, nk * bk)
    return full[..., :m, :k]
