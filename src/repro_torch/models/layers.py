"""Shared layers: norm, RoPE, embeddings, the SwiGLU MLP."""

from __future__ import annotations

import torch

from repro_torch.core.linear import linear
from repro_torch.models.param import ParamTree


def rmsnorm(x, scale, eps: float):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_tables(positions, dim: int, theta: float):
    """cos/sin tables for integer positions (any shape)."""
    half = dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (S, D/2) or (..., S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def silu(x):
    """x * sigmoid(x) in x's dtype, as the reference's ``layers.silu``."""
    return x * torch.sigmoid(x)


def init_swiglu(gen, d_model: int, d_ff: int, dtype, d_out: int = 0):
    pt = ParamTree(gen, dtype)
    pt.dense("w_gate", (d_model, d_ff), ("embed", "mlp"))
    pt.dense("w_up", (d_model, d_ff), ("embed", "mlp"))
    pt.dense("w_down", (d_ff, d_out or d_model), ("mlp", "embed"))
    return pt.build()


def swiglu(p, x):
    h = linear(x, p["w_gate"], act="silu") * linear(x, p["w_up"])
    return linear(h, p["w_down"])


def init_embed(gen, vocab: int, d_model: int, dtype, tie: bool):
    pt = ParamTree(gen, dtype)
    pt.embed("tok", (vocab, d_model), ("vocab", "embed"))
    if not tie:
        pt.dense("head", (d_model, vocab), ("embed", "vocab"))
    return pt.build()


def embed_tokens(p, tokens):
    return p["tok"][tokens]


def unembed(p, x, tie: bool):
    """Logits in the compute dtype, as in the reference."""
    w = p["tok"].T if tie else p["head"]
    return linear(x, w)
