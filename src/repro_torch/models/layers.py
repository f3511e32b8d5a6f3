"""Shared layers: norms, RoPE, sinusoidal positions, embeddings, the
SwiGLU and GELU MLPs, and the remat of a layer body."""

from __future__ import annotations

import contextvars
import functools
import math

import torch
import torch.utils.checkpoint

from repro_torch.core.linear import linear
from repro_torch.models.param import ParamTree
from repro_torch.sharding.context import (dp_full, dp_gather_cols,
                                          dp_group, dp_rank, dp_weight_cols,
                                          fsdp_split, serve_2d, shard_act,
                                          tp_copy, tp_rank, tp_split, tp_sum)


def _requires_grad(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    if isinstance(obj, dict):
        return any(map(_requires_grad, obj.values()))
    if isinstance(obj, (list, tuple)):
        return any(map(_requires_grad, obj))
    return False


def remat(cfg, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; when ``cfg.remat`` is set and autograd
    records through an argument (a tensor, or a dict of them), through
    ``torch.utils.checkpoint``: the backward recomputes ``fn``'s
    activations instead of keeping them, as the reference's
    ``jax.checkpoint`` of a layer body.  The forward's numbers are the
    same either way.  The forward and its recompute run in a copy of the
    caller's context: on a CUDA tensor autograd recomputes on a device
    thread of its own, where the sharding context
    (``sharding/context.py``) and the collective recorder would be
    unset, and a tensor-parallel layer would recompute without its
    collectives."""
    if cfg.remat and torch.is_grad_enabled() and _requires_grad(args):
        ctx = contextvars.copy_context()

        @functools.wraps(fn)
        def in_ctx(*a, **k):
            return ctx.run(fn, *a, **k)

        return torch.utils.checkpoint.checkpoint(
            in_ctx, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def rmsnorm(x, scale, eps: float):
    """RMSNorm in fp32, cast once.  A serving rank's FSDP piece of the
    scale is gathered over the data group first (``dp_full``)."""
    scale = dp_full(scale, x.shape[-1])
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x, scale, bias, eps: float):
    """LayerNorm in fp32 (mean, variance, scale and shift), cast once to
    x's dtype, as the reference's ``layers.layernorm``.  A serving rank's
    FSDP pieces of the scale and the bias are gathered over the data
    group first (``dp_full``), as :func:`rmsnorm`'s scale."""
    scale = dp_full(scale, x.shape[-1])
    bias = dp_full(bias, x.shape[-1])
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


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


def swiglu(p, x, d_ff: int = 0, d_model: int = 0):
    """w_down(silu(x @ w_gate) * (x @ w_up)).  ``d_ff``: the full hidden
    width, where ``w_gate`` / ``w_up`` may be column-parallel over ``mlp``
    (their input then passes ``tp_copy``).  ``d_model``: the full output
    width, where a serving rank's ``w_down`` may hold an FSDP piece of
    its columns (``dp_weight_cols``)."""
    if d_ff:
        x = tp_copy(x, "mlp", d_ff)
    h = linear(x, p["w_gate"], act="silu") * linear(x, p["w_up"])
    h = shard_act(h, "batch", "seq", "mlp")
    w_down = dp_weight_cols(p["w_down"], d_model) if d_model else p["w_down"]
    return linear(h, w_down)


def init_gelu_mlp(gen, d_model: int, d_ff: int, dtype, d_out: int = 0):
    pt = ParamTree(gen, dtype)
    pt.dense("w_in", (d_model, d_ff), ("embed", "mlp"))
    pt.zeros("b_in", (d_ff,), ("mlp",))
    pt.dense("w_out", (d_ff, d_out or d_model), ("mlp", "embed"))
    pt.zeros("b_out", (d_out or d_model,), ("embed",))
    return pt.build()


def gelu_mlp(p, x, d_ff: int = 0, d_model: int = 0):
    """w_out(gelu(x @ w_in + b_in)) + b_out: the bias and the tanh GELU
    of the first product run in the kernel's epilogue (``linear`` passes
    them to ``tsmm_dot``), not as a pass of their own.  ``d_ff``: the full
    hidden width, where ``w_in`` / ``b_in`` may be column- and ``w_out``
    row-parallel over ``mlp``: then the partial sums are summed over the
    TP group, ``b_out`` added in the epilogue of the first rank's
    partial only.  ``d_model``: the full output width, where a serving
    rank holds FSDP pieces of ``w_out``'s columns and ``b_out``: under
    FSDP both are gathered before use (``dp_weight_cols``, ``dp_full``);
    under 2D tensor parallelism the rank computes its columns with its
    ``b_out`` piece and they are gathered after the TP sum
    (``dp_gather_cols``).  Under 2D ``w_in``'s rows lie on the data axis
    too: a k-split whose partials are summed before ``b_in`` and the
    GELU run once on the sum (``core/tsmm.py::ksplit_sum``)."""
    h = linear(x, p["w_in"], p["b_in"], act="gelu")
    w_out, b_out = p["w_out"], p["b_out"]
    if d_model:
        w_out = dp_weight_cols(w_out, d_model)
        if not serve_2d():
            b_out = dp_full(b_out, d_model)
    if d_ff and tp_split("mlp", d_ff):
        bias = b_out if tp_rank() == 0 else None
        y = tp_sum(linear(h, w_out, bias), "mlp", d_ff)
    else:
        y = linear(h, w_out, b_out)
    return dp_gather_cols(y, d_model) if d_model else y


def sinusoidal_pos(positions, dim: int):
    """Fixed sinusoidal position encoding (fp32, ``[sin, cos]`` halves) of
    integer positions (any shape, on any device), as the reference's
    whisper adaptation: its param shapes do not depend on the longest
    sequence."""
    half = dim // 2
    # the rate rounded to fp32 where the reference rounds it, as a host
    # number (a graph capture cannot copy a host tensor to the device)
    rate = (torch.tensor(math.log(10000.0), dtype=torch.float32)
            / max(half - 1, 1)).item()
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * rate)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_embed(gen, vocab: int, d_model: int, dtype, tie: bool):
    pt = ParamTree(gen, dtype)
    pt.embed("tok", (vocab, d_model), ("vocab", "embed"))
    if not tie:
        pt.dense("head", (d_model, vocab), ("embed", "vocab"))
    return pt.build()


def embed_tokens(p, tokens, vocab: int = 0, d_model: int = 0):
    """The token table's rows of ``tokens``.  Where the table is split
    over the TP group along the vocabulary (``vocab``, its full size),
    each rank looks up the ids in its range, zeroes the rest, and the
    pieces are summed over the group.  Where a serving rank holds an
    FSDP piece of the embedding dim (``d_model``, its full size), it
    looks up its columns and they are gathered over the data group;
    under FSDP, where each data rank computes rows of its own, the ids
    are gathered first and each rank keeps its rows of the result."""
    split_v = bool(vocab) and tp_split("vocab", vocab)
    split_d = bool(d_model) and fsdp_split(d_model)
    if not (split_v or split_d):
        return shard_act(p["tok"][tokens], "batch", "seq", "embed")
    from repro_torch.sharding import comm
    own = tokens.shape[0]
    mine_only = split_d and not serve_2d()
    if mine_only:
        tokens = comm.all_gather(tokens, dp_group(), dim=0)
    if split_v:
        rows = p["tok"].shape[0]
        ids = tokens - tp_rank() * rows
        mine = (ids >= 0) & (ids < rows)
        x = p["tok"][ids.clamp(0, rows - 1)] * mine[..., None].to(
            p["tok"].dtype)
        x = tp_sum(x, "vocab", vocab)
    else:
        x = p["tok"][tokens]
    if split_d:
        x = comm.all_gather(x, dp_group(), dim=-1)
    if mine_only:
        x = x[dp_rank() * own:(dp_rank() + 1) * own]
    return shard_act(x, "batch", "seq", "embed")


def unembed(p, x, tie: bool, vocab: int = 0):
    """Logits in the compute dtype, as in the reference.  A tied model
    reads ``tok.T``, unless the serving engine gave it a packed ``head``
    of its own (``serve/engine.py::tied_head``): the transposed view
    would be padded and packed on every call.  ``vocab``: the full
    vocabulary, where the head may be column-parallel over it (its input
    then passes ``tp_copy``)."""
    if vocab:
        x = tp_copy(x, "vocab", vocab)
    w = p["tok"].T if tie and "head" not in p else p["head"]
    return shard_act(linear(x, w), "batch", "seq", "vocab")
