"""Attention: chunked online-softmax attention for prefill, cache-based
decode (sliding-window included), the GQA block with its cross-attention
form, and MLA (DeepSeek-V2) with the absorbed decode over the compressed
KV cache.

The port of the reference's ``models/attention.py``.  On a CUDA device,
full-window self-attention from position 0 with a sequence length that
is a multiple of 256, V as wide as Q and K, and a head dim the flash
kernel takes runs the flash kernel (``kernels/flash_attention.py``);
everything else — the CPU, ragged (left-padded) batches, offsets, a
sliding window, cross-attention (whisper's decoder over its encoder's
1500 frames), MLA's 192-wide Q/K against its 128-wide V, and any call
autograd records (a training step: the kernel has no backward) — runs
the chunked torch body below, the counterpart of the reference's jnp
path.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import linear
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.layers import apply_rope, rmsnorm, rope_tables
from repro_torch.models.param import ParamTree
from repro_torch.sharding.context import (axis_group, cache_layout,
                                          dp_gather_cols, dp_weight_cols,
                                          gather_rows, get_ctx, row_start,
                                          shard_act, tp_copy, tp_sum)

NEG_INF = -1e30


def _divisor_chunk(s: int, chunk: int) -> int:
    """Largest chunk <= ``chunk`` that divides s."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _chunk_mask(q_pos, k_pos, window, causal, valid_from):
    """(B or 1, Cq, Ck) keep-mask of one (q-chunk x k-chunk) tile."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    if valid_from is None:
        return mask[None]
    return mask[None] & (k_pos[None, None, :] >= valid_from[:, None, None])


def flash_eligible(q, k, v, *, window: int, q_offset, k_offset,
                   valid_from) -> bool:
    """Whether the flash kernel takes this call: full-window
    self-attention on the card from position 0 (host-int offsets), no
    per-row pad mask, a sequence length that is a multiple of 256, V as
    wide as Q and K, a head dim in ``HEAD_DIMS``, and autograd not
    recording through q, k or v.  A predicate of shapes, dtype, offsets
    and the grad mode only.

    The kernel writes a fresh tensor through raw pointers: its output has
    no ``grad_fn``, and it has no backward (nor has the reference's Pallas
    kernel).  A training step through it would drop every gradient that
    flows through attention into ``wq`` / ``wk`` / ``wv`` without an
    error, so a call that autograd records takes the chunked body, as
    ``core/linear.py`` keeps the TSMM kernels to ``serving_ctx``.
    Serving runs under ``torch.inference_mode()``, where no tensor
    requires grad, and keeps every flash launch."""
    # the offsets are compared only when they are host ints: a 0-d device
    # offset (a captured ``prefill_row``) never reaches ``bool()``, which
    # would sync the host (and fail inside a capture)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return False
    return (valid_from is None and q.is_cuda and window == 0
            and isinstance(q_offset, int) and isinstance(k_offset, int)
            and q_offset == 0 and k_offset == 0
            and q.shape[1] == k.shape[1] and q.shape[1] % 256 == 0
            and v.shape[-1] == q.shape[-1] and q.shape[-1] in HEAD_DIMS)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 512, q_offset: int = 0, k_offset=None,
                      valid_from=None):
    """q: (B,Sq,H,D)  k: (B,Sk,KH,D)  v: (B,Sk,KH,Dv).  Returns
    (B,Sq,H,Dv).

    Online softmax over q chunks (outer) and k chunks (inner) carrying
    fp32 m / l / acc; the scale is ``D ** -0.5``.  ``q_offset`` /
    ``k_offset`` (defaulting to ``q_offset``) are ints or 0-d device
    tensors; ``valid_from``: (B,) absolute first-real-token position per
    row."""
    if k_offset is None:
        k_offset = q_offset
    if flash_eligible(q, k, v, window=window, q_offset=q_offset,
                      k_offset=k_offset, valid_from=valid_from):
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    scale = d ** -0.5
    cq, ck = _divisor_chunk(sq, chunk), _divisor_chunk(sk, chunk)
    qg = q.reshape(b, sq, kh, g, d).float()
    kf, vf = k.float(), v.float()
    dev = q.device
    outs = []
    for q0 in range(0, sq, cq):
        qc = qg[:, q0:q0 + cq]
        qpos = q_offset + torch.arange(q0, q0 + cq, device=dev)
        m = torch.full((b, kh, g, cq), NEG_INF, device=dev)
        l = torch.zeros((b, kh, g, cq), device=dev)
        acc = torch.zeros((b, kh, g, cq, dv), device=dev)
        for k0 in range(0, sk, ck):
            kpos = k_offset + torch.arange(k0, k0 + ck, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf[:, k0:k0 + ck]) * scale
            keep = _chunk_mask(qpos, kpos, window, causal, valid_from)
            s = s.masked_fill(~keep[:, None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k0 + ck])
            m = m_new
        out = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))       # (b, cq, kh, g, dv)
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv)


def decode_attention(q, k_cache, v_cache, k_pos, cur_pos, *,
                     window: int = 0, valid_from=None):
    """One-step attention.  q: (B,1,H,D); caches (B,S,KH,D); k_pos (S,)
    absolute position held by each cache slot (-1 = empty); ``cur_pos``
    the step's position (an int or a 0-d tensor on the device); valid_from
    (B,) per-row first valid position."""
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * d ** -0.5
    valid = (k_pos >= 0) & (k_pos <= cur_pos)
    if window:
        valid &= cur_pos - k_pos < window
    if valid_from is not None:
        keep = valid[None, :] & (k_pos[None, :] >= valid_from[:, None])
        s = s.masked_fill(~keep[:, None, None], NEG_INF)
    else:
        s = s.masked_fill(~valid[None, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_partial(q, k_cache, v_cache, k_pos, cur_pos, *, window: int = 0,
                   valid_from=None) -> tuple:
    """One piece of a cache split along its sequence: the step's scores
    over the piece's slots (``k_pos`` their absolute positions, -1 =
    empty; the rest as :func:`decode_attention`) reduced to fp32
    ``(m, l, acc)``: the largest kept score (B, KH, G), the sum of
    ``exp(s - m)`` and the ``exp(s - m)``-weighted sum of V (B, KH, G,
    Dv).  A piece with no kept slot (early in a decode, or masked)
    returns ``m = -inf``, ``l = 0`` and ``acc = 0`` exactly."""
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * d ** -0.5
    valid = (k_pos >= 0) & (k_pos <= cur_pos)
    if window:
        valid &= cur_pos - k_pos < window
    if valid_from is not None:
        keep = valid[None, :] & (k_pos[None, :] >= valid_from[:, None])
    else:
        keep = valid[None, :]
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhgk,bkhd->bhgd", p,
                                          v_cache.float())


def combine_partials(m, l, acc):
    """The softmax-weighted V of the whole sequence from its pieces'
    :func:`decode_partial` results stacked on a leading piece dim: the
    log-sum-exp combine.  A piece whose ``m`` is ``-inf`` weighs exactly
    zero (never ``exp(-inf - -inf)``); the result is fp32 (B, KH, G,
    Dv)."""
    top = m.amax(dim=0)
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(top), 0.0, top)))
    den = (w * l).sum(dim=0)
    num = (w[..., None] * acc).sum(dim=0)
    return num / torch.clamp_min(den, 1e-30)[..., None]


def split_decode_attention(q, k_cache, v_cache, k_pos, cur_pos, axis: str,
                           *, window: int = 0, valid_from=None):
    """:func:`decode_attention` over a cache whose slots are split over
    ``axis``: this rank's piece (``k_pos`` its slots' positions) reduced
    to ``(m, l, acc)``, the pieces gathered over the axis's group in one
    all-gather and combined (:func:`combine_partials`).  Nothing reads
    the position on the host."""
    from repro_torch.sharding import comm
    b, _, h, d = q.shape
    m, l, acc = decode_partial(q, k_cache, v_cache, k_pos, cur_pos,
                               window=window, valid_from=valid_from)
    mine = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    every = comm.all_gather(mine[None], axis_group(axis)[0], dim=0)
    out = combine_partials(every[..., 0], every[..., 1], every[..., 2:])
    return out.reshape(b, 1, h, acc.shape[-1]).to(q.dtype)


def write_slot(slab, slot, t, seq=None):
    """Write the step's K or V ``t`` (B, 1, ...) into slot ``slot`` ((1,)
    on the device) of ``slab`` (B, S, ...) in place; where the slots are
    split over ``seq``, only on the rank that holds the slot (the others
    write back what they hold), without reading the host."""
    if seq is None:
        slab.index_copy_(1, slot, t)
        return
    _, j, _ = axis_group(seq)
    n = slab.shape[1]
    local = slot - j * n
    own = ((local >= 0) & (local < n)).reshape(1, 1, *([1] * (t.ndim - 2)))
    at = local.clamp(0, n - 1)
    slab.index_copy_(1, at, torch.where(own, t.to(slab.dtype),
                                        slab.index_select(1, at)))


def write_prompt(slab, t, s: int, lay=None):
    """Write a prompt's K or V ``t`` (B, s, ...) into its slots of
    ``slab`` (B, S, ...) in place: slots ``[0, s)``, or, where the cell's
    ``CacheLayout`` ``lay`` splits the slots over an axis, the part of
    them the rank's piece holds."""
    n = slab.shape[1]
    a = axis_group(lay.seq)[1] * n if lay is not None and lay.seq else 0
    m = max(0, min(s - a, n))
    slab[:, :m] = t[:, a:a + m]


def init_gqa(gen, cfg, d_in: int = 0, d_out: int = 0):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d_in = d_in or d
    pt = ParamTree(gen, cfg.dtype)
    pt.dense("wq", (d_in, h * hd), ("embed", "qheads"))
    pt.dense("wk", (d_in, kh * hd), ("embed", "kvheads"))
    pt.dense("wv", (d_in, kh * hd), ("embed", "kvheads"))
    pt.dense("wo", (h * hd, d_out or d), ("qheads", "embed"))
    if cfg.qkv_bias:
        pt.zeros("bq", (h * hd,), ("qheads",))
        pt.zeros("bk", (kh * hd,), ("kvheads",))
        pt.zeros("bv", (kh * hd,), ("kvheads",))
    return pt.build()


def _qkv(p, cfg, x, kv_from=None):
    """q, k, v of x (k, v of ``kv_from`` when given), with the head counts
    read off the weights: a tensor-parallel rank holds its heads only.
    Each input of the column-parallel projections passes ``tp_copy`` once
    (self-attention's q, k and v share it)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    x = tp_copy(x, "qheads", cfg.num_heads * hd)
    src = x if kv_from is None else tp_copy(kv_from, "kvheads",
                                            cfg.num_kv_heads * hd)
    sk = src.shape[1]
    h, kh = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = linear(src, p["wk"], p.get("bk")).reshape(b, sk, kh, hd)
    v = linear(src, p["wv"], p.get("bv")).reshape(b, sk, kh, hd)
    return q, k, v


def gqa_forward(p, cfg, x, *, causal=True, pos_offset: int = 0,
                chunk: int = 512, use_rope: bool = True, kv_from=None,
                valid_from=None):
    """Full-sequence attention (prefill).  Returns (out, (k, v)).
    ``kv_from``: the cross-attention source sequence (whisper's encoder
    output): K and V are projected from it and start at position 0."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, kv_from=kv_from)
    if use_rope:
        pos = pos_offset + torch.arange(s, device=x.device)
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = shard_act(q, "batch", "seq", "heads", None)
    k = shard_act(k, "batch", "seq", "kvheads", None)
    v = shard_act(v, "batch", "seq", "kvheads", None)
    out = chunked_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window, chunk=chunk,
                            q_offset=pos_offset,
                            k_offset=0 if kv_from is not None else None,
                            valid_from=valid_from)
    out = out.reshape(b, s, q.shape[2] * cfg.head_dim)
    return _out_proj(p, cfg, out), (k, v)


def _out_proj(p, cfg, out):
    """``wo``, row-parallel over the heads: its partial sums are summed
    over the TP group where the heads are split.  Under 2D tensor
    parallelism (its columns on the data axis) each rank computes its
    columns, gathered over the data group after the sum; under FSDP an
    unpacked piece is gathered before use (a packed one in
    ``tsmm_dot``)."""
    y = linear(out, dp_weight_cols(p["wo"], cfg.d_model))
    y = tp_sum(y, "qheads", cfg.num_heads * cfg.head_dim)
    return dp_gather_cols(y, cfg.d_model)


def gqa_decode(p, cfg, x, cache_k, cache_v, slot_pos, cur_pos, slot, *,
               use_rope: bool = True, valid_from=None):
    """One token.  x: (B,1,d); ``cur_pos`` the step's position, a 0-d int
    tensor on the device, and ``slot`` its cache slot, (1,) int64 on the
    device (``cur_pos`` itself, or ``cur_pos % S`` under a sliding
    window: the caller computes it on the device); caches (B,S,KH,D) are
    updated IN PLACE at ``slot``; slot_pos (S,) absolute position per
    slot (already updated by the caller).  Nothing here reads the
    position on the host, so a captured step replays at whatever
    position the cache holds, past a window's wrap too.

    Under the ambient cell's ``CacheLayout`` (a sharded serving engine):
    where every rank computes the whole bucket but holds a piece of the
    cache's rows (2D tensor parallelism), the rank writes and attends
    over its rows and the attention output is gathered over the rows'
    group before ``wo``; where the cache's slots are split (``slot_pos``
    stays whole), the step's K/V lands on the rank that holds the slot
    and the softmax is combined over the slots' group
    (:func:`split_decode_attention`)."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    if use_rope:
        cos, sin = rope_tables(cur_pos.reshape(1), cfg.head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    lay = cache_layout()
    seq = lay.seq if lay is not None else None
    gathered = lay is not None and lay.gathered
    if gathered:                         # this rank's rows of the bucket
        rows = cache_k.shape[0]
        r0 = row_start(lay, rows)
        q, k, v = (t[r0:r0 + rows] for t in (q, k, v))
    write_slot(cache_k, slot, k, seq)
    write_slot(cache_v, slot, v, seq)
    if seq is not None:
        _, j, _ = axis_group(seq)
        n = cache_k.shape[1]
        out = split_decode_attention(
            q, cache_k, cache_v, slot_pos[j * n:(j + 1) * n], cur_pos, seq,
            window=cfg.sliding_window, valid_from=valid_from)
    else:
        out = decode_attention(q, cache_k, cache_v, slot_pos, cur_pos,
                               window=cfg.sliding_window,
                               valid_from=valid_from)
    if gathered:
        out = gather_rows(lay, out)
    return _out_proj(p, cfg, out.reshape(b, 1, q.shape[2] * cfg.head_dim))


def cross_decode(p, cfg, x, cross_k, cross_v):
    """The decoder's cross-attention step: q from x (B,1,d) against the
    encoder's K/V (B,T,KH,D), projected once at prefill and read by every
    step (every key valid).  On a tensor-parallel mesh the rank's heads
    (read off ``wq``) against its heads of the cross cache, ``wo``'s
    partial sums summed over the TP group.  Under a gathered cell layout
    (2D tensor parallelism: every rank computes the whole bucket while
    the cross cache holds its rows), as :func:`gqa_decode`: the rank's
    rows of ``q`` attend over its rows of the cache and the output is
    gathered over the rows' group before ``wo``."""
    b = x.shape[0]
    hd = cfg.head_dim
    h = p["wq"].shape[-1] // hd
    q = linear(x, p["wq"], p.get("bq")).reshape(b, 1, h, hd)
    lay = cache_layout()
    gathered = lay is not None and lay.gathered
    if gathered:                         # this rank's rows of the bucket
        rows = cross_k.shape[0]
        r0 = row_start(lay, rows)
        q = q[r0:r0 + rows]
    kpos = torch.arange(cross_k.shape[1], device=x.device)
    out = decode_attention(q, cross_k, cross_v, kpos, cross_k.shape[1] - 1)
    if gathered:
        out = gather_rows(lay, out)
    return _out_proj(p, cfg, out.reshape(b, 1, h * hd))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank q/kv, decoupled rope, absorbed decode
# ---------------------------------------------------------------------------


def init_mla(gen, cfg):
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    pt = ParamTree(gen, cfg.dtype)
    pt.dense("wq_a", (d, qr), ("embed", "lora"))
    pt.ones("q_norm", (qr,), ("lora",))
    pt.dense("wq_b", (qr, h * (dn + dr)), ("lora", "qheads"))
    pt.dense("wkv_a", (d, kvr + dr), ("embed", "lora"))
    pt.ones("kv_norm", (kvr,), ("lora",))
    pt.dense("wkv_b", (kvr, h * (dn + dv)), ("lora", "qheads"))
    pt.dense("wo", (h * dv, d), ("qheads", "embed"))
    return pt.build()


def _mla_heads(p, cfg) -> int:
    """The heads this rank holds (read off ``wq_b``: a tensor-parallel
    rank holds whole heads of ``wq_b``, ``wkv_b`` and ``wo``)."""
    return p["wq_b"].shape[-1] // (cfg.head_dim + cfg.rope_head_dim)


def _mla_qkv_train(p, cfg, x, pos):
    """q, k, v (the rank's heads) and the latent cache's ``c_kv`` /
    ``k_rope`` of a sequence.  ``wq_a``, ``wkv_a`` and both norms are whole
    on every rank, the heads' ``wq_b`` / ``wkv_b`` split: where autograd
    records, Megatron's *f* stands on ``cq`` (after ``q_norm``), on
    ``c_kv`` (after ``kv_norm``) and on ``k_rope`` (which meets the rank's
    heads in the scores), so the whole leaves' gradients are full on
    every rank with no other collective (an *f* on ``ckv`` before the norm
    would leave ``kv_norm``'s gradient the rank's heads' partial)."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = _mla_heads(p, cfg)
    kvr = cfg.kv_lora_rank
    heads = cfg.num_heads * (dn + dr)
    cq = tp_copy(rmsnorm(linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps),
                 "qheads", heads)
    q = linear(cq, p["wq_b"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = linear(x, p["wkv_a"])
    c_kv = tp_copy(rmsnorm(ckv[..., :kvr], p["kv_norm"], cfg.norm_eps),
                   "qheads", heads)
    k_rope = tp_copy(ckv[..., kvr:], "qheads", heads)[:, :, None, :]
    kv = linear(c_kv, p["wkv_b"]).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = rope_tables(pos, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    return q_full, k_full, v, c_kv, k_rope[:, :, 0, :]


def _mla_out(p, cfg, o):
    """``wo``, row-parallel over the heads, summed over the TP group
    where the heads are split; its columns on the data axis as
    :func:`_out_proj`'s (gathered before use under FSDP where unpacked,
    the output's gathered after the sum under 2D)."""
    y = linear(o, dp_weight_cols(p["wo"], cfg.d_model))
    y = tp_sum(y, "qheads", cfg.num_heads * cfg.v_head_dim)
    return dp_gather_cols(y, cfg.d_model)


def mla_forward(p, cfg, x, *, pos_offset=0, chunk: int = 512,
                valid_from=None):
    """Prefill MLA.  Returns (out, (c_kv, k_rope)) for the cache.  Q/K are
    head_dim + rope_head_dim wide and V v_head_dim, so the flash kernel's
    gate refuses them and the chunked body runs (the softmax scale uses
    the full Q width, as in the reference).  A tensor-parallel rank
    attends with its heads over the whole prompt (``wkv_a`` has no head
    dim, so every rank computes the compressed cache of every position of
    the rows it computes: whole, gathered over ``data`` under FSDP, or
    contracted where it lies and summed under 2D; the caller writes the
    rows and slots it holds)."""
    b, s, _ = x.shape
    pos = pos_offset + torch.arange(s, device=x.device)
    q, k, v, c_kv, k_rope = _mla_qkv_train(p, cfg, x, pos)
    out = chunked_attention(q, k, v, causal=True, chunk=chunk,
                            q_offset=pos_offset, valid_from=valid_from)
    out = out.reshape(b, s, q.shape[2] * cfg.v_head_dim)
    return _mla_out(p, cfg, out), (c_kv, k_rope)


def _mla_scores(q_c, q_rope, cache_c, cache_kr, cur_pos, valid_from,
                scale: float, first=0):
    """The absorbed decode's scores (B, h, S) of the c-space query ``q_c``
    (fp32) and ``q_rope`` over a latent cache (``cache_c`` / ``cache_kr``,
    whose slot 0 holds position ``first``), masked at the finite
    ``NEG_INF`` past ``cur_pos`` and before ``valid_from``; and the cache's
    ``c`` in fp32."""
    cf = cache_c.float()
    s = (torch.einsum("bhc,bsc->bhs", q_c, cf)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), cache_kr.float()))
    s = s * scale
    pos_s = first + torch.arange(cache_c.shape[1], device=cf.device)
    keep = (pos_s <= cur_pos)[None, :]
    if valid_from is not None:
        keep = keep & (pos_s[None, :] >= valid_from[:, None])
    return s.masked_fill(~keep[:, None], NEG_INF), cf


def _mla_split_attend(cfg, q_c, q_rope, cache_c, cache_kr, cur_pos,
                      valid_from, seq: str, scale: float):
    """The absorbed decode's c-space output over a latent cache whose
    slots are split over ``seq`` (this rank's ``cache_c`` / ``cache_kr``
    piece; nothing read on the host).  Where the rank holds some of the
    heads and the slots lie on the same (TP) axis, every head's query
    (``q_c`` fp32, ``q_rope``) is gathered over the axis first, each rank
    scores every head over its own slots, and after the combine keeps
    its heads' rows.  Each piece's (m, l, weighted ``c``) is gathered in
    one all-gather and combined (:func:`combine_partials`).  The masked
    scores are the one-rank decode's finite ``NEG_INF``, so a row with no
    valid slot anywhere (an idle queue row) averages every slot, as its
    softmax does, and a piece with none weighs exactly zero beside one
    that has some."""
    from repro_torch.sharding import comm
    group, j, _ = axis_group(seq)
    kvr = cfg.kv_lora_rank
    h = q_c.shape[1]
    qq = torch.cat([q_c, q_rope.float()], dim=-1)             # (B,h,kvr+dr)
    every_head = h < cfg.num_heads and seq == get_ctx().opts.tp_axis
    if every_head:
        qq = comm.all_gather(qq, group, dim=1)
    s, cf = _mla_scores(qq[..., :kvr], qq[..., kvr:], cache_c, cache_kr,
                        cur_pos, valid_from, scale,
                        first=j * cache_c.shape[1])
    m = s.amax(dim=-1)
    pw = torch.exp(s - m[..., None])
    mine = torch.cat([m[..., None], pw.sum(dim=-1)[..., None],
                      torch.einsum("bhs,bsc->bhc", pw, cf)], dim=-1)
    every = comm.all_gather(mine[None], group, dim=0)
    o_c = combine_partials(every[..., 0], every[..., 1], every[..., 2:])
    return o_c[:, j * h:(j + 1) * h] if every_head else o_c


def mla_decode(p, cfg, x, cache_c, cache_kr, cur_pos, slot, *,
               valid_from=None):
    """Absorbed-matrix decode of one token over the compressed cache.

    x: (B,1,d); cache_c (B,S,kvr) and cache_kr (B,S,dr) are written IN
    PLACE at ``slot`` ((1,) int64 on the device); ``cur_pos`` is the
    step's position, a 0-d int tensor on the device (RoPE and the mask),
    so nothing reads the host.  ``wkv_b`` is unpacked on every step (the
    absorbed products take it per head, as in the reference), and the
    q -> c-space and c -> v absorptions run in fp32.

    On a tensor-parallel mesh the rank holds its heads of ``wq_b``,
    ``wkv_b`` and ``wo``; where the cell's ``CacheLayout`` splits the
    latent cache's slots, the step's ``c`` / ``kr`` land on the rank that
    holds the slot and the softmax is combined over the slots' group
    (:func:`_mla_split_attend`).  Where every rank computes the whole
    bucket over a piece of the cache's rows (2D tensor parallelism: rows
    on ``data``, slots on ``model``), the rank writes and attends over
    its rows, and the heads' output is gathered over the rows' group
    before ``wo``."""
    b = x.shape[0]
    dn, dr, dv, kvr = (cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                       cfg.kv_lora_rank)
    h = _mla_heads(p, cfg)
    cq = rmsnorm(linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = linear(cq, p["wq_b"]).reshape(b, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_tables(cur_pos.reshape(1), dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]      # (B,h,dr)

    ckv = linear(x[:, 0], p["wkv_a"])
    c_new = rmsnorm(ckv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    kr_new = apply_rope(ckv[..., kvr:][:, None, None], cos, sin)[:, 0, 0]
    lay = cache_layout()
    seq = lay.seq if lay is not None else None
    gathered = lay is not None and lay.gathered
    if gathered:                         # this rank's rows of the bucket
        rows = cache_c.shape[0]
        r0 = row_start(lay, rows)
        q_nope, q_rope, c_new, kr_new = (
            t[r0:r0 + rows] for t in (q_nope, q_rope, c_new, kr_new))
    write_slot(cache_c, slot, c_new[:, None].to(cache_c.dtype), seq)
    write_slot(cache_kr, slot, kr_new[:, None].to(cache_kr.dtype), seq)

    wkv_b = p["wkv_b"]
    w = wkv_b.unpack() if hasattr(wkv_b, "unpack") else wkv_b
    w = w.reshape(kvr, h, dn + dv).float()
    w_uk, w_uv = w[..., :dn], w[..., dn:]
    q_c = torch.einsum("bhd,chd->bhc", q_nope.float(), w_uk)  # c-space
    scale = (dn + dr) ** -0.5
    if seq is not None:
        o_c = _mla_split_attend(cfg, q_c, q_rope, cache_c, cache_kr,
                                cur_pos, valid_from, seq, scale)
    else:
        s, cf = _mla_scores(q_c, q_rope, cache_c, cache_kr, cur_pos,
                            valid_from, scale)
        o_c = torch.einsum("bhs,bsc->bhc", torch.softmax(s, dim=-1), cf)
    o = torch.einsum("bhc,chv->bhv", o_c, w_uv).to(x.dtype)
    if gathered:
        o = gather_rows(lay, o)
    return _mla_out(p, cfg, o.reshape(b, 1, h * dv))
