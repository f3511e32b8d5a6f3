"""Grouped-query attention: chunked online-softmax attention for prefill,
cache-based decode, and the GQA block.

The port of the reference's ``models/attention.py`` (GQA only; MLA is a
later slice).  On a CUDA device, full-window self-attention from position
0 with a sequence length that is a multiple of 256 runs the flash kernel
(``kernels/flash_attention.py``); everything else — the CPU, ragged
(left-padded) batches, offsets — runs the chunked torch body below, the
counterpart of the reference's jnp path.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import linear
from repro_torch.models.layers import apply_rope, rope_tables
from repro_torch.models.param import ParamTree

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


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 512, q_offset: int = 0, k_offset=None,
                      valid_from=None):
    """q: (B,Sq,H,D)  k,v: (B,Sk,KH,D).  Returns (B,Sq,H,D).

    Online softmax over q chunks (outer) and k chunks (inner) carrying
    fp32 m / l / acc.  ``q_offset`` / ``k_offset`` (defaulting to
    ``q_offset``) are ints or 0-d device tensors; ``valid_from``: (B,)
    absolute first-real-token position per row."""
    if k_offset is None:
        k_offset = q_offset
    # the offsets are compared only when they are host ints: a 0-d device
    # offset (a captured ``prefill_row``) never reaches ``bool()``, which
    # would sync the host (and fail inside a capture)
    if (valid_from is None and q.is_cuda and window == 0
            and isinstance(q_offset, int) and isinstance(k_offset, int)
            and q_offset == 0 and k_offset == 0
            and q.shape[1] == k.shape[1] and q.shape[1] % 256 == 0):
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


def _qkv(p, cfg, x):
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, kh, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, kh, hd)
    return q, k, v


def gqa_forward(p, cfg, x, *, causal=True, pos_offset: int = 0,
                chunk: int = 512, use_rope: bool = True, valid_from=None):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    if use_rope:
        pos = pos_offset + torch.arange(s, device=x.device)
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = chunked_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window, chunk=chunk,
                            q_offset=pos_offset, valid_from=valid_from)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return linear(out, p["wo"]), (k, v)


def gqa_decode(p, cfg, x, cache_k, cache_v, slot_pos, cur_pos, slot, *,
               use_rope: bool = True, valid_from=None):
    """One token.  x: (B,1,d); ``cur_pos`` the step's position, a 0-d int
    tensor on the device, and ``slot`` its cache slot, (1,) int64 on the
    device; caches (B,S,KH,D) are updated IN PLACE at ``slot``; slot_pos
    (S,) absolute position per slot (already updated by the caller).
    Nothing here reads the position on the host, so a captured step
    replays at whatever position the cache holds."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    if use_rope:
        cos, sin = rope_tables(cur_pos.reshape(1), cfg.head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    out = decode_attention(q, cache_k, cache_v, slot_pos, cur_pos,
                           window=cfg.sliding_window, valid_from=valid_from)
    return linear(out.reshape(b, 1, cfg.num_heads * cfg.head_dim), p["wo"])
