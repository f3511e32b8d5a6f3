"""Dense decoder-only LM: init, forward, KV cache, prefill and decode.

The port of the reference's ``models/lm.py`` for the dense family:
pre-norm residual blocks (RMSNorm, GQA, SwiGLU), layer-stacked params,
tied or separate unembedding.  The reference's ``layer_stack`` scan is a
Python loop over layers here.  The decode cache is a dict of tensors that
:func:`lm_prefill`, :func:`lm_decode_step` and :func:`lm_prefill_row`
update IN PLACE (and also return).  Its ``pos`` entry is a 0-d int32
tensor on the cache's device, as in the reference: the decode step reads
it on the device (RoPE, the cache write, the mask) and advances it in
place, so a step captured in a CUDA graph decodes the step the cache is
at on every replay (``serve/programs.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models.layers import (embed_tokens, init_embed, init_swiglu,
                                       rmsnorm, swiglu, unembed)
from repro_torch.models.param import ParamTree, stack_inits, torch_dtype


def _check_dense(cfg):
    if cfg.family != "dense" or cfg.use_mla or cfg.first_k_dense \
            or cfg.sliding_window or cfg.embeds_input:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family without a sliding window "
            f"is ported (ROADMAP.md Queue 1)")


def layer_params(stacked, i: int):
    """Layer ``i`` of a layer-stacked param tree (tensors and
    PackedTensors alike)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _init_layer(gen, cfg):
    pt = ParamTree(gen, cfg.dtype)
    pt.ones("ln1", (cfg.d_model,), ("embed",))
    pt.sub("attn", A.init_gqa(gen, cfg))
    pt.ones("ln2", (cfg.d_model,), ("embed",))
    pt.sub("mlp", init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype))
    return pt.build()


def init_lm(cfg, gen: torch.Generator):
    """Seeded random params on ``gen``'s device: (params, axes)."""
    _check_dense(cfg)
    pt = ParamTree(gen, cfg.dtype)
    pt.sub("embed", init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                               cfg.tie_embeddings))
    pt.sub("layers", stack_inits(lambda: _init_layer(gen, cfg),
                                 cfg.num_layers))
    pt.ones("final_norm", (cfg.d_model,), ("embed",))
    return pt.build()


def _num_layers(params) -> int:
    leaf = params["layers"]["ln1"]
    return leaf.shape[0]


def _layer_fwd(p, cfg, x, *, pos_offset=0, chunk=512, valid_from=None):
    h, kv = A.gqa_forward(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                          pos_offset=pos_offset, chunk=chunk,
                          valid_from=valid_from)
    x = x + h
    x = x + swiglu(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def lm_forward(params, cfg, batch, *, collect_cache: bool = False,
               pos_offset: int = 0, chunk: int = 512):
    """Returns (logits, aux_loss, kvs | None), ``kvs`` a per-layer list of
    (k, v).  ``batch["pad"]`` (optional, (B,)): per-row left-pad count,
    masked out of attention."""
    x = embed_tokens(params["embed"], batch["tokens"])
    valid_from = None
    if batch.get("pad") is not None:
        valid_from = pos_offset + batch["pad"].to(torch.int32)
    kvs = []
    for i in range(_num_layers(params)):
        x, kv = _layer_fwd(layer_params(params["layers"], i), cfg, x,
                           pos_offset=pos_offset, chunk=chunk,
                           valid_from=valid_from)
        if collect_cache:
            kvs.append(kv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, kvs if collect_cache else None


def init_cache(cfg, batch_size: int, max_len: int, device):
    """Zeroed decode cache: k/v (layers, B, max_len, KH, D)."""
    _check_dense(cfg)
    dt = torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        # per-row admission boundary: cache positions below it are
        # left-padding or a recycled slot's dead stream
        "valid_from": torch.zeros((batch_size,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def lm_prefill(params, cfg, batch, cache, *, chunk: int = 512):
    """Run the full prompt and fill the cache (in place).  Returns
    (last_logits, cache)."""
    s = batch["tokens"].shape[1]
    logits, _, kvs = lm_forward(params, cfg, batch, collect_cache=True,
                                chunk=chunk)
    pad = batch.get("pad")
    if pad is not None:
        cache["valid_from"].copy_(pad.to(torch.int32))
    else:
        cache["valid_from"].zero_()
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    sl = torch.arange(cache["slot_pos"].shape[0], dtype=torch.int32,
                      device=cache["slot_pos"].device)
    cache["slot_pos"].copy_(torch.where(sl < s, sl, -1))
    cache["pos"].fill_(s)
    # a copy: the (B, S, V) logits are freed, not held as the output (of
    # a captured program, where they would pin the graph's scratch)
    return logits[:, -1:].clone(), cache


def lm_decode_step(params, cfg, cache, tokens):
    """tokens (B,1) -> (logits (B,1,V), cache updated in place)."""
    pos = cache["pos"]
    idx = pos.reshape(1).long()            # the cache slot, on the device
    x = embed_tokens(params["embed"], tokens)
    cache["slot_pos"].index_copy_(0, idx, pos.reshape(1))
    for i in range(_num_layers(params)):
        p = layer_params(params["layers"], i)
        h = A.gqa_decode(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                         cache["k"][i], cache["v"][i], cache["slot_pos"], pos,
                         idx, valid_from=cache["valid_from"])
        x = x + h
        x = x + swiglu(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    pos.add_(1)
    return logits, cache


def lm_prefill_row(params, cfg, batch, cache, row, t_end):
    """Ragged admission: prefill ONE request (leading dim 1, prompt
    left-padded to a length bucket ``lb``, ``batch["pad"]`` its pad count)
    into row ``row`` of a live decode cache at absolute positions
    ``[t_end - lb, t_end)``, without touching the other rows.  Returns
    (last_logits (1,1,V), cache); ``cache["pos"]`` is the caller's.

    ``row`` and ``t_end`` are Python ints or 0-d int32 tensors on the
    cache's device, and so is the pad count: with device values nothing
    here reads the host, so one captured cell per length bucket serves
    every row and clock value (``serve/programs.py``).  The rows are
    written with index ops on device indices; ``lb`` is static."""
    lb = batch["tokens"].shape[1]
    dev = cache["k"].device
    t0 = t_end - lb
    logits, _, kvs = lm_forward(params, cfg, batch, collect_cache=True,
                                pos_offset=t0)
    idx = t0 + torch.arange(lb, device=dev)              # int64 slots
    row = torch.as_tensor(row, device=dev).reshape(1).long()
    b, s = cache["k"].shape[1:3]
    # this row's slots of the flattened (B * max_len) axis
    flat = row * s + idx
    for i, (k, v) in enumerate(kvs):
        for name, t in (("k", k), ("v", v)):
            cache[name][i].view(b * s, *t.shape[2:]).index_copy_(
                0, flat, t[0].to(cache[name].dtype))
    pad = batch.get("pad")
    vf = idx[:1] + (pad[:1].to(idx.dtype) if pad is not None else 0)
    cache["valid_from"].index_copy_(0, row, vf.to(torch.int32))
    cache["slot_pos"].index_copy_(0, idx, idx.to(torch.int32))
    # a copy: the (1, lb, V) logits are scratch of a captured cell
    return logits[:, -1:].clone(), cache
