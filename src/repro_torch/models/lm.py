"""Decoder-only LM: init, forward, KV cache, prefill and decode.

The port of the reference's ``models/lm.py`` for the dense and MoE
families: pre-norm residual blocks (RMSNorm, GQA or MLA attention, a
SwiGLU or MoE MLP), optional unstacked leading dense layers
(``first_k_dense``, DeepSeek-V2's ``dense{i}`` subtrees) before the
layer-stacked ``layers``, tied or separate unembedding.  The reference's
``layer_stack`` scan is a Python loop over layers here.

The decode cache is a dict of tensors that :func:`lm_prefill`,
:func:`lm_decode_step` and :func:`lm_prefill_row` update IN PLACE (and
also return): per layer a pair of slabs, ``k``/``v`` (B, S, KH, D) for
GQA or MLA's compressed ``c`` (B, S, kv_lora_rank) and ``kr`` (B, S,
rope_head_dim), stacked over the scanned layers under the pair's names
and kept per dense layer under ``dense{i}_<name>`` (:func:`cache_slabs`
lists them in layer order).  Its ``pos`` entry is a 0-d int32 tensor on
the cache's device, as in the reference: the decode step reads it on
the device (RoPE, the cache write, the mask) and advances it in place,
so a step captured in a CUDA graph decodes the step the cache is at on
every replay (``serve/programs.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.layers import (embed_tokens, init_embed, init_swiglu,
                                       rmsnorm, swiglu, unembed)
from repro_torch.models.param import ParamTree, stack_inits, torch_dtype


def _kind(cfg) -> str:
    """The scanned block: ``"moe"`` or ``"dense"``.  The SSM block, the
    sliding-window cache and embedding inputs are later slices."""
    if (cfg.family not in ("dense", "moe") or cfg.sliding_window
            or cfg.embeds_input):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE families without a sliding "
            f"window or embedding inputs are ported (ROADMAP.md Queue 1)")
    return cfg.family


def layer_params(stacked, i: int):
    """Layer ``i`` of a layer-stacked param tree (tensors and
    PackedTensors alike)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _init_layer(gen, cfg, kind: str):
    pt = ParamTree(gen, cfg.dtype)
    pt.ones("ln1", (cfg.d_model,), ("embed",))
    pt.sub("attn", A.init_mla(gen, cfg) if cfg.use_mla
           else A.init_gqa(gen, cfg))
    pt.ones("ln2", (cfg.d_model,), ("embed",))
    pt.sub("mlp", MOE.init_moe(gen, cfg) if kind == "moe"
           else init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype))
    return pt.build()


def init_lm(cfg, gen):
    """Seeded random params on ``gen``'s device: (params, axes)."""
    kind = _kind(cfg)
    pt = ParamTree(gen, cfg.dtype)
    pt.sub("embed", init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                               cfg.tie_embeddings))
    for i in range(cfg.first_k_dense):
        pt.sub(f"dense{i}", _init_layer(gen, cfg, "dense"))
    pt.sub("layers", stack_inits(lambda: _init_layer(gen, cfg, kind),
                                 cfg.num_layers - cfg.first_k_dense))
    pt.ones("final_norm", (cfg.d_model,), ("embed",))
    return pt.build()


def _layers(params, cfg):
    """Each layer's (params, kind) in order: the dense ``dense{i}``
    layers, then the scanned ones."""
    kind = _kind(cfg)
    out = [(params[f"dense{i}"], "dense") for i in range(cfg.first_k_dense)]
    n_scan = params["layers"]["ln1"].shape[0]
    return out + [(layer_params(params["layers"], i), kind)
                  for i in range(n_scan)]


def _mlp(p, cfg, x, kind: str):
    """The MLP of a block and its aux loss (None for a dense MLP)."""
    if kind == "moe":
        return MOE.moe_apply(p["mlp"], cfg, x)
    return swiglu(p["mlp"], x), None


def _layer_fwd(p, cfg, x, kind: str, *, pos_offset=0, chunk=512,
               valid_from=None):
    """Returns (x, the layer's cache pair, aux or None)."""
    hin = rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn = A.mla_forward if cfg.use_mla else A.gqa_forward
    h, kv = attn(p["attn"], cfg, hin, pos_offset=pos_offset, chunk=chunk,
                 valid_from=valid_from)
    x = x + h
    h, aux = _mlp(p, cfg, rmsnorm(x, p["ln2"], cfg.norm_eps), kind)
    return x + h, kv, aux


def lm_forward(params, cfg, batch, *, collect_cache: bool = False,
               pos_offset: int = 0, chunk: int = 512):
    """Returns (logits, aux_loss, kvs | None), ``kvs`` a list of each
    layer's cache pair in layer order (the dense layers first), and
    ``aux_loss`` the sum of the MoE layers' (0 for a dense model).
    ``batch["pad"]`` (optional, (B,)): per-row left-pad count, masked out
    of attention."""
    x = embed_tokens(params["embed"], batch["tokens"])
    valid_from = None
    if batch.get("pad") is not None:
        valid_from = pos_offset + batch["pad"].to(torch.int32)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for p, kind in _layers(params, cfg):
        x, kv, aux = _layer_fwd(p, cfg, x, kind, pos_offset=pos_offset,
                                chunk=chunk, valid_from=valid_from)
        if aux is not None:
            aux_total = aux_total + aux
        if collect_cache:
            kvs.append(kv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, aux_total, kvs if collect_cache else None


def _cache_pair_names(cfg) -> tuple:
    return ("c", "kr") if cfg.use_mla else ("k", "v")


def init_cache(cfg, batch_size: int, max_len: int, device):
    """Zeroed decode cache: the pair of :func:`_cache_pair_names`, k/v
    (n_scan, B, max_len, KH, D) or MLA's c (n_scan, B, max_len,
    kv_lora_rank) and kr (n_scan, B, max_len, rope_head_dim), and per
    leading dense layer ``dense{i}_<name>`` without the layer axis."""
    _kind(cfg)
    dt = torch_dtype(cfg.dtype)
    n_scan = cfg.num_layers - cfg.first_k_dense
    if cfg.use_mla:
        widths = ((cfg.kv_lora_rank,), (cfg.rope_head_dim,))
    else:
        widths = ((cfg.num_kv_heads, cfg.head_dim),) * 2
    cache = {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        # per-row admission boundary: cache positions below it are
        # left-padding or a recycled slot's dead stream
        "valid_from": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }
    names = _cache_pair_names(cfg)
    for name, w in zip(names, widths):
        cache[name] = torch.zeros((n_scan, batch_size, max_len, *w), dtype=dt,
                                  device=device)
    for i in range(cfg.first_k_dense):
        for name, w in zip(names, widths):
            cache[f"dense{i}_{name}"] = torch.zeros(
                (batch_size, max_len, *w), dtype=dt, device=device)
    return cache


def cache_slabs(cfg, cache) -> list:
    """Each layer's pair of cache slabs (B, max_len, ...) in layer order
    (the dense layers first): views into ``cache``, so writing a slab
    writes the cache."""
    a, b = _cache_pair_names(cfg)
    out = [(cache[f"dense{i}_{a}"], cache[f"dense{i}_{b}"])
           for i in range(cfg.first_k_dense)]
    return out + list(zip(cache[a], cache[b]))


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
    for slabs, kv in zip(cache_slabs(cfg, cache), kvs):
        for slab, t in zip(slabs, kv):
            slab[:, :s] = t
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
    vf = cache["valid_from"]
    for (p, kind), (ca, cb) in zip(_layers(params, cfg),
                                   cache_slabs(cfg, cache)):
        hin = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            h = A.mla_decode(p["attn"], cfg, hin, ca, cb, pos, idx,
                             valid_from=vf)
        else:
            h = A.gqa_decode(p["attn"], cfg, hin, ca, cb, cache["slot_pos"],
                             pos, idx, valid_from=vf)
        x = x + h
        x = x + _mlp(p, cfg, rmsnorm(x, p["ln2"], cfg.norm_eps), kind)[0]
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
    every row and clock value (``serve/programs.py``).  Every layer's
    slabs, GQA's or MLA's, are written with index ops on device indices;
    ``lb`` is static."""
    lb = batch["tokens"].shape[1]
    dev = cache["slot_pos"].device
    t0 = t_end - lb
    logits, _, kvs = lm_forward(params, cfg, batch, collect_cache=True,
                                pos_offset=t0)
    idx = t0 + torch.arange(lb, device=dev)              # int64 slots
    row = torch.as_tensor(row, device=dev).reshape(1).long()
    b, s = cache["valid_from"].shape[0], cache["slot_pos"].shape[0]
    # this row's slots of the flattened (B * max_len) axis
    flat = row * s + idx
    for slabs, kv in zip(cache_slabs(cfg, cache), kvs):
        for slab, t in zip(slabs, kv):
            slab.view(b * s, *slab.shape[2:]).index_copy_(
                0, flat, t[0].to(slab.dtype))
    pad = batch.get("pad")
    vf = idx[:1] + (pad[:1].to(idx.dtype) if pad is not None else 0)
    cache["valid_from"].index_copy_(0, row, vf.to(torch.int32))
    cache["slot_pos"].index_copy_(0, idx, idx.to(torch.int32))
    # a copy: the (1, lb, V) logits are scratch of a captured cell
    return logits[:, -1:].clone(), cache
