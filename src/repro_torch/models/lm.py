"""Decoder-only LM: init, forward, KV cache, prefill and decode.

The port of the reference's ``models/lm.py`` for the dense, MoE, SSM
and VLM families: pre-norm residual blocks (RMSNorm, GQA or MLA
attention, a SwiGLU or MoE MLP; or RMSNorm and a Mamba2 block,
``models/mamba2.py``), optional unstacked leading dense layers
(``first_k_dense``, DeepSeek-V2's ``dense{i}`` subtrees) before the
layer-stacked ``layers``, tied or separate unembedding.  A VLM
(LLaVA-NeXT's backbone) is the dense block fed ``batch["embeds"]``, the
image embeddings, before the token embeddings.  The reference's
``layer_stack`` scan is a Python loop over layers here, and its
``jax.checkpoint`` of the scanned body is ``layers.remat``: under
training with ``cfg.remat`` each scanned layer (an SSM layer's SSD scan
included) is recomputed in the backward.

The decode cache is a dict of tensors that :func:`lm_prefill`,
:func:`lm_decode_step` and :func:`lm_prefill_row` update IN PLACE (and
also return): per layer a pair of slabs, ``k``/``v`` (B, S, KH, D) for
GQA or MLA's compressed ``c`` (B, S, kv_lora_rank) and ``kr`` (B, S,
rope_head_dim), stacked over the scanned layers under the pair's names
and kept per dense layer under ``dense{i}_<name>`` (:func:`cache_slabs`
lists them in layer order).  Under a sliding window (h2o-danube) the
slabs hold ``min(max_len, window)`` slots and position p lives in slot
``p % slots``: a prompt longer than the window keeps its last ``slots``
positions, scattered into their slots in place, and ``slot_pos`` holds
each slot's absolute position, which the decode mask reads.  An SSM
model's pair is its recurrent state instead, ``ssm`` (B, H, P, N) fp32
and ``conv`` (B, conv-1, C), the last raw inputs of the causal conv,
and its cache has no ``slot_pos`` or ``valid_from``, as in the
reference: the decode step copies the new state into those slabs in
place.  The ``pos`` entry is a 0-d int32
tensor on the cache's device, as in the reference: the decode step reads
it on the device (RoPE, the cache write, the mask) and advances it in
place, so a step captured in a CUDA graph decodes the step the cache is
at on every replay (``serve/programs.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.layers import (embed_tokens, init_embed, init_swiglu,
                                       remat, rmsnorm, swiglu, unembed)
from repro_torch.models.param import ParamTree, stack_inits, torch_dtype
from repro_torch.sharding.context import (axis_group, cache_layout,
                                          dp_gather_cols, row_start,
                                          shard_act, tp_gather, tp_sum,
                                          whole_rows)


def _kind(cfg) -> str:
    """The scanned block: ``"moe"``, ``"ssm"`` or ``"dense"`` (the dense
    and VLM families share the block, as in the reference)."""
    if cfg.family in ("moe", "ssm"):
        return cfg.family
    if cfg.family in ("dense", "vlm"):
        return "dense"
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not a decoder-only LM "
        f"(models/registry.py builds it from its own module)")


def layer_params(stacked, i: int):
    """Layer ``i`` of a layer-stacked param tree (tensors and
    PackedTensors alike)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _init_layer(gen, cfg, kind: str):
    pt = ParamTree(gen, cfg.dtype)
    pt.ones("ln1", (cfg.d_model,), ("embed",))
    if kind == "ssm":
        pt.sub("mamba", M.init_mamba2(gen, cfg))
        return pt.build()
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
    """The MLP of a block and its aux loss (None for a dense MLP).  A
    dense MLP's ``w_down`` is row-parallel over ``mlp``: its partial sums
    are summed over the TP group where ``mlp`` is split, and under 2D
    tensor parallelism (its columns on the data axis) the rank's columns
    are then gathered over the data group.  An MoE layer sums its own
    partials (``models/moe.py``: one fp32 all-reduce for the routed and
    shared experts)."""
    if kind == "moe":
        return MOE.moe_apply(p["mlp"], cfg, x)
    h = tp_sum(swiglu(p["mlp"], x, cfg.d_ff, cfg.d_model), "mlp", cfg.d_ff)
    return dp_gather_cols(h, cfg.d_model), None


def head_logits(params, cfg, x, gather: bool = True):
    """The unembedding; a vocab-sharded head's logits gathered to full
    width over the TP group (unless ``gather`` is False)."""
    logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab_size)
    return tp_gather(logits, "vocab", cfg.vocab_size) if gather else logits


def mamba_fwd(p, cfg, x):
    """One Mamba2 layer's residual block over a sequence (``p``: ln1 and
    mamba).  Returns (x, its final (ssm, conv) state)."""
    h, state = M.mamba2_forward(p["mamba"], cfg,
                                rmsnorm(x, p["ln1"], cfg.norm_eps))
    return x + h, state


def _layer_fwd(p, cfg, x, kind: str, *, pos_offset=0, chunk=512,
               valid_from=None):
    """Returns (x, the layer's cache pair, aux or None)."""
    if kind == "ssm":
        return (*mamba_fwd(p, cfg, x), None)
    hin = rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn = A.mla_forward if cfg.use_mla else A.gqa_forward
    h, kv = attn(p["attn"], cfg, hin, pos_offset=pos_offset, chunk=chunk,
                 valid_from=valid_from)
    x = x + h
    h, aux = _mlp(p, cfg, rmsnorm(x, p["ln2"], cfg.norm_eps), kind)
    return x + h, kv, aux


def _inputs_to_h(params, cfg, batch):
    """tokens (and a VLM's image embeddings, placed first) -> the first
    hidden states.  On a mesh the looked-up rows are full width
    (``layers.embed_tokens`` gathers an FSDP piece's columns over the
    data axis), so the engine's ``embeds`` arrive as they do: the whole
    bucket under 2D tensor parallelism, the data line's rows under
    FSDP."""
    tok = embed_tokens(params["embed"], batch["tokens"], cfg.vocab_size,
                       cfg.d_model)
    if cfg.embeds_input:
        tok = torch.cat([batch["embeds"].to(tok.dtype), tok], dim=1)
    return shard_act(tok, "batch", "seq", "embed")


def prompt_len(cfg, batch) -> int:
    """Positions a prefill of ``batch`` fills: its tokens, and a VLM's
    image embeddings before them."""
    return batch["tokens"].shape[1] + (batch["embeds"].shape[1]
                                       if cfg.embeds_input else 0)


def lm_forward(params, cfg, batch, *, collect_cache: bool = False,
               pos_offset: int = 0, chunk: int = 512, gather: bool = True):
    """Returns (logits, aux_loss, kvs | None), ``kvs`` a list of each
    layer's cache pair in layer order (the dense layers first), and
    ``aux_loss`` the sum of the MoE layers' (0 for a dense model).  On a
    tensor-parallel mesh the logits are this rank's vocab piece unless
    ``gather`` (the default) gathers them.
    ``batch["pad"]`` (optional, (B,)): per-row left-pad count, masked out
    of attention; ``batch["embeds"]`` (a VLM's, (B, I, d)): the image
    embeddings before the tokens."""
    x = _inputs_to_h(params, cfg, batch)
    valid_from = None
    if batch.get("pad") is not None:
        valid_from = pos_offset + batch["pad"].to(torch.int32)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    kw = dict(pos_offset=pos_offset, chunk=chunk, valid_from=valid_from)
    for i, (p, kind) in enumerate(_layers(params, cfg)):
        # the scanned layers' bodies are rematerialized under training, as
        # the reference's ``layer_stack``; the leading dense layers are not
        if i < cfg.first_k_dense:
            x, kv, aux = _layer_fwd(p, cfg, x, kind, **kw)
        else:
            x, kv, aux = remat(cfg, _layer_fwd, p, cfg, x, kind, **kw)
        if aux is not None:
            aux_total = aux_total + aux
        if collect_cache:
            kvs.append(kv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, cfg, x, gather)
    return logits, aux_total, kvs if collect_cache else None


def _cache_pair_names(cfg) -> tuple:
    if cfg.family == "ssm":
        return ("ssm", "conv")
    return ("c", "kr") if cfg.use_mla else ("k", "v")


def ssm_cache(cfg, lead: tuple, batch_size: int, device) -> dict:
    """Zeroed recurrent state of Mamba2 layers stacked as ``lead``:
    ``ssm`` (*lead, B, H, P, N) fp32 and ``conv`` (*lead, B, conv-1, C)
    in the model's type."""
    di, h, p_, n, g = M.dims(cfg)
    return {
        "ssm": torch.zeros((*lead, batch_size, h, p_, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*lead, batch_size, cfg.ssm_conv - 1,
                             di + 2 * g * n), dtype=torch_dtype(cfg.dtype),
                            device=device)}


def init_cache(cfg, batch_size: int, max_len: int, device):
    """Zeroed decode cache: the pair of :func:`_cache_pair_names`, k/v
    (n_scan, B, slots, KH, D) or MLA's c (n_scan, B, slots,
    kv_lora_rank) and kr (n_scan, B, slots, rope_head_dim), and per
    leading dense layer ``dense{i}_<name>`` without the layer axis, with
    ``slots = min(max_len, sliding_window)`` (``max_len`` without a
    window); for the SSM family the recurrent state of :func:`ssm_cache`
    and ``pos`` only."""
    kind = _kind(cfg)
    dt = torch_dtype(cfg.dtype)
    n_scan = cfg.num_layers - cfg.first_k_dense
    if kind == "ssm":
        return {"pos": torch.zeros((), dtype=torch.int32, device=device),
                **ssm_cache(cfg, (n_scan,), batch_size, device)}
    if cfg.use_mla:
        widths = ((cfg.kv_lora_rank,), (cfg.rope_head_dim,))
    else:
        widths = ((cfg.num_kv_heads, cfg.head_dim),) * 2
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    cache = {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "slot_pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
        # per-row admission boundary: cache positions below it are
        # left-padding or a recycled slot's dead stream
        "valid_from": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }
    names = _cache_pair_names(cfg)
    for name, w in zip(names, widths):
        cache[name] = torch.zeros((n_scan, batch_size, slots, *w), dtype=dt,
                                  device=device)
    for i in range(cfg.first_k_dense):
        for name, w in zip(names, widths):
            cache[f"dense{i}_{name}"] = torch.zeros(
                (batch_size, slots, *w), dtype=dt, device=device)
    return cache


def cache_slabs(cfg, cache) -> list:
    """Each layer's pair of cache slabs (B, max_len, ...), or an SSM
    layer's (ssm, conv) state, in layer order (the dense layers first):
    views into ``cache``, so writing a slab writes the cache."""
    a, b = _cache_pair_names(cfg)
    out = [(cache[f"dense{i}_{a}"], cache[f"dense{i}_{b}"])
           for i in range(cfg.first_k_dense)]
    return out + list(zip(cache[a], cache[b]))


def lm_prefill(params, cfg, batch, cache, *, chunk: int = 512):
    """Run the full prompt and fill the cache (in place).  Returns
    (last_logits, cache).  A prompt longer than a sliding window's slots
    keeps its last ``slots`` positions, each scattered into slot
    ``p % slots`` (the reference builds a rolled copy; the port writes
    the cache's own slabs, so a captured cell's addresses stay valid)."""
    s = prompt_len(cfg, batch)
    logits, _, kvs = lm_forward(params, cfg, batch, collect_cache=True,
                                chunk=chunk, gather=False)
    # a copy: the (B, S, V) logits are freed, not held as the output (of
    # a captured program, where they would pin the graph's scratch); on a
    # tensor-parallel mesh only the last position is gathered
    last = tp_gather(logits[:, -1:].clone(), "vocab", cfg.vocab_size)
    if _kind(cfg) == "ssm":
        # the final state of each layer replaces the slab's: the state of
        # the rows the rank holds (its own rows under a gathered layout,
        # models/mamba2.py::state_rows)
        for slabs, state in zip(cache_slabs(cfg, cache), kvs):
            for slab, t in zip(slabs, state):
                slab.copy_(t)
        cache["pos"].fill_(s)
        return last, cache
    _write_prompt(cfg, cache, kvs, batch.get("pad"), s, cache_layout())
    return last, cache


def _write_prompt(cfg, cache, kvs, pad, s: int, lay):
    """:func:`lm_prefill`'s cache write, in place: each layer's K/V of
    the prompt's ``s`` positions, ``valid_from`` and ``slot_pos``.  A
    prompt longer than a sliding window's slots keeps its last ``slots``
    positions, position p in slot ``p % slots``.  Where the rank holds a
    piece of the cache (``lay``, the cell's ``CacheLayout``), it writes
    its rows of the computed bucket (2D tensor parallelism) or the slots
    of its piece of the sequence; ``slot_pos`` stays whole, every slot's
    position recorded on every rank."""
    slots = cache["slot_pos"].shape[0]
    dev = cache["slot_pos"].device
    rows = cache["valid_from"].shape[0]
    seq = lay.seq if lay is not None else None
    r0 = row_start(lay, rows) if lay is not None and lay.gathered else 0
    if pad is not None:
        cache["valid_from"].copy_(pad[r0:r0 + rows].to(torch.int32))
    else:
        cache["valid_from"].zero_()
    first = s - slots if cfg.sliding_window and s > slots else 0
    for slabs, kv in zip(cache_slabs(cfg, cache), kvs):
        for slab, t in zip(slabs, kv):
            t = t[r0:r0 + rows]
            if first:
                # slots a..a+n hold the kept positions p = c (mod slots)
                n = slab.shape[1]
                a = axis_group(seq)[1] * n if seq is not None else 0
                c = a + torch.arange(n, device=dev)
                slab.copy_(t.index_select(1, first + (c - first) % slots)
                           .to(slab.dtype))
            else:
                A.write_prompt(slab, t, s, lay)
    sl = torch.arange(slots, dtype=torch.int32, device=dev)
    if first:
        cache["slot_pos"].copy_(first + (sl - first) % slots)
    else:
        cache["slot_pos"].copy_(torch.where(sl < s, sl, -1))
    cache["pos"].fill_(s)


def lm_decode_step(params, cfg, cache, tokens):
    """tokens (B,1) -> (logits (B,1,V), cache updated in place).  The
    cache slot is the position, or the position modulo the slots under a
    sliding window, computed on the device: a captured step writes the
    right slot on every replay, past the window's wrap too."""
    if _kind(cfg) == "ssm":
        return _ssm_decode_step(params, cfg, cache, tokens)
    pos = cache["pos"]
    idx = pos.reshape(1).long()            # the cache slot, on the device
    if cfg.sliding_window:
        idx = idx % cache["slot_pos"].shape[0]
    x = embed_tokens(params["embed"], tokens, cfg.vocab_size, cfg.d_model)
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
    logits = head_logits(params, cfg, x)
    pos.add_(1)
    return logits, cache


def mamba_decode_into(p, cfg, x, ssm_slab, conv_slab):
    """One Mamba2 layer's residual decode step (``p``: ln1 and mamba),
    the new state copied INTO the given slabs.  Returns x."""
    h, ssm, conv = M.mamba2_decode(p["mamba"], cfg,
                                   rmsnorm(x, p["ln1"], cfg.norm_eps),
                                   ssm_slab, conv_slab)
    ssm_slab.copy_(ssm)
    conv_slab.copy_(conv)
    return x + h


def _ssm_decode_step(params, cfg, cache, tokens):
    x = embed_tokens(params["embed"], tokens, cfg.vocab_size, cfg.d_model)
    for (p, _), (ssm, conv) in zip(_layers(params, cfg),
                                   cache_slabs(cfg, cache)):
        x = mamba_decode_into(p, cfg, x, ssm, conv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, cfg, x)
    cache["pos"].add_(1)
    return logits, cache


def _write_row(cfg, cache, kvs, row, idx, vf, t0, lb: int, lay):
    """:func:`lm_prefill_row`'s write of one request's K/V at slots
    ``idx`` (``[t0, t0 + lb)``) into row ``row`` and of its
    ``valid_from``, with device indices only.  Where the rank holds a
    piece of the cache (``lay``), ``row`` is the pool's row, written
    only by the rank whose piece of the rows holds it, and where the
    slots are split, only the slots of the rank's piece: every rank runs
    the admission (its collectives need the whole group) and the others
    write back what they hold."""
    b = cache["valid_from"].shape[0]
    mine, at = None, row
    if lay is not None and lay.rows is not None:
        local = row - axis_group(lay.rows)[1] * b
        mine = (local >= 0) & (local < b)
        at = local.clamp(0, b - 1)
    seq = lay.seq if lay is not None else None
    for slabs, kv in zip(cache_slabs(cfg, cache), kvs):
        for slab, t in zip(slabs, kv):
            src = t[0].to(slab.dtype)                      # (lb, ...)
            n = slab.shape[1]
            if seq is not None:
                # the whole row of the rank's slots, rewritten
                c = axis_group(seq)[1] * n + torch.arange(n, device=row.device)
                keep = (c >= t0) & (c < t0 + lb)
                if mine is not None:
                    keep = keep & mine
                new = src.index_select(0, (c - t0).clamp(0, lb - 1))
                old = slab.index_select(0, at)[0]
                keep = keep.reshape((-1,) + (1,) * (src.ndim - 1))
                slab.index_copy_(0, at, torch.where(keep, new, old)[None])
                continue
            # this row's slots of the flattened (B * slots) axis
            flat = slab.view(b * n, *slab.shape[2:])
            cells = at * n + idx
            if mine is not None:
                src = torch.where(mine.reshape((1,) * src.ndim), src,
                                  flat.index_select(0, cells))
            flat.index_copy_(0, cells, src)
    vf = vf.to(torch.int32)
    if mine is not None:
        vf = torch.where(mine, vf, cache["valid_from"].index_select(0, at))
    cache["valid_from"].index_copy_(0, at, vf)


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
    if _kind(cfg) == "ssm":
        raise NotImplementedError(
            "ragged admission needs an attention cache; SSM state is "
            "order-dependent and cannot mask left-padding")
    if cfg.sliding_window:
        raise NotImplementedError(
            "ragged admission into a rolling sliding-window cache is not "
            "supported (slot != absolute position)")
    lb = prompt_len(cfg, batch)
    dev = cache["slot_pos"].device
    t0 = t_end - lb
    # every rank computes the one request, whatever rows of the pool it
    # holds: the MoE layers dispatch the data axis's groups over it
    with whole_rows():
        logits, _, kvs = lm_forward(params, cfg, batch, collect_cache=True,
                                    pos_offset=t0, gather=False)
    idx = t0 + torch.arange(lb, device=dev)              # int64 slots
    row = torch.as_tensor(row, device=dev).reshape(1).long()
    pad = batch.get("pad")
    vf = idx[:1] + (pad[:1].to(idx.dtype) if pad is not None else 0)
    _write_row(cfg, cache, kvs, row, idx, vf, t0, lb, cache_layout())
    cache["slot_pos"].index_copy_(0, idx, idx.to(torch.int32))
    # a copy: the (1, lb, V) logits are scratch of a captured cell
    return tp_gather(logits[:, -1:].clone(), "vocab", cfg.vocab_size), cache
