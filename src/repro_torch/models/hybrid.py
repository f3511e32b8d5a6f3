"""Zamba2-style hybrid: Mamba2 layer groups and one SHARED attention + MLP
block applied after every ``cfg.attn_every`` SSM layers.

The port of the reference's ``models/hybrid.py``.  The shared block reads
the concatenation of the current hidden state with the original
embeddings (width 2 * d_model), and its weights are exactly shared
across its applications (no per-application LoRA deltas), as in the
reference.  At decode its projections are packed once and hit
``num_layers / attn_every`` times per token.  Under training with
``cfg.remat`` each Mamba layer's body is recomputed in the backward
(``layers.remat``), as the reference checkpoints its Mamba scan body;
the shared block is not.

One divergence in layout, not in the function: the reference stacks the
Mamba layers as (groups, per_group, ...) for its nested scan; the port
keeps them as (num_layers, ...) on the ``layers`` axis, like the SSM
LM's, so each leaf is 3-D and packs once at load
(``serve/engine.py::packable_divisors`` takes at most three dims).
``models/param.py::params_from_numpy`` reshapes the reference's tree.
The cache keeps the reference's layout: ``ssm`` / ``conv`` as (groups,
per_group, B, ...), one K/V slab per application of the shared block
(groups, B, max_len, KH, D), ``slot_pos`` and the 0-d device ``pos``;
no ``valid_from`` (no ragged admission for SSM state).

On a tensor-parallel mesh the Mamba layers hold their heads
(``models/mamba2.py``), the shared block its heads and its MLP's
columns (``wo`` and ``w_down`` summed over the TP group; its input
``[x, x0]`` whole on every rank), each application's K/V slab its KV
heads, and the vocabulary is split as the LM's (the lookup summed, the
logits gathered).  Where the cell's ``CacheLayout`` splits the K/V
slabs' slots (a bucket a data axis cannot split), the prefill writes the
rank's slots and the decode combines the softmax over their group
(``models/attention.py::gqa_decode``).  Under FSDP and 2D tensor
parallelism the shared block's 2 d_model rows (``[x, x0]``, ``ln1`` /
``ln2``) lie on the data axis as an ``embed`` dim: FSDP gathers each
piece before use, 2D contracts each rank's half of ``[x, x0]`` where
its piece lies (``core/tsmm.py::tsmm_dot``), and ``wo`` / ``w_down``
give the rank its columns, gathered after the TP sum.  One cell layout
serves both kinds of slab: the rules split the K/V and the Mamba state
by the same batch dim, so at a bucket the data axis splits both have
their rows on it (2D: every rank computes the bucket and writes its
rows), and at one it cannot, the state is whole and only the K/V slots
are split.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import (embed_tokens, init_embed, init_swiglu,
                                       remat, rmsnorm, swiglu)
from repro_torch.models.lm import (head_logits, layer_params,
                                   mamba_decode_into, mamba_fwd, ssm_cache)
from repro_torch.models.param import ParamTree, stack_inits, torch_dtype
from repro_torch.sharding.context import (cache_layout, dp_gather_cols,
                                          row_start, tp_gather, tp_sum)


def _n_groups(cfg) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"multiple of attn_every={cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init_hybrid(cfg, gen):
    """Seeded random params on ``gen``'s device: (params, axes)."""
    _n_groups(cfg)
    pt = ParamTree(gen, cfg.dtype)
    pt.sub("embed", init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                               cfg.tie_embeddings))

    def one_mamba():
        lpt = ParamTree(gen, cfg.dtype)
        lpt.ones("ln1", (cfg.d_model,), ("embed",))
        lpt.sub("mamba", M.init_mamba2(gen, cfg))
        return lpt.build()

    pt.sub("mamba_layers", stack_inits(one_mamba, cfg.num_layers))
    # the shared transformer block (input concat(x, x0): width 2d)
    d2 = 2 * cfg.d_model
    sb = ParamTree(gen, cfg.dtype)
    sb.ones("ln1", (d2,), ("embed",))
    sb.sub("attn", A.init_gqa(gen, cfg, d_in=d2))
    sb.ones("ln2", (d2,), ("embed",))
    sb.sub("mlp", init_swiglu(gen, d2, cfg.d_ff, cfg.dtype,
                              d_out=cfg.d_model))
    pt.sub("shared", sb.build())
    pt.ones("final_norm", (cfg.d_model,), ("embed",))
    return pt.build()


def shared_in(x, x0):
    """The shared block's input ``[x, x0]`` (2 d_model wide): under 2D
    tensor parallelism the first data rank contracts its ``x`` half and
    the second its ``x0`` half."""
    return torch.cat([x, x0], dim=-1)


def _shared_fwd(p, cfg, x, x0, *, pos_offset=0, chunk=512):
    h = rmsnorm(shared_in(x, x0), p["ln1"], cfg.norm_eps)
    a, kv = A.gqa_forward(p["attn"], cfg, h, pos_offset=pos_offset,
                          chunk=chunk)
    x = x + a
    h = rmsnorm(shared_in(x, x0), p["ln2"], cfg.norm_eps)
    return x + _shared_mlp(p, cfg, h), kv


def _shared_mlp(p, cfg, h):
    """The shared block's SwiGLU MLP, ``w_down`` row-parallel over
    ``mlp``: its partial sums summed over the TP group where the hidden
    width is split; its columns on the data axis as the LM's MLP (an
    unpacked FSDP piece gathered before use, the rank's columns of the
    output gathered after the sum under 2D)."""
    h = tp_sum(swiglu(p["mlp"], h, d_model=cfg.d_model), "mlp", cfg.d_ff)
    return dp_gather_cols(h, cfg.d_model)


def _shared_decode(p, cfg, x, x0, ck, cv, slot_pos, pos, slot):
    """The shared block's one-token step; ``ck`` / ``cv`` (B, max_len, KH,
    D), this application's cache, are written in place at ``slot``."""
    h = rmsnorm(shared_in(x, x0), p["ln1"], cfg.norm_eps)
    x = x + A.gqa_decode(p["attn"], cfg, h, ck, cv, slot_pos, pos, slot)
    h = rmsnorm(shared_in(x, x0), p["ln2"], cfg.norm_eps)
    return x + _shared_mlp(p, cfg, h)


def _groups(params, cfg):
    """Each group's Mamba layers' params, in order."""
    per = cfg.attn_every
    return [[layer_params(params["mamba_layers"], g * per + j)
             for j in range(per)] for g in range(_n_groups(cfg))]


def hybrid_forward(params, cfg, batch, *, collect_cache=False, chunk=512,
                   gather: bool = True):
    """Returns (logits, aux 0, (states, kvs) | (None, None)): ``states``
    each Mamba layer's (h_final, conv_tail) in layer order, ``kvs`` each
    application's (k, v).  On a tensor-parallel mesh the logits are this
    rank's vocab piece unless ``gather`` (the default) gathers them."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg.vocab_size,
                     cfg.d_model)
    x0 = x
    states, kvs = [], []
    for group in _groups(params, cfg):
        for lp in group:
            # the Mamba body (its SSD scan) is rematerialized under
            # training, as the reference's; the shared block is not
            x, state = remat(cfg, mamba_fwd, lp, cfg, x)
            if collect_cache:
                states.append(state)
        x, kv = _shared_fwd(params["shared"], cfg, x, x0, chunk=chunk)
        if collect_cache:
            kvs.append(kv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, cfg, x, gather)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, zero, ((states, kvs) if collect_cache else (None, None))


def hybrid_init_cache(cfg, batch_size: int, max_len: int, device):
    """Zeroed decode cache in the reference's layout (see the module
    docstring)."""
    ng = _n_groups(cfg)
    dt = torch_dtype(cfg.dtype)
    kv = (ng, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        **ssm_cache(cfg, (ng, cfg.attn_every), batch_size, device),
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                               device=device),
    }


def cache_slabs(cfg, cache) -> list:
    """Each Mamba layer's (ssm, conv) state in layer order, then each
    application's (k, v) slabs (B, max_len, KH, D): views into
    ``cache``."""
    ssm = cache["ssm"].reshape(-1, *cache["ssm"].shape[2:])
    conv = cache["conv"].reshape(-1, *cache["conv"].shape[2:])
    return list(zip(ssm, conv)) + list(zip(cache["k"], cache["v"]))


def hybrid_prefill(params, cfg, batch, cache, *, chunk=512):
    """Run the full prompt and fill the cache (in place).  Returns
    (last_logits, cache)."""
    s = batch["tokens"].shape[1]
    logits, _, (states, kvs) = hybrid_forward(
        params, cfg, batch, collect_cache=True, chunk=chunk, gather=False)
    slabs = cache_slabs(cfg, cache)
    # each Mamba layer's final state is of the rows the rank holds (the
    # block's own, under a gathered layout: models/mamba2.py::state_rows);
    # the shared block's K/V are of every row it computed
    for (ssm, conv), (h, tail) in zip(slabs, states):
        ssm.copy_(h)
        conv.copy_(tail)
    lay = cache_layout()
    rows = cache["k"].shape[1]
    r0 = row_start(lay, rows) if lay is not None and lay.gathered else 0
    for (ck, cv), (k, v) in zip(slabs[cfg.num_layers:], kvs):
        A.write_prompt(ck, k[r0:r0 + rows], s, lay)
        A.write_prompt(cv, v[r0:r0 + rows], s, lay)
    sl = torch.arange(cache["slot_pos"].shape[0], dtype=torch.int32,
                      device=cache["slot_pos"].device)
    cache["slot_pos"].copy_(torch.where(sl < s, sl, -1))
    cache["pos"].fill_(s)
    # a copy: the (B, S, V) logits are scratch of a captured cell; on a
    # tensor-parallel mesh only the last position is gathered
    return tp_gather(logits[:, -1:].clone(), "vocab", cfg.vocab_size), cache


def hybrid_decode_step(params, cfg, cache, tokens):
    """tokens (B,1) -> (logits (B,1,V), cache updated in place): every
    Mamba layer's state copied into its slabs, each application's K/V
    written at the device position, which then advances."""
    pos = cache["pos"]
    idx = pos.reshape(1).long()            # the cache slot, on the device
    x = embed_tokens(params["embed"], tokens, cfg.vocab_size, cfg.d_model)
    x0 = x
    cache["slot_pos"].index_copy_(0, idx, pos.reshape(1))
    slabs = cache_slabs(cfg, cache)
    layer = 0
    for g, group in enumerate(_groups(params, cfg)):
        for lp in group:
            x = mamba_decode_into(lp, cfg, x, *slabs[layer])
            layer += 1
        ck, cv = slabs[cfg.num_layers + g]
        x = _shared_decode(params["shared"], cfg, x, x0, ck, cv,
                           cache["slot_pos"], pos, idx)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, cfg, x)
    pos.add_(1)
    return logits, cache
