"""Whisper-style encoder-decoder backbone.

The port of the reference's ``models/encdec.py``.  The conv / mel
frontend is a stub, as there: the inputs are precomputed frame
embeddings ``batch["enc_frames"]`` (B, encoder_seq, d_model).  Positions
are fixed sinusoidal encodings (the reference's adaptation of the
learned decoder embeddings, ``layers.sinusoidal_pos``).  Pre-LayerNorm
blocks: the encoder's bidirectional self-attention and GELU MLP; the
decoder's causal self-attention, cross-attention over the encoder output
and GELU MLP; LayerNorms after both stacks; a tied head.  The
reference's ``jax.lax.scan`` over layers is a Python loop here; under
training with ``cfg.remat`` each encoder and decoder layer's body is
recomputed in the backward (``layers.remat``), as the reference
checkpoints both scan bodies.

The cross-attention K/V are projected from the encoder output ONCE per
utterance, at prefill, and every decode step reads them: the model's own
instance of the paper's pack-once-and-reuse pattern.

The decode cache is updated IN PLACE (and returned), as the LM's
(``models/lm.py``): ``k`` / ``v`` (L, B, max_len, KH, D) the decoder's
self-attention, ``cross_k`` / ``cross_v`` (L, B, encoder_seq, KH, D)
written whole by the prefill, ``slot_pos`` (max_len,) and the 0-d device
``pos``, which the decode step reads on the device and advances, so one
captured decode cell serves every step and never re-encodes.

On a tensor-parallel mesh each attention holds its heads (``wo``'s
partial sums summed over the TP group), each GELU MLP its hidden
columns (``w_out`` summed, its bias added on the first rank:
``layers.gelu_mlp``), the cross cache its KV heads; the vocabulary
(51865 at whisper-base, odd) stays whole on every rank, so neither the
lookup nor the logits move over ``model``.  Where the cell's
``CacheLayout`` splits the self-attention slabs' slots (a bucket a data
axis cannot split), the prefill writes the rank's slots and the decode
combines the softmax over their group; the cross cache (its axis
``seq``, not ``cache_seq``) then stays whole.

Under FSDP and 2D tensor parallelism every ``embed`` dim lies on the
data axis too: the LayerNorms' scales and biases (gathered before use,
``layers.layernorm``), the rows of ``wq`` / ``wk`` / ``wv``, ``w_in`` and
the tied head, the columns of ``wo``, ``w_out`` and ``b_out``, and the
token table's.  FSDP gathers each piece before use, and each data line
encodes and decodes its rows of the bucket.  Under 2D every rank encodes
and decodes the whole bucket over pieces that never move: a projection
whose rows lie on ``data`` contracts the rank's K slice and sums the
partials over it (the cross K/V over the encoder output among them,
``w_in``'s bias and GELU once after the sum), and ``wo`` / ``w_out``
give the rank its columns (``b_out``'s piece among them), gathered
after the TP sum.  Where the bucket's cache rows lie on ``data``, the
prefill writes the rank's rows of the self-attention and the cross
cache, and the decode attends over them, gathering the output over
``data`` before ``wo`` (``attention.cross_decode``).

One divergence, in dtype only: the frames are cast to the model's dtype
before the position encoding is added (the reference adds in the frames'
dtype); where the two agree, as on every serving path, nothing differs.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models.layers import (embed_tokens, gelu_mlp, init_embed,
                                       init_gelu_mlp, layernorm, remat,
                                       sinusoidal_pos)
from repro_torch.models.lm import head_logits, layer_params
from repro_torch.models.param import ParamTree, stack_inits, torch_dtype
from repro_torch.sharding.context import cache_layout, row_start


def _ln(pt, name, d):
    pt.ones(f"{name}_s", (d,), ("embed",))
    pt.zeros(f"{name}_b", (d,), ("embed",))


def _apply_ln(p, name, x, eps):
    return layernorm(x, p[f"{name}_s"], p[f"{name}_b"], eps)


def _init_enc_layer(gen, cfg):
    pt = ParamTree(gen, cfg.dtype)
    _ln(pt, "ln1", cfg.d_model)
    pt.sub("attn", A.init_gqa(gen, cfg))
    _ln(pt, "ln2", cfg.d_model)
    pt.sub("mlp", init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype))
    return pt.build()


def _init_dec_layer(gen, cfg):
    pt = ParamTree(gen, cfg.dtype)
    _ln(pt, "ln1", cfg.d_model)
    pt.sub("self_attn", A.init_gqa(gen, cfg))
    _ln(pt, "ln2", cfg.d_model)
    pt.sub("cross_attn", A.init_gqa(gen, cfg))
    _ln(pt, "ln3", cfg.d_model)
    pt.sub("mlp", init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype))
    return pt.build()


def init_encdec(cfg, gen):
    """Seeded random params on ``gen``'s device: (params, axes), the
    reference's tree (``enc_layers`` / ``dec_layers`` stacked on the
    ``layers`` axis, each LayerNorm as ``<name>_s`` / ``<name>_b``)."""
    pt = ParamTree(gen, cfg.dtype)
    pt.sub("embed", init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                               cfg.tie_embeddings))
    pt.sub("enc_layers", stack_inits(lambda: _init_enc_layer(gen, cfg),
                                     cfg.encoder_layers))
    pt.sub("dec_layers", stack_inits(lambda: _init_dec_layer(gen, cfg),
                                     cfg.num_layers))
    _ln(pt, "enc_norm", cfg.d_model)
    _ln(pt, "dec_norm", cfg.d_model)
    return pt.build()


def _n_layers(stacked) -> int:
    return stacked["ln1_s"].shape[0]


def encode(params, cfg, frames):
    """frames: (B, T, d) precomputed embeddings -> the encoder output."""
    t = frames.shape[1]
    dt = torch_dtype(cfg.dtype)
    pos = torch.arange(t, device=frames.device)
    x = frames.to(dt) + sinusoidal_pos(pos, cfg.d_model)[None].to(dt)
    stack = params["enc_layers"]
    for i in range(_n_layers(stack)):
        x = remat(cfg, _enc_layer_fwd, layer_params(stack, i), cfg, x)
    return _apply_ln(params, "enc_norm", x, cfg.norm_eps)


def _enc_layer_fwd(lp, cfg, x):
    """One encoder layer: bidirectional self-attention, GELU MLP."""
    h, _ = A.gqa_forward(lp["attn"], cfg,
                         _apply_ln(lp, "ln1", x, cfg.norm_eps),
                         causal=False, use_rope=False,
                         chunk=min(512, x.shape[1]))
    x = x + h
    return x + gelu_mlp(lp["mlp"], _apply_ln(lp, "ln2", x, cfg.norm_eps),
                        cfg.d_ff, cfg.d_model)


def _dec_layer_fwd(lp, cfg, x, enc_out, *, chunk=512):
    """One decoder layer over the prompt.  Returns (x, ((k, v), (cross_k,
    cross_v)))."""
    h, kv = A.gqa_forward(lp["self_attn"], cfg,
                          _apply_ln(lp, "ln1", x, cfg.norm_eps),
                          causal=True, use_rope=False, chunk=chunk)
    x = x + h
    h, cross_kv = A.gqa_forward(lp["cross_attn"], cfg,
                                _apply_ln(lp, "ln2", x, cfg.norm_eps),
                                causal=False, use_rope=False,
                                kv_from=enc_out, chunk=chunk)
    x = x + h
    x = x + gelu_mlp(lp["mlp"], _apply_ln(lp, "ln3", x, cfg.norm_eps),
                     cfg.d_ff, cfg.d_model)
    return x, (kv, cross_kv)


def encdec_forward(params, cfg, batch, *, collect_cache=False, chunk=512):
    """batch: {enc_frames, tokens}.  Returns (logits, aux 0, kvs | None),
    ``kvs`` each decoder layer's ((k, v), (cross_k, cross_v))."""
    enc_out = encode(params, cfg, batch["enc_frames"])
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed_tokens(params["embed"], tokens, cfg.vocab_size, cfg.d_model)
    pos = torch.arange(s, device=x.device)
    x = x + sinusoidal_pos(pos, cfg.d_model)[None].to(x.dtype)
    kvs = []
    stack = params["dec_layers"]
    for i in range(_n_layers(stack)):
        x, kv = remat(cfg, _dec_layer_fwd, layer_params(stack, i), cfg, x,
                      enc_out, chunk=chunk)
        if collect_cache:
            kvs.append(kv)
    x = _apply_ln(params, "dec_norm", x, cfg.norm_eps)
    logits = head_logits(params, cfg, x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, zero, kvs if collect_cache else None


def encdec_init_cache(cfg, batch_size: int, max_len: int, device):
    """Zeroed decode cache (see the module docstring)."""
    dt = torch_dtype(cfg.dtype)
    l, kh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(n):
        return torch.zeros((l, batch_size, n, kh, hd), dtype=dt,
                           device=device)

    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "k": zeros(max_len),
        "v": zeros(max_len),
        "cross_k": zeros(cfg.encoder_seq),
        "cross_v": zeros(cfg.encoder_seq),
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                               device=device),
    }


def encdec_prefill(params, cfg, batch, cache, *, chunk=512):
    """Encode the frames, run the decoder prompt and fill the cache in
    place: the prompt's self-attention K/V, every layer's cross K/V,
    ``slot_pos`` and ``pos``.  Under a gathered cell layout (2D tensor
    parallelism at a bucket the data axis splits) every rank computes
    the whole bucket and writes the rows its cache holds
    (``sharding/context.py::row_start``), of both kinds of slab.
    Returns (last_logits, cache)."""
    s = batch["tokens"].shape[1]
    logits, _, kvs = encdec_forward(params, cfg, batch, collect_cache=True,
                                    chunk=chunk)
    lay = cache_layout()
    rows = cache["k"].shape[1]
    r0 = row_start(lay, rows) if lay is not None and lay.gathered else 0
    mine = slice(r0, r0 + rows)
    for i, ((k, v), (ck, cv)) in enumerate(kvs):
        A.write_prompt(cache["k"][i], k[mine], s, lay)
        A.write_prompt(cache["v"][i], v[mine], s, lay)
        cache["cross_k"][i].copy_(ck[mine])
        cache["cross_v"][i].copy_(cv[mine])
    sl = torch.arange(cache["slot_pos"].shape[0], dtype=torch.int32,
                      device=cache["slot_pos"].device)
    cache["slot_pos"].copy_(torch.where(sl < s, sl, -1))
    cache["pos"].fill_(s)
    # a copy: the (B, S, V) logits are scratch of a captured cell
    return logits[:, -1:].clone(), cache


def encdec_decode_step(params, cfg, cache, tokens):
    """tokens (B,1) -> (logits (B,1,V), cache updated in place): each
    layer's self-attention K/V written at the device position, the cross
    K/V the prefill wrote read as they are, the position advanced."""
    pos = cache["pos"]
    idx = pos.reshape(1).long()            # the cache slot, on the device
    x = embed_tokens(params["embed"], tokens, cfg.vocab_size, cfg.d_model)
    x = x + sinusoidal_pos(pos.reshape(1), cfg.d_model)[None].to(x.dtype)
    cache["slot_pos"].index_copy_(0, idx, pos.reshape(1))
    stack = params["dec_layers"]
    for i in range(_n_layers(stack)):
        lp = layer_params(stack, i)
        x = x + A.gqa_decode(lp["self_attn"], cfg,
                             _apply_ln(lp, "ln1", x, cfg.norm_eps),
                             cache["k"][i], cache["v"][i], cache["slot_pos"],
                             pos, idx, use_rope=False)
        x = x + A.cross_decode(lp["cross_attn"], cfg,
                               _apply_ln(lp, "ln2", x, cfg.norm_eps),
                               cache["cross_k"][i], cache["cross_v"][i])
        x = x + gelu_mlp(lp["mlp"], _apply_ln(lp, "ln3", x, cfg.norm_eps),
                         cfg.d_ff, cfg.d_model)
    x = _apply_ln(params, "dec_norm", x, cfg.norm_eps)
    logits = head_logits(params, cfg, x)
    pos.add_(1)
    return logits, cache
