"""Unified model interface: one ModelDef per architecture family.

The port of the reference's ``models/registry.py``, every family of it:
the dense, MoE, SSM and VLM families through ``models/lm.py``, the
hybrid through ``models/hybrid.py`` and the encoder-decoder through
``models/encdec.py``.

    init(generator)                -> (params, logical_axes)
    forward(params, batch)         -> (logits, aux_loss)
    init_cache(batch, max_len, device) -> zeroed cache
    prefill(params, batch, cache)  -> (last_logits, cache)
    decode_step(params, cache, tk) -> (logits, cache)
    prefill_row(params, batch, cache, row, t_end) -> (logits, cache),
        or None for a family without an attention cache (SSM, hybrid),
        with a rolling one (a sliding window) or an encoder (encdec)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import lm as LM
from repro_torch.models.param import MetaGenerator


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    # ragged admission: None for families without an attention cache
    prefill_row: Optional[Callable] = None


def build_model(cfg: ModelConfig) -> ModelDef:
    if cfg.family == "encdec":
        return ModelDef(
            cfg=cfg,
            init=lambda gen: ED.init_encdec(cfg, gen),
            forward=lambda p, b: ED.encdec_forward(p, cfg, b)[:2],
            init_cache=lambda bs, ml, device: ED.encdec_init_cache(
                cfg, bs, ml, device),
            prefill=lambda p, b, c: ED.encdec_prefill(p, cfg, b, c),
            decode_step=lambda p, c, t: ED.encdec_decode_step(p, cfg, c, t),
        )
    if cfg.family == "hybrid":
        return ModelDef(
            cfg=cfg,
            init=lambda gen: HY.init_hybrid(cfg, gen),
            forward=lambda p, b: HY.hybrid_forward(p, cfg, b)[:2],
            init_cache=lambda bs, ml, device: HY.hybrid_init_cache(
                cfg, bs, ml, device),
            prefill=lambda p, b, c: HY.hybrid_prefill(p, cfg, b, c),
            decode_step=lambda p, c, t: HY.hybrid_decode_step(p, cfg, c, t),
        )
    if cfg.family not in ("dense", "moe", "ssm", "vlm"):
        raise ValueError(f"unknown model family {cfg.family!r}")
    # dense / moe / ssm / vlm share the LM assembly; the reference's rule:
    # no ragged admission for SSM state or a rolling sliding-window cache
    ragged_ok = cfg.family != "ssm" and not cfg.sliding_window
    return ModelDef(
        cfg=cfg,
        init=lambda gen: LM.init_lm(cfg, gen),
        forward=lambda p, b: LM.lm_forward(p, cfg, b)[:2],
        init_cache=lambda bs, ml, device: LM.init_cache(cfg, bs, ml, device),
        prefill=lambda p, b, c: LM.lm_prefill(p, cfg, b, c),
        decode_step=lambda p, c, t: LM.lm_decode_step(p, cfg, c, t),
        prefill_row=(lambda p, b, c, row, t_end: LM.lm_prefill_row(
            p, cfg, b, c, row, t_end)) if ragged_ok else None,
    )


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _shapes(model: ModelDef):
    """The param tree on the ``meta`` device: shapes only, no memory."""
    return model.init(MetaGenerator())[0]


def param_count(model: ModelDef) -> int:
    """Exact param count from the shapes alone (nothing allocated)."""
    return sum(t.numel() for _, t in _leaves(_shapes(model)))


def active_param_count(model: ModelDef) -> int:
    """Params touched per token (MoE: shared + top-k of routed)."""
    cfg = model.cfg
    leaves = list(_leaves(_shapes(model)))
    total = sum(t.numel() for _, t in leaves)
    if not cfg.num_experts:
        return total
    routed = sum(t.numel() for path, t in leaves
                 if path[-1] in ("w_gate", "w_up", "w_down") and t.ndim == 4)
    return total - routed + routed * cfg.experts_per_token // cfg.num_experts
