"""Unified model interface: one ModelDef per architecture family.

The port of the reference's ``models/registry.py``; only the dense family
is ported so far.

    init(generator)                -> (params, logical_axes)
    forward(params, batch)         -> (logits, aux_loss)
    init_cache(batch, max_len, device) -> zeroed cache
    prefill(params, batch, cache)  -> (last_logits, cache)
    decode_step(params, cache, tk) -> (logits, cache)
    prefill_row(params, batch, cache, row, t_end) -> (logits, cache)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as LM


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    prefill_row: Callable


def build_model(cfg: ModelConfig) -> ModelDef:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1)")
    return ModelDef(
        cfg=cfg,
        init=lambda gen: LM.init_lm(cfg, gen),
        forward=lambda p, b: LM.lm_forward(p, cfg, b)[:2],
        init_cache=lambda bs, ml, device: LM.init_cache(cfg, bs, ml, device),
        prefill=lambda p, b, c: LM.lm_prefill(p, cfg, b, c),
        decode_step=lambda p, c, t: LM.lm_decode_step(p, cfg, c, t),
        prefill_row=lambda p, b, c, row, t_end: LM.lm_prefill_row(
            p, cfg, b, c, row, t_end),
    )
