"""Unified model interface: one ModelDef per architecture family.

The port of the reference's ``models/registry.py``; the dense and MoE
families are ported so far (both through ``models/lm.py``).

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
from repro_torch.models.param import MetaGenerator


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
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1)")
    # ragged admission for every family ported: the reference's rule
    # withholds it from SSM state and sliding windows, which the port's
    # LM refuses altogether (models/lm.py::_kind)
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
