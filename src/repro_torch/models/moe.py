"""Mixture-of-Experts with sort-based capacity dispatch.

The port of the reference's ``models/moe.py``: GShard-style capacity,
Megablocks-style sorted grouping, all shapes static.  The expert GEMMs
are batched (E, C, d) x (E, d, ff) products; with 64-160 experts the
per-expert token count C is small, the tall-and-skinny regime.  As in
the reference they are plain batched products (``torch.bmm``), outside
the planned TSMM kernels, and the shared experts are plain matmuls.

One dispatch group (``g = 1``): the reference's ``_dp_groups`` splits
the tokens per data-parallel shard, which is sharding (ROADMAP.md Queue
1 item 7); off a mesh it is 1 there too.

Every shape depends only on the token count (``cap`` is computed from
it), and nothing reads a value on the host, so a call is capturable in
a CUDA graph.  The dispatch is the reference's, step for step: the fp32
router and softmax, top-k renormalised by ``max(sum, 1e-9)``, a stable
argsort of the flat expert ids, the rank of each entry within its expert
(``searchsorted``), ``keep = rank < cap`` with dropped entries sent to a
sink row ``e * cap`` of the (e * cap + 1, d) buffer.  Pad tokens are
routed and take capacity, as in the reference.

The combine is deterministic.  The reference scatter-adds each token's
k weighted expert outputs in ``x.dtype`` (``.at[tok].add``), in the
order of the stable sort, which is expert id ascending within a token.
``index_add_`` on CUDA adds with atomics, whose order, and so whose bf16
rounding, changes from run to run.  Here the sort is inverted instead:
each token's k entries are gathered into a (t, k, d) tensor in their
sorted positions' order (expert id ascending) and summed one after the
other in ``x.dtype``.  The order is a function of the routing alone, so
two runs, eager or a graph replay, give the same bits.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models.layers import silu
from repro_torch.models.param import ParamTree

# profiler ranges (``launch/profile_decode.py`` reads the device time of
# the kernels each encloses): the routed and shared experts' products,
# and the routing, sort, dispatch and combine around them
EXPERTS_RANGE, DISPATCH_RANGE = "moe_experts", "moe_dispatch"


def init_moe(gen, cfg):
    d, ff, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    pt = ParamTree(gen, cfg.dtype)
    pt.dense("router", (d, e), ("embed", "experts"), dtype="float32")
    pt.dense("w_gate", (e, d, ff), ("experts", "embed", "mlp"), fan_in=d)
    pt.dense("w_up", (e, d, ff), ("experts", "embed", "mlp"), fan_in=d)
    pt.dense("w_down", (e, ff, d), ("experts", "mlp", "embed"), fan_in=ff)
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        pt.dense("ws_gate", (d, sff), ("embed", "mlp"))
        pt.dense("ws_up", (d, sff), ("embed", "mlp"))
        pt.dense("ws_down", (sff, d), ("mlp", "embed"))
    return pt.build()


def _capacity(tokens: int, e: int, k: int, factor: float) -> int:
    c = int(tokens * k * factor / e) + 1
    return max(8, -(-c // 8) * 8)


def moe_apply(p, cfg, x, *, capacity_factor: float = 0.0):
    """x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(t, e, k, capacity_factor or cfg.capacity_factor)
    dev = x.device
    xf = x.reshape(t, d)

    with record_function(DISPATCH_RANGE):
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)  # (t, E) f32
        top_p, top_e = torch.topk(probs, k, dim=-1)             # (t, k)
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
        flat_e = top_e.reshape(-1)                               # (t*k,)
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        ar = torch.arange(t * k, device=dev)
        rank = ar - torch.searchsorted(e_sorted, e_sorted, side="left")
        keep = rank < cap
        slot = torch.where(keep, e_sorted * cap + rank, e * cap)
        tok = order // k
        # slots are unique but for the sink row, which only takes zeros
        buf = x.new_zeros((e * cap + 1, d)).index_copy_(
            0, slot, torch.where(keep[:, None], xf[tok], 0))
        buf = buf[:-1].view(e, cap, d)
        w_sorted = top_p.reshape(-1)[order]

    with record_function(EXPERTS_RANGE):
        h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        y = torch.bmm(h, p["w_down"]).reshape(e * cap, d)

    with record_function(DISPATCH_RANGE):
        gath = torch.where(keep[:, None], y[slot.clamp(0, e * cap - 1)], 0)
        contrib = gath * w_sorted[:, None].to(x.dtype)
        # each token's k sorted positions, ascending: expert id ascending
        inv = torch.empty_like(order).scatter_(0, order, ar)
        at = torch.sort(inv.view(t, k), dim=-1).values
        parts = contrib[at]                                      # (t, k, d)
        out = parts[:, 0]
        for i in range(1, k):
            out = out + parts[:, i]
        out = out.reshape(b, s, d)

    if cfg.num_shared_experts:
        with record_function(EXPERTS_RANGE):
            hs = silu(xf @ p["ws_gate"]) * (xf @ p["ws_up"])
            out = out + (hs @ p["ws_down"]).reshape(b, s, d)

    # load-balance aux loss (Switch/GShard form); the counts are exact
    # in fp32 whatever the order of the adds
    with record_function(DISPATCH_RANGE):
        me = probs.mean(0)
        ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
            0, flat_e, torch.ones((t * k,), dtype=torch.float32,
                                  device=dev)) / (t * k)
        aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return out, aux
