"""Mixture-of-Experts with sort-based capacity dispatch.

The port of the reference's ``models/moe.py``: GShard-style capacity,
Megablocks-style sorted grouping, all shapes static.  The expert GEMMs
are batched (E, C, d) x (E, d, ff) products; with 64-160 experts the
per-expert token count C is small, the tall-and-skinny regime.  As in
the reference they are plain batched products (``torch.bmm``), outside
the planned TSMM kernels, and the shared experts are plain matmuls.

Dispatch runs in ``g`` groups, the reference's ``_dp_groups``: one per
data-parallel shard of a global batch (``sharding/context.py::
moe_groups``), each group sorted and given its capacity (computed from
its ``t / g`` tokens) on its own.  Off a mesh ``g`` is 1.  On a serving
mesh a rank that computes its data line's rows holds exactly one group;
one that computes a whole bucket the data axis cannot split dispatches
the ``g`` groups over its tokens itself.

Under tensor parallelism the rules (``pspec_for``, read leaf by leaf)
give the routed experts one of two layouts: ``experts`` on the TP axis
(a rank holds ``E / tp`` experts and computes only their rows of the
dispatch buffer) or, where fewer than 8 experts a rank would remain,
``mlp`` (every expert's columns split: ``w_gate`` / ``w_up``
column-parallel, ``w_down`` row-parallel).  A router split with the
experts gives each rank its experts' logit columns, all-gathered so that
every rank routes the same (t, E) fp32 logits: the same order, ranks,
drops and capacity as one rank.  The shared experts are column- and
row-parallel over ``mlp``.  Either way a rank's output is a partial sum:
the routed and shared partials are added in fp32 and summed in one
all-reduce over the TP group (:func:`moe_sum`), then cast once to
``x.dtype``.

Under FSDP serving (``fsdp=True``) each leaf's ``embed`` dim lies on the
data axis too (the router's and shared experts' rows, an expert stack's
dim 1, ``w_down``'s and ``ws_down``'s columns): each piece is gathered
over the data group before use (``dp_weight``), and the layer runs as
above on the data line's rows.  Under 2D weight-stationary tensor
parallelism (``fsdp=True, serve_2d_tp=True``) nothing is gathered: every
rank computes the whole bucket, and contracts its data line's ``d / n``
columns of each token (``dp_slice``) with its pieces where they lie.
The router's fp32 partial logits are summed over the data group
(:func:`router_sum`) before the gather over the TP group; the routed and
shared experts' ``w_gate`` / ``w_up`` partials are summed over the data
group in one all-reduce (:func:`experts_sum`) before SiLU, which a late
sum would get wrong; ``w_down`` / ``ws_down`` then give the rank's
``d / n`` output columns, which pass the combine and :func:`moe_sum`
before the cast, and are gathered over the data group after it.

In a train step on a process mesh (where autograd records) the TP
sites carry gradients: :func:`moe_sum` is Megatron's *g*, the router's
gather passes the gradient of the rank's columns back, and *f* stands
before each consumer of the layer's input whose weight is split, and at
the combine's routing weights where the routed experts split.  A rank's
rows of the global batch are one dispatch group, and its aux loss is its
share of the global batch's (:func:`load_balance_aux`).

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
other in ``x.dtype`` (in fp32 where a TP rank's partial is summed over
the group).  The order is a function of the routing alone, so two runs,
eager or a graph replay, give the same bits.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models.layers import silu
from repro_torch.models.param import ParamTree
from repro_torch.sharding.context import (dp_gather_cols, dp_group,
                                          dp_size, dp_slice, dp_weight,
                                          kblocks_split, moe_groups,
                                          tp_copy_where, tp_gather_where,
                                          tp_leaf_split, tp_rank,
                                          tp_sum_where)

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


def moe_sum(part):
    """The fp32 partial output of an MoE layer (routed and shared experts
    together) summed over the TP group: the layer's one collective after
    its experts (where autograd records, Megatron's *g*: the gradient
    passed through)."""
    return tp_sum_where(part, True)


def routed_input(xk, routed):
    """The routed experts' copy of the layer's input: where autograd
    records and the rules split them (``routed``: ``"experts"`` or
    ``"mlp"``), Megatron's *f*, whose backward sums the ranks' partial
    gradients of the dispatched rows (a function of its own, so a control
    can skip it)."""
    return tp_copy_where(xk, routed is not None)


def router_sum(part):
    """Under 2D tensor parallelism, the fp32 partial router logits of the
    data line's ``embed`` rows summed over the data group (in fp32, as the
    reference's logits are computed)."""
    from repro_torch.sharding import comm
    return comm.all_reduce(part, dp_group())


def experts_sum(parts: list) -> list:
    """Under 2D tensor parallelism, the data line's partial products of
    the routed and shared experts' ``w_gate`` / ``w_up`` summed over the
    data group in one all-reduce, before SiLU.  The sum runs in the
    compute dtype, as ``core/tsmm.py::ksplit_sum``'s: each partial leaves
    ``torch.bmm`` already rounded to it, and at a data size of 2 the
    rounded sum of two values equals their fp32 sum rounded once, at half
    the bytes."""
    from repro_torch.sharding import comm
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in parts]),
                           dp_group())
    return [t.view_as(p) for t, p in
            zip(flat.split([p.numel() for p in parts]), parts)]


def router_probs(router, xf, gathered: bool):
    """The fp32 routing probabilities (t, E) of ``xf`` (t, d).
    ``gathered``: the router holds this rank's experts' columns,
    all-gathered over the TP group so that every rank routes the same
    (t, E) fp32 logits.  Under FSDP the router's rows are gathered over
    the data group first; under 2D tensor parallelism the rank's rows
    contract its data line's columns of ``xf`` and the partial logits are
    summed over the data group (:func:`router_sum`) before the gather.
    A bf16 train step's compute copy holds the router in bf16 (as the
    reference's: every matrix cast): its values take part in fp32."""
    d = xf.shape[-1]
    router = router.float()
    if kblocks_split(d):
        logits = router_sum(dp_slice(xf, d).float() @ router)
    else:
        logits = xf.float() @ dp_weight(router, d, 0)            # (t, E) f32
    logits = tp_gather_where(logits, gathered)
    return torch.softmax(logits, dim=-1)


def dispatch_order(probs, top_p, top_e, g: int, cap: int) -> tuple:
    """The sort of the dispatch, the reference's step for step, from each
    token's k chosen experts ``top_e`` (t, k) and their probabilities
    ``top_p``: (probs, flat_e, order, keep, slot, tok, w_sorted) over the
    flat (t * k) entries.  The ``g`` groups are consecutive blocks of
    ``t / g`` tokens, each sorted and given ``cap`` rows an expert on its
    own; ``slot`` indexes the expert-major (E, g * cap) buffer
    (``E * g * cap``, the sink, for a dropped entry: ``keep`` False)."""
    t, k = top_e.shape
    e = probs.shape[-1]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(-1)                                   # (t*k,)
    ar = torch.arange(t * k, device=top_e.device)
    # sorted by (group, expert): a stable sort keeps each group's order
    key = flat_e if g == 1 else flat_e + (ar // (t // g * k)) * e
    order = torch.argsort(key, stable=True)
    k_sorted = key[order]
    rank = ar - torch.searchsorted(k_sorted, k_sorted, side="left")
    keep = rank < cap
    e_sorted, grp = ((k_sorted, 0) if g == 1
                     else (k_sorted % e, k_sorted // e))
    slot = torch.where(keep, (e_sorted * g + grp) * cap + rank, e * g * cap)
    return (probs, flat_e, order, keep, slot, order // k,
            top_p.reshape(-1)[order])


def load_balance_aux(probs, flat_e, k: int, coef: float):
    """The load-balance aux loss (Switch/GShard form) of the routing
    ``probs`` (t, E) and the t * k chosen experts ``flat_e``: ``E * coef
    * sum_e me[e] * ce[e]``, ``me`` the mean probability of expert e over
    the batch's tokens, ``ce`` the share of the choices that went to e (no
    gradient; the counts are exact in fp32 whatever the order of the
    adds).  Where autograd records on a live data axis of n ranks (a
    train step: each rank holds t of the global batch's n * t tokens),
    the ranks' counts are all-reduced over the data group (E fp32 values)
    and the rank returns its share ``E * coef * sum_e (me_r[e] / n) *
    ce[e]``: summed over the group, the shares are the global batch's aux
    and their gradients its gradient.  Under TP every rank routes the
    same gathered logits, so every TP rank returns the same share."""
    t, e = probs.shape
    counts = torch.zeros((e,), dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat_e, torch.ones((t * k,), dtype=torch.float32,
                              device=probs.device))
    me = probs.mean(0)
    n = dp_size() if torch.is_grad_enabled() and probs.requires_grad else 1
    if n > 1:
        from repro_torch.sharding import comm
        counts = comm.all_reduce(counts, dp_group())
        me = me / n
    ce = counts / (t * k * n)
    return e * torch.sum(me * ce) * coef


def route(router, xf, k: int, g: int, cap: int, gathered: bool) -> tuple:
    """The routing of ``xf`` (t, d): the fp32 softmax of the router's
    logits (:func:`router_probs`), each token's top-k experts, renormalised
    by ``max(sum, 1e-9)``, and the dispatch's sort
    (:func:`dispatch_order`, whose tuple it returns)."""
    probs = router_probs(router, xf, gathered)
    top_p, top_e = torch.topk(probs, k, dim=-1)                 # (t, k)
    return dispatch_order(probs, top_p, top_e, g, cap)


def moe_apply(p, cfg, x, *, capacity_factor: float = 0.0):
    """x: (B, S, d) -> (out, aux_loss), dispatched in the ambient mesh's
    groups (``moe_groups``: 1 off a mesh).  Where autograd records on a
    tensor-parallel mesh, Megatron's *f* stands before each consumer of
    ``x`` whose weight is split (the router split with the experts, the
    routed experts, the shared experts), each consumer reading its own
    copy: a whole consumer computes the full gradient of ``x`` on every
    rank, which one *f* on the layer's input would sum ``tp`` times.  The
    combine's routing weights meet the rank's partial expert outputs, so
    where the routed experts split they pass an *f* too.  The
    aux loss is taken right after the routing (:func:`load_balance_aux`),
    so remat's recompute, which stops at the layer's last saved tensor
    (before :func:`moe_sum`), runs its data-group all-reduce again."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    g = moe_groups(t)
    tg = t // g
    cap = _capacity(tg, e, k, capacity_factor or cfg.capacity_factor)
    dev = x.device
    xf = x.reshape(t, d)
    # the layouts the rules give this layer's leaves on the ambient mesh
    # (None: whole on every rank)
    routed = tp_leaf_split(("experts", "embed", "mlp"),
                           (e, d, cfg.d_ff_expert))
    gathered = tp_leaf_split(("embed", "experts"), (d, e)) is not None
    shared = (tp_leaf_split(("embed", "mlp"),
                            (d, cfg.d_ff_expert * cfg.num_shared_experts))
              if cfg.num_shared_experts else None)
    partial = routed is not None or shared is not None

    # the data line's columns of each token under 2D (its K slice of the
    # pieces' rows); under FSDP the pieces gathered over data
    xk = dp_slice(xf, d)
    w_gate, w_up, w_down = (dp_weight(p["w_gate"], d, 1),
                            dp_weight(p["w_up"], d, 1),
                            dp_weight(p["w_down"], d, 2))

    with record_function(DISPATCH_RANGE):
        probs, flat_e, order, keep, slot, tok, w_sorted = route(
            p["router"], tp_copy_where(xf, gathered), k, g, cap, gathered)
        aux = load_balance_aux(probs, flat_e, k, cfg.router_aux_coef)
        # the combine's weights meet each rank's partial expert outputs:
        # their gradient (and through it the router's) is summed by *f*
        w_sorted = tp_copy_where(w_sorted, routed is not None)
        # slots are unique but for the sink row, which only takes zeros
        xe = routed_input(xk, routed)
        dk = xk.shape[-1]
        buf = x.new_zeros((e * g * cap + 1, dk)).index_copy_(
            0, slot, torch.where(keep[:, None], xe[tok], 0))
        buf = buf[:-1].view(e, g * cap, dk)
        lo = 0
        if routed == "experts":           # this rank's experts' rows only
            el = w_gate.shape[0]
            lo = tp_rank() * el
            buf = buf[lo:lo + el]
            lo *= g * cap

    with record_function(EXPERTS_RANGE):
        # w_gate and w_up of the routed experts, then of the shared ones
        pre = [torch.bmm(buf, w_gate), torch.bmm(buf, w_up)]
        if cfg.num_shared_experts:
            xs = tp_copy_where(xk, shared is not None)
            pre += [xs @ dp_weight(p["ws_gate"], d, 0),
                    xs @ dp_weight(p["ws_up"], d, 0)]
        if kblocks_split(d):            # 2D: summed over data before SiLU
            pre = experts_sum(pre)
        y = torch.bmm(silu(pre[0]) * pre[1], w_down)
        y = y.reshape(-1, y.shape[-1])
        n_y = y.shape[0]

    with record_function(DISPATCH_RANGE):
        at_y = slot - lo
        mine = keep & (at_y >= 0) & (at_y < n_y)
        gath = torch.where(mine[:, None], y[at_y.clamp(0, n_y - 1)], 0)
        # a rank's partial is summed in fp32 (one rounding after the sum)
        contrib = (gath.float() * w_sorted[:, None] if partial
                   else gath * w_sorted[:, None].to(x.dtype))
        # each token's k sorted positions, ascending: expert id ascending
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=dev))
        at = torch.sort(inv.view(t, k), dim=-1).values
        parts = contrib[at]                       # (t, k, d), d / n under 2D
        out = parts[:, 0]
        for i in range(1, k):
            out = out + parts[:, i]

    ys = None
    if cfg.num_shared_experts:
        with record_function(EXPERTS_RANGE):
            ys = (silu(pre[2]) * pre[3]) @ dp_weight(p["ws_down"], d, -1)
    do = out.shape[-1]
    if not partial:
        out = out.reshape(b, s, do)
        if ys is not None:
            out = out + ys.reshape(b, s, do)
    else:
        # the split partials summed in one all-reduce; a whole part (the
        # rules replicate a leaf too narrow to split) joins after it
        split = [out] if routed is not None else []
        whole = [] if routed is not None else [out]
        if ys is not None:
            (split if shared is not None else whole).append(ys.float())
        acc = split[0]
        for y_ in split[1:]:
            acc = acc + y_
        acc = moe_sum(acc)
        for y_ in whole:
            acc = acc + y_
        out = acc.to(x.dtype).reshape(b, s, do)
    # 2D: the rank's columns of the output gathered over the data group
    return dp_gather_cols(out, d), aux
