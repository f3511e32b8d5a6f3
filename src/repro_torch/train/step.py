"""Train step: masked cross-entropy, microbatch gradient accumulation,
remat-aware (``cfg.remat``: each layer body under
``torch.utils.checkpoint``, ``models/layers.py::remat``), on one rank or
sharded over a process mesh.

The port of the reference's ``train/step.py``.  The fp32 masters are
cast to a compute copy outside the loss (bf16 for every matrix of a bf16
model), and that copy is what autograd differentiates: weight gradients
come out in the compute dtype and are upcast to fp32 only at the
accumulator and the optimizer, as the reference does.  No hand-written
kernel runs here: ``core/linear.py`` keeps the TSMM kernels to serving,
and ``models/attention.py::flash_eligible`` keeps flash off any call
autograd records.

On a process mesh (the ambient ``sharding_ctx`` of a
``launch/mesh.py::ProcessMesh``) each rank holds its pieces of the
masters and of the optimizer state under ``param_specs`` (the rules'
``pspec_for``: TP on ``model``, FSDP on ``fsdp_axes``) and its rows of
the global batch (split over the data axis).  Where the reference leaves
the collectives to GSPMD, they run explicitly, each through
``sharding/comm.py``:

* **cast before gather** (the reference's pin of the compute copy to the
  masters' layout): each FSDP shard is cast to bf16 first and then
  gathered (``comm.fsdp_gather``), the whole compute tree at the start of
  the step; its backward reduce-scatters the gradient onto the shards;
* **tensor parallelism**: the model's own sites (``sharding/context.py``:
  *f* at the column-parallel inputs, *g* after the row-parallel outputs,
  the logits gathered), so every TP rank computes the same loss;
* **data parallelism**: each micro-slice's gradients of the leaves FSDP
  does not shard are all-reduced over the data group in the compute
  dtype (the FSDP leaves' reduce-scatter sums them), then accumulated in
  fp32;
* **the loss is the global batch's**: the cross-entropy's sum and its
  label count are summed over the data group (one all-reduce of two
  numbers a micro-slice, three with an MoE model's aux share beside
  them), and each rank differentiates its sum over the global count, so
  the summed gradients are the global loss's;
* **so is the MoE aux loss**: each MoE layer all-reduces its expert
  counts over the data group and each rank adds its share of the global
  batch's aux (``models/moe.py::load_balance_aux``), so the summed
  shares and their gradients are the reference's; the ``aux`` metric is
  the shares' sum.  The dispatch groups are the reference's: a rank's
  rows are one group of the global batch (``sharding/context.py::
  moe_groups``);
* ``optim/adamw.py::global_norm`` sums each leaf's squares once over the
  ranks that split it.

Microbatch accumulation takes ``kk`` from the global batch, as the
reference does; each rank's rows are cut into ``kk`` slices in order
(the reference's slice i is the global rows i).  For the dense family
the two agree where every row carries the same number of labels, as
every synthetic batch does; for the MoE family the rows that share a
micro-slice set its capacity drops and its aux loss, so slice i of a
mesh step is the reference's slice i of the global batch with its rows
in the order (rank 0's slice i, rank 1's slice i, ...).  A mesh step
refuses what it does not run: a mesh description without processes,
any family but the dense and MoE ones (SSM, the hybrid, the VLM and the
encoder-decoder train on one rank; ``sharding/context.py::
check_dense_mesh``), sequence parallelism, 2-D TP, a batch split over
several data axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.param import (MetaGenerator, tree_leaves, tree_map,
                                      tree_unflatten)
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.sharding.context import check_dense_mesh, get_ctx
from repro_torch.sharding.rules import (ShardingOptions, axis_size,
                                        param_pspecs, spec_leaves)


def ce_sums(logits, labels):
    """(sum of the masked CE in fp32, the count of labels) of a batch:
    labels == -100 are ignored (a VLM's image positions)."""
    mask = labels != -100
    lab = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
    return (ce * mask).sum(), mask.sum()


def cross_entropy(logits, labels):
    """Masked CE in fp32: the sum over the labels' count (at least 1)."""
    num, cnt = ce_sums(logits, labels)
    return num / torch.clamp(cnt, min=1)


def _live_axes(mesh, axes) -> tuple:
    """Those of ``axes`` that ``mesh`` has with more than one rank: a
    data axis of one rank is the one-rank step along it, with no
    collective (the TP sites keep their collectives at one rank:
    ``sharding/context.py::tp_split``)."""
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def _fsdp_dim(spec, fsdp_axes) -> Optional[tuple]:
    """(dim, axis) where ``spec`` puts an FSDP axis, or None."""
    for i, entry in enumerate(spec):
        if entry in fsdp_axes:
            return i, entry
    return None


def _gather_like_params(compute, specs):
    """Each leaf of ``compute`` that its spec shards over an FSDP axis
    gathered to its full size over that axis's group (differentiably:
    ``comm.fsdp_gather``); the rest as they are."""
    ctx = get_ctx()
    if ctx is None or specs is None or not ctx.opts.fsdp:
        return compute
    from repro_torch.sharding import comm
    fs = _live_axes(ctx.mesh, ctx.opts.fsdp_axes)

    def one(leaf, spec):
        if isinstance(leaf, dict):
            return {k: one(leaf[k], spec[k]) for k in leaf}
        hit = _fsdp_dim(spec, fs)
        if hit is None:
            return leaf
        return comm.fsdp_gather(leaf, ctx.group(hit[1]), hit[0])

    return one(compute, specs)


def cast_params_for_compute(params, cfg, specs=None):
    """The compute copy: every fp32 leaf with ``ndim >= 2`` in bf16 when
    ``cfg.dtype`` is bfloat16 (a stacked norm or bias is 2-D, so it
    casts too, as in the reference); every other leaf as it is.  With
    ``specs`` (the masters' partition specs) under a process mesh's
    sharding context, each FSDP shard is then gathered: cast before
    gather, so the forward's gathers move bf16."""
    compute = tree_map(
        lambda p: p.to(torch.bfloat16)
        if (p.dtype == torch.float32 and p.ndim >= 2
            and cfg.dtype == "bfloat16") else p, params)
    return _gather_like_params(compute, specs)


def param_specs(model, mesh, opts: ShardingOptions):
    """The partition spec of every param leaf of ``model`` on ``mesh``
    (``sharding/rules.py::param_pspecs`` over the full shapes, which a
    ``meta`` init gives without allocating)."""
    params, axes = model.init(MetaGenerator())
    return param_pspecs(axes, params, mesh, opts)


def check_mesh(cfg, mesh, opts: ShardingOptions) -> None:
    """Refuse what a sharded train step does not run: a family other
    than the dense and MoE ones, and ``check_dense_mesh``'s other
    refusals; a batch over several data axes, FSDP beyond the data axis,
    the query heads split and not the KV heads."""
    split = check_dense_mesh(cfg, mesh, opts, "a sharded train step")
    dp = [a for a in opts.dp_axes if a in mesh.shape]
    if len(dp) > 1:
        raise NotImplementedError(f"a batch split over several data axes "
                                  f"({dp})")
    if opts.fsdp and any(a in mesh.shape and a not in dp
                         for a in opts.fsdp_axes):
        raise NotImplementedError(f"FSDP over {opts.fsdp_axes} beyond the "
                                  f"data axes {dp}")
    if split.get("kvheads", split["qheads"]) != split["qheads"]:   # GQA
        raise NotImplementedError(f"{cfg.name}: the rules split the query "
                                  f"heads and not the KV heads, or the "
                                  f"reverse")


@dataclasses.dataclass
class MeshPlan:
    """What a sharded step needs of its mesh, per param leaf in
    ``tree_leaves`` order: the specs, the data group its rows split over
    (None: every rank holds the whole batch), each leaf's FSDP dim (None:
    not sharded by FSDP) and how many ranks hold each leaf's piece."""
    specs: dict
    dp: object
    dp_size: int
    fsdp: list
    replicas: list


def mesh_plan(model, mesh, opts: ShardingOptions) -> MeshPlan:
    """The :class:`MeshPlan` of ``model`` on the process ``mesh`` (which
    :func:`check_mesh` must pass)."""
    check_mesh(model.cfg, mesh, opts)
    specs = param_specs(model, mesh, opts)
    dp = _live_axes(mesh, opts.dp_axes)
    fs = _live_axes(mesh, opts.fsdp_axes) if opts.fsdp else ()
    size = math.prod(mesh.shape.values())
    flat = spec_leaves(specs)
    return MeshPlan(
        specs=specs, dp=mesh.group(dp[0]) if dp else None,
        dp_size=mesh.shape[dp[0]] if dp else 1,
        fsdp=[_fsdp_dim(sp, fs) for sp in flat],
        replicas=[size // axis_size(mesh, tuple(e for e in sp if e))
                  for sp in flat])


def init_train_state(model, ocfg: OptConfig, generator=None, params=None):
    """``{"params", "opt", "step"}``: fp32 masters of every leaf, the
    optimizer state beside them and a 0-d int32 step, on the params'
    device.  ``params``: an initialized tree (the reference's, carried
    over by ``models/param.py::params_from_numpy``); else ``model.init``
    on ``generator``."""
    if params is None:
        params = model.init(generator)[0]
    # a copy: the masters are updated in place, the caller's tree is not
    params = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": init_opt_state(ocfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(model, ocfg: OptConfig, microbatch: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``microbatch`` k > 1 runs k micro-slices of the global batch (rows
    in order), accumulating their fp32 gradients divided by k; a global
    batch k does not divide runs whole, as in the reference.  ``metrics``:
    the loss and aux (the mean over micro-slices), ``grad_norm`` and
    ``lr``, 0-d tensors on the device.  The state is updated in place
    (the reference donates it) and returned.

    Under a process mesh's ``sharding_ctx`` the step is sharded (the
    module's docstring): ``state`` holds the rank's pieces, ``batch`` its
    rows, and the result equals the one-rank step's."""
    k = microbatch or model.cfg.microbatch
    plans: dict = {}

    def plan_of():
        ctx = get_ctx()
        if ctx is None:
            return None
        key = (id(ctx.mesh), ctx.opts)
        if key not in plans:
            plans[key] = mesh_plan(model, ctx.mesh, ctx.opts)
        return plans[key]

    moe = bool(model.cfg.num_experts)

    def grads_of(compute, leaves, batch, plan, retain):
        """The gradients of ``leaves`` (the autograd leaves under
        ``compute``) for ``batch``, data-parallel reduced; the metrics.
        ``aux`` is the rank's share of the global aux loss (its MoE
        layers' ``load_balance_aux``), its metric the data group's sum."""
        from repro_torch.sharding import comm
        with torch.enable_grad():
            logits, aux = model.forward(compute, batch)
            num, cnt = ce_sums(logits, batch["labels"])
            del logits
            aux_m = aux.detach()
            if plan is not None and plan.dp is not None:
                tot = comm.all_reduce(torch.stack(
                    [num.detach(), cnt.to(num.dtype)]
                    + ([aux_m] if moe else [])), plan.dp)
                denom = torch.clamp(tot[1], min=1)
                loss, obj = tot[0] / denom, num / denom
                if moe:
                    aux_m = tot[2]
            else:
                loss = obj = num / torch.clamp(cnt, min=1)
            grads = torch.autograd.grad(obj + aux, leaves, allow_unused=True,
                                        retain_graph=retain)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if plan is not None and plan.dp is not None:
            grads = [g if fs is not None else comm.all_reduce(g, plan.dp)
                     for g, fs in zip(grads, plan.fsdp)]
        return grads, {"loss": loss.detach(), "aux": aux_m}

    def train_step(state, batch):
        plan = plan_of()
        params = state["params"]
        # the autograd leaves: the compute copy (a cast) of the masters, or
        # their storage (fp32 compute) under a leaf of its own; on a mesh,
        # each rank's shards, gathered after the cast
        leaves = [p.detach().requires_grad_() for p in tree_leaves(
            cast_params_for_compute(params, model.cfg))]
        with torch.enable_grad():
            compute = cast_params_for_compute(
                tree_unflatten(params, leaves), model.cfg,
                plan.specs if plan is not None else None)
        b = tree_leaves(batch)[0].shape[0]
        rows = b * (plan.dp_size if plan is not None else 1)
        kk = k if (k > 1 and rows % k == 0 and rows >= k) else 1
        if b % kk:
            raise ValueError(f"{kk} micro-slices of the global batch of "
                             f"{rows} do not cut this rank's {b} rows")
        if kk > 1:
            n = b // kk
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            ms = []
            for i in range(kk):
                mb = {key: t[i * n:(i + 1) * n] for key, t in batch.items()}
                g, m = grads_of(compute, leaves, mb, plan, i < kk - 1)
                for a, gg in zip(acc, g):
                    a.add_(gg.float() / kk)
                ms.append(m)
            grads = acc
            metrics = {key: torch.stack([m[key] for m in ms]).mean()
                       for key in ms[0]}
        else:
            grads, metrics = grads_of(compute, leaves, batch, plan, False)
        del compute, leaves
        _, opt, stats = apply_updates(
            ocfg, params, tree_unflatten(params, grads), state["opt"],
            replicas=plan.replicas if plan is not None else None)
        metrics.update(stats)
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                metrics)

    return train_step
