"""Train step: masked cross-entropy, microbatch gradient accumulation,
remat-aware (``cfg.remat``: each layer body under
``torch.utils.checkpoint``, ``models/layers.py::remat``).

The port of the reference's ``train/step.py``.  The fp32 masters are
cast to a compute copy outside the loss (bf16 for every matrix of a bf16
model), and that copy is what autograd differentiates: weight gradients
come out in the compute dtype and are upcast to fp32 only at the
accumulator and the optimizer, as the reference does.  No hand-written
kernel runs here: ``core/linear.py`` keeps the TSMM kernels to serving,
and ``models/attention.py::flash_eligible`` keeps flash off any call
autograd records.  The reference's pin of the compute copy to the
masters' sharding waits for training's sharding slice (ROADMAP.md Queue 1
item 4).
"""

from __future__ import annotations

import torch

from repro_torch.models.param import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state


def cross_entropy(logits, labels):
    """Masked CE in fp32.  labels == -100 are ignored (a VLM's image
    positions)."""
    mask = labels != -100
    lab = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1)
    return (ce * mask).sum() / denom


def make_loss_fn(model):
    """``loss_fn(compute_params, batch) -> (loss + aux, {"loss", "aux"})``
    of the compute copy."""

    def loss_fn(compute_params, batch):
        logits, aux = model.forward(compute_params, batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss + aux, {"loss": loss, "aux": aux}

    return loss_fn


def cast_params_for_compute(params, cfg):
    """The compute copy: every fp32 leaf with ``ndim >= 2`` in bf16 when
    ``cfg.dtype`` is bfloat16 (a stacked norm or bias is 2-D, so it
    casts too, as in the reference); every other leaf as it is."""
    return tree_map(
        lambda p: p.to(torch.bfloat16)
        if (p.dtype == torch.float32 and p.ndim >= 2
            and cfg.dtype == "bfloat16") else p, params)


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
    in order), accumulating their fp32 gradients divided by k; a batch k
    does not divide runs whole, as in the reference.  ``metrics``: the
    loss and aux (the mean over micro-slices), ``grad_norm`` and ``lr``,
    0-d tensors on the device.  The state is updated in place (the
    reference donates it) and returned."""
    loss_fn = make_loss_fn(model)
    k = microbatch or model.cfg.microbatch

    def grads_of(compute, batch):
        flat = tree_leaves(compute)
        with torch.enable_grad():
            total, metrics = loss_fn(compute, batch)
            grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return grads, {n: t.detach() for n, t in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        # the autograd leaves: the compute copy (a cast), or the masters'
        # storage (fp32 compute) under a leaf of its own
        compute = tree_map(lambda p: p.detach().requires_grad_(),
                           cast_params_for_compute(params, model.cfg))
        b = tree_leaves(batch)[0].shape[0]
        kk = k if (k > 1 and b % k == 0 and b >= k) else 1
        if kk > 1:
            n = b // kk
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            ms = []
            for i in range(kk):
                mb = {key: t[i * n:(i + 1) * n] for key, t in batch.items()}
                g, m = grads_of(compute, mb)
                for a, gg in zip(acc, g):
                    a.add_(gg.float() / kk)
                ms.append(m)
            grads = acc
            metrics = {key: torch.stack([m[key] for m in ms]).mean()
                       for key in ms[0]}
        else:
            grads, metrics = grads_of(compute, batch)
        del compute
        _, opt, stats = apply_updates(ocfg, params,
                                      tree_unflatten(params, grads),
                                      state["opt"])
        metrics.update(stats)
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                metrics)

    return train_step

