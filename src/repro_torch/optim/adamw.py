"""AdamW with fp32 masters, global-norm clipping, a cosine schedule and
an optional gradient-compression hook.

The port of the reference's ``optim/adamw.py`` over the port's param
trees (nested dicts of tensors).  State per param leaf: first and second
moments in ``moment_dtype`` (``"bfloat16"`` halves the optimizer's
memory for the largest archs); with ``compress="bf16_ef"`` an fp32
error-feedback leaf re-injects the bf16 quantization error of the
gradient at the next step.  The update is the reference's, in its order:
compress, global norm, clip scale, schedule, bias corrections, then per
leaf the fp32 moments, the step and decoupled weight decay, each result
cast back to its leaf's dtype.

On a process mesh each rank holds its pieces of the params, the
gradients and the state (``train/step.py``): every update but the norm
is elementwise, and :func:`global_norm` sums each leaf's squares once
over the ranks that split it (``replicas``), so every rank clips by the
global norm, the reference's.

The count, the learning rate and the norm stay 0-d tensors on the
params' device, so a step reads nothing back to the host.  The update
runs leaf by leaf under ``torch.no_grad()`` and writes the params and
the moments IN PLACE (the reference's train step donates its state);
it returns them as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.models.param import torch_dtype, tree_leaves, tree_map


# the profiler range around an update (``chip_smoke.py``'s train profile
# reads the device time of the kernels launched inside it)
UPDATE_RANGE = "adamw.update"


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" for 100B+ archs
    compress: Optional[str] = None     # None | "bf16" | "bf16_ef"


def schedule(cfg: OptConfig, step):
    """Linear warmup then cosine decay to ``min_lr_frac``: the learning
    rate at ``step`` (an int or a tensor), a 0-d fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(cfg: OptConfig, params):
    """Zeroed moments (and error feedback) beside each leaf, on its
    device; ``count`` a 0-d int32 tensor."""
    mdt = torch_dtype(cfg.moment_dtype)
    dev = tree_leaves(params)[0].device
    state = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.compress == "bf16_ef":
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def global_norm(tree, replicas=None):
    """sqrt of the sum of squares of every leaf, in fp32 (0-d tensor).

    ``replicas`` (sharded: one count per leaf, in ``tree_leaves`` order):
    each leaf is this rank's piece, held alike by that many ranks of the
    world; each piece's squares are divided by its count and the sum
    all-reduced over the world, so every piece counts once."""
    leaves = tree_leaves(tree)
    if replicas is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    from repro_torch.sharding import comm
    total = sum(torch.sum(torch.square(x.float())) / r
                for x, r in zip(leaves, replicas))
    return torch.sqrt(comm.all_reduce(total.reshape(1), None)[0])


@torch.no_grad()
@record_function(UPDATE_RANGE)
def apply_updates(cfg: OptConfig, params, grads, state, replicas=None):
    """One AdamW step.  ``params``: fp32 masters; ``grads``: a tree of the
    same structure (fp32 or bf16), reduced over the data group where
    sharded.  The params and the state's tensors are updated in place.
    ``replicas``: :func:`global_norm`'s, on a mesh.  Returns (params,
    state, stats), ``stats`` ``{"grad_norm", "lr"}`` as 0-d tensors."""
    count = state["count"] + 1
    gl = tree_leaves(grads)

    if cfg.compress in ("bf16", "bf16_ef"):
        if cfg.compress == "bf16_ef":
            efs = tree_leaves(state["ef"])
            full = [g.float() + e for g, e in zip(gl, efs)]
            gl = [g.to(torch.bfloat16) for g in full]
            for e, g, q in zip(efs, full, gl):
                torch.sub(g, q.float(), out=e)
            del full
        else:
            gl = [g.to(torch.bfloat16) for g in gl]

    gnorm = global_norm(gl, replicas)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, count)
    cf = count.float()
    bc1 = 1 - torch.pow(cfg.b1, cf)
    bc2 = 1 - torch.pow(cfg.b2, cf)

    for p, g, m, v in zip(tree_leaves(params), gl,
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step_ + cfg.weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
