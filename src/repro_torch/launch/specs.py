"""Training's sharding choices and the train state's specs.

The training part of the reference's ``launch/specs.py``: the FSDP
threshold and :func:`sharding_options`, and :func:`train_state_specs`,
the train state's shapes beside its partition specs (the masters on the
rules' specs; ``m``, ``v`` and ``ef`` on the masters'; ``count`` and
``step`` replicated).  Shapes are ``meta`` tensors: nothing is
allocated.  The dry-run's ``input_specs`` and ``batch_specs`` are not
ported.
"""

from __future__ import annotations

from repro_torch.models.param import MetaGenerator
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding.rules import P, ShardingOptions
from repro_torch.train.step import init_train_state, param_specs

# FSDP threshold: shard params over the data axis for >= 8B-param archs.
FSDP_MIN_PARAMS = 8_000_000_000


def sharding_options(mesh, n_params: int) -> ShardingOptions:
    """TP on ``model``, DP over the mesh's ``pod`` / ``data`` axes, FSDP on
    them from ``FSDP_MIN_PARAMS`` parameters up."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return ShardingOptions(tp_axis="model", dp_axes=dp,
                           fsdp=n_params >= FSDP_MIN_PARAMS, fsdp_axes=dp)


def train_state_specs(model, ocfg: OptConfig, mesh, opts: ShardingOptions):
    """(the train state's full shapes as ``meta`` tensors, its spec tree,
    the params' logical axes) for ``train/step.py``'s state on ``mesh``."""
    params, axes = model.init(MetaGenerator())
    state = init_train_state(model, ocfg, params=params)
    p_specs = param_specs(model, mesh, opts)
    opt = {"m": p_specs, "v": p_specs, "count": P()}
    if "ef" in state["opt"]:
        opt["ef"] = p_specs
    return state, {"params": p_specs, "opt": opt, "step": P()}, axes
