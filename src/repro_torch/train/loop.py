"""Fault-tolerant training loop.

The port of the reference's ``train/loop.py``:

* auto-resume from the latest atomic checkpoint;
* periodic async checkpointing (a synchronous host snapshot, the disk
  write on a thread), and a save at the last step;
* straggler watchdog: an EWMA of the step's wall time; a step slower
  than ``straggler_factor`` x the EWMA is logged and counted;
* data regenerated deterministically from (seed, step), so a resumed run
  never replays or skips a batch;
* sharded on a process mesh (``mesh``, ``opts``: data parallelism over
  ``data``, FSDP with ``opts.fsdp``, tensor parallelism over ``model``;
  ``train/step.py``): each rank holds its pieces of the state and builds
  its rows of each batch (``_batch_spec``); checkpoints hold full leaves
  and restore onto whatever mesh resumes;
* elastic restart: after a failure, :func:`make_elastic_mesh` gives the
  largest (data, model) mesh the surviving ranks fill, and ``run`` on it
  resumes from the same checkpoint, the step read on rank 0 and
  broadcast.

The loss is read with one host sync a step (the reference's
``float(metrics["loss"])``), so a step's wall time is its device time
and the watchdog sees it.  The loop runs on ``device``, the card by
default, and raises where there is none; on a mesh it runs on the
mesh's device, which must be of that type.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticData
from repro_torch.kernels.cuda import BUILD_ROOT
from repro_torch.models.param import tree_map
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding.context import sharding_ctx
from repro_torch.sharding.rules import (Mesh, P, ShardingOptions,
                                        local_params)
from repro_torch.train.step import (check_mesh, init_train_state,
                                    make_train_step)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    ckpt_dir: str = str(BUILD_ROOT / "train_ckpt")
    keep: int = 3
    straggler_factor: float = 3.0
    seed: int = 0


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    resumed_from: Optional[int] = None
    losses: list = dataclasses.field(default_factory=list)
    straggler_steps: list = dataclasses.field(default_factory=list)
    step_time_ewma: float = 0.0
    # each step's wall seconds (the loss read included), and the seconds
    # the loop was held by checkpoint saves: the host snapshots and the
    # waits for a write in flight
    step_times: list = dataclasses.field(default_factory=list)
    save_s: float = 0.0


class SimulatedFailure(RuntimeError):
    pass


def _device(device, mesh=None) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train.loop: no CUDA device (pass device='cpu' "
                           "to train on the CPU)")
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh's ranks run on {mesh.device}, not "
                             f"{device}")
        return mesh.device
    return device


def run(model, shape, lcfg: LoopConfig, ocfg: OptConfig, *,
        device="cuda", params=None, mesh=None,
        opts: Optional[ShardingOptions] = None,
        fail_at: Optional[int] = None) -> LoopReport:
    """Train ``model`` on synthetic data for ``lcfg.total_steps``.

    ``params``: initial params (a converted reference tree; full, or on a
    mesh this rank's pieces) in place of ``model.init`` from
    ``lcfg.seed``.  ``mesh``: a ``launch/mesh.py::ProcessMesh`` to train
    on, sharded by ``opts``.  ``fail_at``: raise a simulated failure
    after that step (tests resume)."""
    opts = opts or ShardingOptions()
    device = _device(device, mesh)
    report = LoopReport()
    mgr = CheckpointManager(lcfg.ckpt_dir, keep=lcfg.keep)
    data = SyntheticData(model.cfg, shape, seed=lcfg.seed, device=device,
                         mesh=mesh, batch_spec=_batch_spec(mesh, opts))
    gen = torch.Generator(device=device).manual_seed(lcfg.seed)
    full = specs = None
    if mesh is not None:
        from repro_torch.launch.specs import train_state_specs
        check_mesh(model.cfg, mesh, opts)
        full, specs, _ = train_state_specs(model, ocfg, mesh, opts)
        if params is None:
            params = model.init(gen)[0]
        params = local_params(params, specs["params"], full["params"],
                              mesh)
    if params is not None:
        params = tree_map(lambda p: p.to(device), params)
    state = init_train_state(model, ocfg, generator=gen, params=params)
    step_fn = make_train_step(model, ocfg)

    with sharding_ctx(mesh, opts):
        start = 0
        got = mgr.restore_latest(full if mesh is not None else state,
                                 device, specs, mesh)
        if got[0] is not None:
            start, state = got
            report.resumed_from = start
            log.info("resumed from step %d", start)

        def held(fn, *args, **kw):
            """``fn(...)``, its seconds added to the time saves held us."""
            t0 = time.perf_counter()
            fn(*args, **kw)
            report.save_s += time.perf_counter() - t0

        ewma = None
        for step in range(start, lcfg.total_steps):
            t0 = time.perf_counter()
            batch = data.batch(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if step > start + 1 and dt > lcfg.straggler_factor * ewma:
                report.straggler_steps.append(step)
                log.warning("straggler step %d: %.3fs vs ewma %.3fs",
                            step, dt, ewma)
            if step % lcfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            report.losses.append(loss)
            report.step_times.append(dt)
            report.steps_run += 1
            if (step + 1) % lcfg.ckpt_every == 0 or \
                    step + 1 == lcfg.total_steps:
                held(mgr.save, step + 1, state, specs=specs, mesh=mesh)
            if fail_at is not None and step + 1 == fail_at:
                held(mgr.wait)
                raise SimulatedFailure(step + 1)
        held(mgr.wait)
    report.step_time_ewma = ewma or 0.0
    return report


def _batch_spec(mesh, opts: ShardingOptions) -> P:
    """The batch dim's spec: over the data axes of ``mesh`` (replicated
    off a mesh or where it has none)."""
    if mesh is None:
        return P(None)
    dp = tuple(a for a in opts.dp_axes if a in mesh.shape)
    return P(dp if len(dp) > 1 else (dp[0] if dp else None))


def make_elastic_mesh(world: int, tp: int = 1) -> Mesh:
    """The largest (data, model) mesh that ``world`` surviving ranks fill
    with ``tp``-wide model lines (the ranks past ``data * tp`` idle): the
    shape a restart passes to ``launch/mesh.py::make_mesh``."""
    dp = world // tp
    if dp < 1:
        raise ValueError(f"{world} ranks cannot fill a model axis of {tp}")
    return Mesh.of((dp, tp), ("data", "model"))
