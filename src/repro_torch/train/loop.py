"""Fault-tolerant training loop.

The port of the reference's ``train/loop.py``:

* auto-resume from the latest atomic checkpoint;
* periodic async checkpointing (a synchronous host snapshot, the disk
  write on a thread), and a save at the last step;
* straggler watchdog: an EWMA of the step's wall time; a step slower
  than ``straggler_factor`` x the EWMA is logged and counted;
* data regenerated deterministically from (seed, step), so a resumed run
  never replays or skips a batch.

The loss is read with one host sync a step (the reference's
``float(metrics["loss"])``), so a step's wall time is its device time
and the watchdog sees it.  The loop runs on ``device``, the card by
default, and raises where there is none.  The reference's mesh, its
sharding options and its elastic mesh rebuild wait for training's
sharding slice (ROADMAP.md Queue 1 item 4).
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
from repro_torch.train.step import init_train_state, make_train_step

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


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train.loop: no CUDA device (pass device='cpu' "
                           "to train on the CPU)")
    return device


def run(model, shape, lcfg: LoopConfig, ocfg: OptConfig, *,
        device="cuda", params=None,
        fail_at: Optional[int] = None) -> LoopReport:
    """Train ``model`` on synthetic data for ``lcfg.total_steps``.

    ``params``: initial params (a converted reference tree) in place of
    ``model.init`` from ``lcfg.seed``.  ``fail_at``: raise a simulated
    failure after that step (tests resume)."""
    device = _device(device)
    report = LoopReport()
    mgr = CheckpointManager(lcfg.ckpt_dir, keep=lcfg.keep)
    data = SyntheticData(model.cfg, shape, seed=lcfg.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(lcfg.seed)
    if params is not None:
        params = tree_map(lambda p: p.to(device), params)
    state = init_train_state(model, ocfg, generator=gen, params=params)
    step_fn = make_train_step(model, ocfg)

    start = 0
    got = mgr.restore_latest(state, device)
    if got[0] is not None:
        start, state = got
        report.resumed_from = start
        log.info("resumed from step %d", start)

    def held(fn, *args):
        """``fn(*args)``, its seconds added to the time saves held us."""
        t0 = time.perf_counter()
        fn(*args)
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
        if (step + 1) % lcfg.ckpt_every == 0 or step + 1 == lcfg.total_steps:
            held(mgr.save, step + 1, state)
        if fail_at is not None and step + 1 == fail_at:
            held(mgr.wait)
            raise SimulatedFailure(step + 1)
    held(mgr.wait)
    report.step_time_ewma = ewma or 0.0
    return report
