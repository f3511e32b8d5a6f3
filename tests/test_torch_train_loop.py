"""The port's fault-tolerant training loop and its launcher, on the CPU:
the reference's behaviours (``tests/test_system.py``) at the same sizes
(loss decreases, resume continues exactly, straggler watchdog), and no
silent fallback from the card to the CPU."""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec, get_reduced_config
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import loop as L
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the models here are tiny, and torch's thread
    pool spins when the test workers share the cores (a 16x slower file
    under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny_setup(tmp_path):
    cfg = get_reduced_config("h2o_danube_1_8b")
    model = build_model(cfg)
    shape = ShapeSpec("tiny", 32, 4, "train")
    lcfg = LoopConfig(total_steps=10, ckpt_every=5, log_every=100,
                      ckpt_dir=str(tmp_path / "ck"))
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    return model, shape, lcfg, ocfg


def test_loss_decreases(tiny_setup, tmp_path):
    model, shape, _, _ = tiny_setup
    lcfg = LoopConfig(total_steps=20, ckpt_every=50, log_every=100,
                      ckpt_dir=str(tmp_path / "loss_ck"))
    ocfg = OptConfig(lr=5e-3, warmup_steps=2, decay_steps=20)
    report = run(model, shape, lcfg, ocfg, device="cpu")
    assert report.steps_run == 20
    assert len(report.step_times) == 20
    first, last = np.mean(report.losses[:3]), np.mean(report.losses[-3:])
    assert last < first, (first, last)


def test_failure_then_resume_continues_exactly(tiny_setup):
    model, shape, lcfg, ocfg = tiny_setup
    with pytest.raises(SimulatedFailure):
        run(model, shape, lcfg, ocfg, device="cpu", fail_at=5)
    report = run(model, shape, lcfg, ocfg, device="cpu")
    assert report.resumed_from == 5
    assert report.steps_run == 5                   # only the remaining steps
    # a clean run from scratch must produce the same final loss (the
    # reference's bound; on the CPU the resumed losses are bit-equal)
    shutil.rmtree(lcfg.ckpt_dir)
    clean = run(model, shape, lcfg, ocfg, device="cpu")
    assert abs(clean.losses[-1] - report.losses[-1]) < 2e-2
    assert clean.losses[5:] == report.losses


def test_params_start_the_run_and_stay_the_callers(tiny_setup):
    model, shape, lcfg, ocfg = tiny_setup
    params = model.init(torch.Generator().manual_seed(0))[0]
    before = {k: v for k, v in params["layers"]["attn"].items()}
    snap = {k: v.clone() for k, v in before.items()}
    lcfg.total_steps = 2
    report = run(model, shape, lcfg, ocfg, device="cpu", params=params)
    assert report.steps_run == 2
    for k, v in before.items():
        assert torch.equal(v, snap[k]), k


def test_straggler_watchdog_records(monkeypatch, tiny_setup):
    model, shape, lcfg, ocfg = tiny_setup
    real = L.time.perf_counter
    calls = {"n": 0}

    def slow_clock():
        calls["n"] += 1
        # jump the clock at one step's END timestamp -> one huge dt
        return real() + (30.0 if calls["n"] == 16 else 0.0)

    monkeypatch.setattr(L.time, "perf_counter", slow_clock)
    report = run(model, shape, lcfg, ocfg, device="cpu")
    assert len(report.straggler_steps) >= 1
    assert all(s > 1 for s in report.straggler_steps)


def test_launcher_summary(tmp_path, capsys):
    report = train_cli.main(["--device", "cpu", "--reduced", "--steps", "3",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert report.steps_run == 3
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("ran 3 steps; loss ")
    assert line.endswith("stragglers=0; resumed_from=None")
    assert (tmp_path / "ck" / "step_000000000003" / "proc_000.npz").exists()


def test_no_silent_fallback_to_the_cpu(tiny_setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    model, shape, lcfg, ocfg = tiny_setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(model, shape, lcfg, ocfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "ck")])
