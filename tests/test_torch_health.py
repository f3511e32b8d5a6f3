"""``Engine.health_report`` and the serving seams of the resilience plane
(DESIGN.md §16) on the CPU.

The reduced qwen1.5-4b, enlarged so every projection and the head pack,
in float32: on the happy path (aligned groups, the queue and the front
end) the report is healthy with zero demotions; an engine with every
kernel rung knocked out (``kernels.lower.*`` and ``kernels.xla.*``
raise, so ``torch.matmul`` serves) still serves the healthy run's tokens
and reports its demotions; ``launch/serve.py --health`` exits non-zero
when the engine degraded; a ``frontend.admit`` fault is absorbed by
``AsyncEngine.submit_retry``.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_reduced_config
from repro_torch.core import registry
from repro_torch.models.registry import build_model
from repro_torch.resilience import failpoints
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.engine import Engine
from repro_torch.serve.frontend import AsyncEngine
from repro_torch.serve.scheduler import Request

WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
REPO = Path(__file__).resolve().parents[1]
ALL_RUNGS = {"kernels.lower.skinny": "raise", "kernels.lower.tall": "raise",
             "kernels.xla.skinny": "raise", "kernels.xla.tall": "raise"}


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    for var in ("REPRO_TORCH_TUNE_QUEUE", "REPRO_TORCH_FIND_DB",
                "REPRO_TORCH_FAILPOINTS"):
        monkeypatch.delenv(var, raising=False)
    registry.clear_memory()
    failpoints.reset()
    yield
    failpoints.reset()
    registry.clear_memory()


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE)
    m = build_model(cfg)
    params, axes = m.init(torch.Generator().manual_seed(0))
    return m, params, axes


def _engine(model, **kw):
    m, params, axes = model
    return Engine(m, params, axes, max_len=64, max_batch=2, max_prompt=16,
                  device="cpu", **kw)


def _group(cfg, b=2, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32))}


def _reqs(cfg, n=4):
    rng = np.random.default_rng(1)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, size=5 + 3 * i)
                    .astype(np.int32), max_new_tokens=3, rid=i)
            for i in range(n)]


def test_health_report_zero_on_the_happy_path(model):
    eng = _engine(model)
    cfg = eng.model.cfg
    eng.generate(_group(cfg), 3)
    eng.serve_queue(_reqs(cfg))
    streams, _ = AsyncEngine(eng, clock=VirtualClock()).simulate(
        _reqs(cfg))
    assert all(s.completed for s in streams)
    hr = eng.health_report()
    assert hr["healthy"], hr
    assert hr["degradations"]["total"] == 0
    assert hr["degradations"]["breaker"]["open"] == []
    assert hr["failpoints"] == {}
    assert hr["programs"]["programs"] >= 2


def test_fully_degraded_engine_serves_the_healthy_tokens(model):
    healthy = _engine(model)
    cfg = healthy.model.cfg
    want = healthy.generate(_group(cfg), 3)
    want_q, _ = healthy.serve_queue(_reqs(cfg))
    failpoints.configure(ALL_RUNGS)
    eng = _engine(model)
    got = eng.generate(_group(cfg), 3)
    after_generate = dict(eng.degrade.counts)
    got_q, _ = eng.serve_queue(_reqs(cfg))
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
    np.testing.assert_allclose(got.logits_last.numpy(),
                               want.logits_last.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert [r.tokens.tolist() for r in got_q] == \
        [r.tokens.tolist() for r in want_q]
    hr = eng.health_report()
    seams = hr["degradations"]["by_seam"]
    assert not hr["healthy"]
    assert seams["kernel.variant"] >= 1 and seams["kernel.xla"] >= 1
    # every planned call took the bottom rung, and the queue's steps
    # counted on the engine too (the scheduler's seam)
    assert seams["kernel.xla"] == seams["kernel.variant"] + seams.get(
        "kernel.pinned", 0)
    assert seams["kernel.xla"] > after_generate["kernel.xla"]
    assert hr["degradations"]["breaker"]["open"]
    assert set(hr["failpoints"]) == set(ALL_RUNGS)
    assert healthy.health_report()["healthy"]


def test_a_torn_find_db_shows_in_the_engine_health(model, tmp_path,
                                                   monkeypatch):
    fdb = tmp_path / "find_db.json"
    fdb.write_text('{"header": {"schema": 1, "grammar')
    monkeypatch.setenv("REPRO_TORCH_FIND_DB", str(fdb))
    eng = _engine(model)
    hr = eng.health_report()
    assert hr["degradations"]["by_seam"] == {"registry.find_db": 1}
    assert not hr["healthy"]


def test_engine_takes_its_fleet_queue_from_the_environment(model, tmp_path,
                                                           monkeypatch):
    from repro_torch.tuning.queue import JobQueue
    assert _engine(model).tune_queue is None
    monkeypatch.setenv("REPRO_TORCH_TUNE_QUEUE", str(tmp_path / "q.json"))
    eng = _engine(model, background_tune=True)
    assert isinstance(eng.tune_queue, JobQueue)
    assert eng.tune_queue.path() == tmp_path / "q.json"
    assert eng.tuner.queue is eng.tune_queue
    eng.tuner.join(timeout=300)


def _serve(env_extra):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), **env_extra}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1_5_4b", "--reduced", "--override",
         "d_model=512,d_ff=1024,num_heads=4,num_kv_heads=4,head_dim=128",
         "--device", "cpu", "--trace", "1", "--steps", "2",
         "--prompt-len", "16", "--health"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180)


@pytest.mark.parametrize("env,healthy", [
    ({}, True),
    ({"REPRO_TORCH_FAILPOINTS": "kernels.lower.skinny=raise"}, False),
    # the reference's variable arms nothing in the port
    ({"REPRO_FAILPOINTS": "kernels.lower.skinny=raise"}, True),
], ids=["healthy", "degraded", "reference-env"])
def test_serve_health_flag(env, healthy, tmp_path):
    out = _serve({**env, "REPRO_TORCH_PLAN_CACHE": str(tmp_path / "p.json")})
    assert "-- health report --" in out.stdout, out.stderr[-2000:]
    if healthy:
        assert out.returncode == 0, out.stderr[-2000:]
        assert '"healthy": true' in out.stdout
    else:
        assert out.returncode != 0
        assert "--health:" in out.stderr and "degradation" in out.stderr


def _afe(model):
    return AsyncEngine(_engine(model), clock=VirtualClock())


def test_submit_retry_recovers_from_transient_faults(model):
    afe = _afe(model)
    failpoints.configure({"frontend.admit": {"action": "raise",
                                             "times": 2}})

    async def main():
        run = asyncio.ensure_future(afe.run())
        stream = await afe.submit_retry(_reqs(afe.engine.model.cfg, 1)[0],
                                        retries=3, backoff_s=0.01)
        toks = [t async for t in stream]
        afe.request_stop()
        await run
        return stream, toks

    stream, toks = asyncio.run(main())
    assert stream.completed and len(toks) == 3
    assert failpoints.report()["frontend.admit"]["fired"] == 2


def test_submit_retry_exhausts_and_raises(model):
    from repro_torch.serve.frontend import AdmissionError
    afe = _afe(model)
    failpoints.configure({"frontend.admit": "raise"})

    async def main():
        with pytest.raises(AdmissionError, match="transient admission"):
            await afe.submit_retry(_reqs(afe.engine.model.cfg, 1)[0],
                                   retries=2, backoff_s=0.001)

    asyncio.run(main())
    assert failpoints.report()["frontend.admit"]["fired"] == 3
