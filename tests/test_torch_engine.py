"""The port's serving engine and launcher against the reference engine.

Float32 config (the reduced qwen1.5-4b enlarged so every projection and
the head pack), where greedy decoding is pinned token for token: both
engines see the reference's params and must pack the same leaves and
emit the same tokens.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import registry as ref_registry
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro_torch.configs.base import get_reduced_config
from repro_torch.core import registry
from repro_torch.models.param import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine

WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    """The port's plan, measurement and miss files in a temporary
    directory for the module (planning persists)."""
    d = tmp_path_factory.mktemp("port_cache")
    with pytest.MonkeyPatch.context() as mp:
        for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                          ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                          ("REPRO_TORCH_MISS_LOG", "misses.json")):
            mp.setenv(var, str(d / name))
        yield

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_CACHE",
              str(tmp_path_factory.mktemp("plans") / "plans.json"))
    ref_registry.clear_memory()
    registry.clear_memory()
    ref_cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE)
    ref_model = ref_build_model(ref_cfg)
    params, axes = ref_model.init(jax.random.PRNGKey(0))
    ref_eng = RefEngine(ref_model, params, axes, max_len=48, max_batch=4,
                        max_prompt=16, program_cache=False)
    eng = Engine(build_model(cfg), params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), axes, max_len=48,
        max_batch=4, max_prompt=16, device="cpu")
    yield ref_eng, eng, cfg
    mp.undo()
    ref_registry.clear_memory()


def test_same_packed_leaves_and_buckets(engines):
    ref_eng, eng, _ = engines
    assert eng.buckets == ref_eng.buckets == (1, 2, 4)
    assert sorted(eng.pack_report) == sorted(ref_eng.pack_report)
    assert len(eng.pack_report) == 8


@pytest.mark.parametrize("b", [1, 3])
def test_generate_token_for_token(engines, b):
    ref_eng, eng, cfg = engines
    tokens = np.random.default_rng(b).integers(0, cfg.vocab_size, (b, 16))
    want = ref_eng.generate({"tokens": jnp.asarray(tokens, jnp.int32)}, 4)
    got = eng.generate({"tokens": torch.from_numpy(tokens).to(torch.int32)}, 4)
    assert got.buckets == want.buckets
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits_last.numpy(),
                               np.asarray(want.logits_last), rtol=2e-4,
                               atol=2e-4)


def test_serve_ragged_left_padded(engines):
    ref_eng, eng, cfg = engines
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 12)]
    want = ref_eng.serve([{"tokens": jnp.asarray(p, jnp.int32)}
                          for p in prompts], 3)
    got = eng.serve([{"tokens": torch.from_numpy(p).to(torch.int32)}
                     for p in prompts], 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(w.tokens))


def test_engine_without_device_needs_a_gpu(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, eng, _ = engines
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(eng.model, {}, {}, max_len=8, max_batch=1)


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1_5_4b", "--reduced", "--device", "cpu", "--trace", "1,3",
         "--steps", "2"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "group b=   3 -> buckets=(3,)" in out.stdout



def _capture_groups(eng, monkeypatch):
    """Replace ``eng.generate`` with a stub that records the group it is
    handed and answers with zeros."""
    seen = []

    def generate(batch, steps):
        seen.append(batch)
        b = batch["tokens"].shape[0]
        return types.SimpleNamespace(
            tokens=np.zeros((b, steps), np.int32),
            logits_last=np.zeros((b, 1, 8), np.float32), prefill_s=0.0,
            per_token_s=0.0, buckets=(b,), compile_s=0.0)

    monkeypatch.setattr(eng, "generate", generate)
    return seen


@pytest.mark.parametrize("lens", [(9, 9), (5, 9, 12)])
def test_serve_stacks_every_request_key(engines, monkeypatch, lens):
    """A request's per-row keys besides ``tokens`` reach ``generate``,
    stacked as the reference stacks them (uniform and ragged groups)."""
    ref_eng, eng, cfg = engines
    rng = np.random.default_rng(4)
    reqs = [{"tokens": rng.integers(0, cfg.vocab_size, n).astype(np.int32),
             "lang": np.int32(i), "ids": rng.integers(0, 9, 3)}
            for i, n in enumerate(lens)]
    want = _capture_groups(ref_eng, monkeypatch)
    got = _capture_groups(eng, monkeypatch)
    ref_eng.serve([{k: jnp.asarray(v) for k, v in r.items()} for r in reqs],
                  2)
    eng.serve([{k: torch.as_tensor(v) for k, v in r.items()} for r in reqs],
              2)
    assert sorted(got[0]) == sorted(want[0])
    assert {"lang", "ids"} <= set(got[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k].numpy(),
                                      np.asarray(want[0][k]))


def test_serve_refuses_ragged_without_ragged_support(engines, monkeypatch):
    ref_eng, eng, cfg = engines
    for e in (ref_eng, eng):
        monkeypatch.setattr(e, "model",
                            dataclasses.replace(e.model, prefill_row=None))
        assert not e.ragged_supported()
    ragged = [np.arange(n, dtype=np.int32) % cfg.vocab_size for n in (5, 9)]
    with pytest.raises(ValueError, match="ragged prompt lengths"):
        ref_eng.serve([{"tokens": jnp.asarray(t)} for t in ragged], 1)
    with pytest.raises(ValueError, match="ragged prompt lengths"):
        eng.serve([{"tokens": torch.from_numpy(t)} for t in ragged], 1)
    # uniform lengths still serve, at their own length (no bucket padding)
    seen = _capture_groups(eng, monkeypatch)
    eng.serve([{"tokens": torch.from_numpy(ragged[0])}] * 2, 1)
    assert tuple(seen[0]["tokens"].shape) == (2, 5) and "pad" not in seen[0]


def test_engine_reports_schedules_and_restarts_lookup_only(engines):
    _, eng, cfg = engines
    assert set(eng.schedule_report()) == set(eng.variant_report())
    assert set(eng.schedule_report().values()) == {"default"}
    # a second engine on the same shapes finds every plan in the registry
    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(1))
    registry.reset_stats()
    Engine(model, params, axes, max_len=48, max_batch=4, max_prompt=16,
           device="cpu")
    assert registry.stats()["misses"] == 0 and registry.stats()["hits"] > 0
