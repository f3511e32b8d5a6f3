"""The port's serving engine and launcher against the reference engine.

Float32 config (the reduced qwen1.5-4b enlarged so every projection and
the head pack), where greedy decoding is pinned token for token: both
engines see the reference's params and must pack the same leaves and
emit the same tokens.
"""

import os
import subprocess
import sys
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


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_CACHE",
              str(tmp_path_factory.mktemp("plans") / "plans.json"))
    ref_registry.clear_memory()
    registry.default().clear()
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
