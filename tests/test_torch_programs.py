"""The port's program store (``serve/programs.py``) on the CPU.

Mirrors ``tests/test_programs.py``: the key schema (structural, stable),
the acquisition ladder (here eager -> memory: the CPU has no graphs),
``precompile_grid``'s enumeration and the "traffic acquires nothing cold"
contract, and parity of the Engine through the store with the reference
Engine.  The float32 config is the reduced qwen1.5-4b enlarged so every
projection and the head pack, as in ``tests/test_torch_engine.py``:
tokens equal, logits within 2e-4 (fp32 sums in another order through
2 layers).  What only the card can run (capture, replay, the shared
pool) is in ``tests/test_torch_cuda.py``; the counting and buffer rules
a replay follows are tested here on their own.
"""

import dataclasses
import os
import subprocess
import sys
import threading
from collections import Counter
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
from repro_torch.core.packing import pack
from repro_torch.core.plan import ScheduleSpec
from repro_torch.kernels import cuda
from repro_torch.kernels.variants import KernelSpec
from repro_torch.models.param import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve import programs
from repro_torch.serve.engine import Engine
from repro_torch.serve.programs import (ProgramStore, batch_template,
                                        check_cells, precompile_grid)

WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
REPO = Path(__file__).resolve().parents[1]
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    """The port's plan, measurement and miss files in a temporary
    directory for the module (planning persists)."""
    d = tmp_path_factory.mktemp("port_cache")
    with pytest.MonkeyPatch.context() as mp:
        for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                          ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                          ("REPRO_TORCH_MISS_LOG", "misses.json"),
                          ("REPRO_PLAN_CACHE", "ref_plans.json")):
            mp.setenv(var, str(d / name))
        registry.clear_memory()
        ref_registry.clear_memory()
        yield
        registry.clear_memory()
        ref_registry.clear_memory()


@pytest.fixture(scope="module")
def small():
    cfg = get_reduced_config("qwen1_5_4b")
    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(0))
    return model, params, axes


@pytest.fixture(scope="module")
def wide():
    """The reference's params of the wide fp32 config, and both configs."""
    ref_cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE)
    ref_model = ref_build_model(ref_cfg)
    params, axes = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, params, axes, cfg


def _engine(wide, **kw):
    _, params, axes, cfg = wide
    return Engine(build_model(cfg), params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), axes, max_len=48,
        max_batch=4, max_prompt=16, device="cpu", **kw)


def _decode_args(store, params, b=2, max_len=32):
    return (params, store.static_cache(b, max_len), store.static_tokens(b))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def test_key_is_structural_and_stable(small):
    model, params, _ = small
    store = ProgramStore(model, device="cpu")
    args = _decode_args(store, params)
    k1 = store.key_for("decode", args, bucket=2, tokens=1)
    assert k1 == store.key_for("decode", args, bucket=2, tokens=1)
    assert k1.startswith("decode_b2_t1_")
    # values never take part: fresh buffers of the same structure, other
    # contents, key alike
    other = (params, model.init_cache(2, 32, "cpu"),
             torch.full((2, 1), 7, dtype=torch.int32))
    other[1]["pos"].fill_(5)
    assert store.key_for("decode", other, bucket=2, tokens=1) == k1
    # structure, kind and bucket move the key
    assert store.key_for("decode", _decode_args(store, params, b=1),
                         bucket=1, tokens=1) != k1
    assert store.key_for("prefill", args, bucket=2, tokens=1) != k1
    assert store.key_for("decode", args, bucket=4, tokens=1) != k1


def test_key_moves_with_length_pad_and_packed_stamp(small):
    model, params, _ = small
    store = ProgramStore(model, device="cpu")
    cache = store.static_cache(2, 32)

    def key(batch, p=params):
        return store.key_for("prefill", (p, batch, cache), bucket=2,
                             tokens=batch["tokens"].shape[1])

    base = key(batch_template(2, 8, pad=False))
    assert key(batch_template(2, 16, pad=False)) != base      # length
    assert key(batch_template(2, 8, pad=True)) != base        # pad
    w = torch.randn(512, 512, generator=torch.Generator().manual_seed(1))
    pk = pack(w, 128, 128)
    stamp = lambda spec: dataclasses.replace(                  # noqa: E731
        pk, kernel_specs=((1, spec, ScheduleSpec()),))
    b8 = batch_template(2, 8, pad=False)
    k_base = key(b8, {**params, "extra": stamp(KernelSpec())})
    assert key(b8, {**params, "extra": stamp(KernelSpec())}) == k_base
    assert key(b8, {**params, "extra": stamp(
        KernelSpec.make("ksplit", splits=2))}) != k_base       # stamp
    assert key(b8, {**params, "extra": dataclasses.replace(
        pack(w, 256, 128), kernel_specs=pk.kernel_specs)}) != key(
        b8, {**params, "extra": pk})                            # blocks


# ---------------------------------------------------------------------------
# acquisition: eager -> memory; no graphs on the CPU
# ---------------------------------------------------------------------------


def test_store_eager_memory_ladder_and_stats(small):
    model, params, _ = small
    store = ProgramStore(model, device="cpu")
    assert not store.capture
    args = _decode_args(store, params)
    p1 = store.program("decode", args, bucket=2, tokens=1)
    assert p1.cold and p1.source == "eager" and p1.kind == "decode"
    logits1, cache = p1.fn(*args)
    assert int(cache["pos"]) == 1
    p2 = store.program("decode", args, bucket=2, tokens=1)
    assert not p2.cold and p2.source == "memory" and p2.compile_s == 0.0
    assert p2.key == p1.key
    st = store.stats()
    assert (st["eager"], st["captured"], st["reused"], st["programs"]) \
        == (1, 0, 1, 1)
    assert st["pool_bytes"] == 0 and st["capture_s"] >= 0.0
    rows = store.report()
    assert [r["kind"] for r in rows] == ["decode"]
    assert rows[0]["source"] == "eager" and rows[0]["bucket"] == 2


def test_capture_on_the_cpu_raises(small):
    model, _, _ = small
    with pytest.raises(RuntimeError, match="CUDA graphs need a CUDA device"):
        ProgramStore(model, device="cpu", capture=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ProgramStore(model, device="cuda")


def test_static_buffers_are_handed_out_once(small):
    model, _, _ = small
    store = ProgramStore(model, device="cpu")
    assert store.static_cache(2, 32) is store.static_cache(2, 32)
    assert store.static_cache(2, 32) is not store.static_cache(1, 32)
    assert store.static_tokens(4) is store.static_tokens(4)
    b = store.static_batch(batch_template(2, 8, pad=True))
    assert b is store.static_batch(batch_template(2, 8, pad=True))
    assert b is not store.static_batch(batch_template(2, 8, pad=False))
    cache = store.static_cache(2, 32)
    assert cache["pos"].shape == () and cache["pos"].dtype == torch.int32


def test_replay_takes_only_its_buffers_and_counts_per_replay():
    """The rules a replayed graph follows, with a stand-in graph: other
    buffers raise, each replay adds the launches recorded at capture."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

    args = ({"w": 1}, {"pos": 0})
    rec = (Counter({"tsmm_skinny_a": 3}), Counter({"skinny_stream": 3}))
    run = programs._replay(Graph(), args, "out", rec)
    before = cuda.launches["tsmm_skinny_a"], \
        cuda.design_launches["skinny_stream"]
    assert run(*args) == "out" and run(*args) == "out"
    assert len(replays) == 2
    assert (cuda.launches["tsmm_skinny_a"],
            cuda.design_launches["skinny_stream"]) == \
        (before[0] + 6, before[1] + 6)
    with pytest.raises(ValueError, match="static buffers"):
        run({"w": 1}, {"pos": 0})
    assert len(replays) == 2


def test_recording_counts_into_the_recorder_of_its_thread_only():
    before = cuda.launches["flash_attention"]
    seen = {}

    def other():
        cuda.count("flash_attention", "flash_wgmma")
        seen["done"] = True

    with cuda.recording() as rec:
        cuda.count("flash_attention", "flash_wgmma")
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert seen.get("done") and not t.is_alive()
    assert rec[0] == Counter({"flash_attention": 1})
    assert rec[1] == Counter({"flash_wgmma": 1})
    assert cuda.launches["flash_attention"] == before + 1   # the thread's
    cuda.replayed(rec)
    assert cuda.launches["flash_attention"] == before + 2


def test_fused_epilogues_are_counted_by_kernel_and_replayed():
    before = cuda.epilogue_launches["skinny_kinner/bias_gelu"]
    with cuda.recording() as rec:
        cuda.count("skinny_kinner", "skinny_stream", "bias_gelu")
        cuda.count("skinny_kinner", "skinny_stream")
    assert rec[0] == Counter({"skinny_kinner": 2})
    assert rec[2] == Counter({"skinny_kinner/bias_gelu": 1})
    assert cuda.epilogue_launches["skinny_kinner/bias_gelu"] == before
    cuda.replayed(rec)
    cuda.replayed(rec)
    assert cuda.epilogue_launches["skinny_kinner/bias_gelu"] == before + 2
    cuda.reset_launches()
    assert not cuda.epilogue_launches and not cuda.launches


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets,lengths", [((1, 2), (8, 16)),
                                             ((1, 2, 4), (8,))])
def test_precompile_grid_enumerates_the_cells(small, buckets, lengths):
    model, params, _ = small
    store = ProgramStore(model, device="cpu")
    rows = precompile_grid(model, params, buckets=buckets, lengths=lengths,
                           max_len=32, store=store)
    assert len(rows) == len(buckets) * (1 + 3 * len(lengths))
    assert len({r["key"] for r in rows}) == len(rows)
    assert all(r["source"] == "eager" for r in rows)
    assert sorted((r["kind"], r["bucket"], r["tokens"], r["pad"])
                  for r in rows) == sorted(
        [("decode", b, 1, False) for b in buckets]
        + [("prefill", b, lb, pad) for b in buckets for lb in lengths
           for pad in (False, True)]
        + [("prefill_row", b, lb, False) for b in buckets for lb in lengths])
    assert all(c["equal"] for c in check_cells(store))


def test_precompiled_engine_acquires_no_cold_cell(wide):
    eng = _engine(wide)
    rows = eng.precompile()
    assert len(rows) == len(eng.buckets) * (1 + 3 * len(eng.grid.length))
    loaded = eng.programs.stats()
    rng = np.random.default_rng(0)
    vocab = wide[3].vocab_size
    res = eng.generate({"tokens": torch.from_numpy(
        rng.integers(0, vocab, (2, 8)))}, steps=3)
    assert res.compile_s == 0.0
    for r in eng.serve([{"tokens": torch.from_numpy(rng.integers(0, vocab, n))}
                        for n in (5, 11)], steps=2):
        assert r.compile_s == 0.0
    st = eng.programs.stats()
    assert (st["eager"], st["captured"]) == (loaded["eager"],
                                             loaded["captured"])
    assert st["programs"] == loaded["programs"]
    assert st["reused"] == loaded["reused"] + 4


def test_cold_cell_counts_its_acquire_in_compile_s(wide):
    eng = _engine(wide)
    res = eng.generate({"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                       steps=2)
    assert res.compile_s > 0.0
    again = eng.generate({"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                         steps=2)
    assert again.compile_s == 0.0
    assert eng.programs.stats()["eager"] == 2


def test_static_cache_reused_across_groups_matches_fresh_engines(wide):
    rng = np.random.default_rng(3)
    vocab = wide[3].vocab_size
    # a long group first leaves its cache rows behind; the next, shorter
    # group on the same bucket's cache must not see them
    first = {"tokens": torch.from_numpy(rng.integers(0, vocab, (2, 16)))}
    second = {"tokens": torch.from_numpy(rng.integers(0, vocab, (2, 8)))}
    eng = _engine(wide)
    eng.generate(first, steps=5)
    got = eng.generate(second, steps=4)
    want = _engine(wide).generate(second, steps=4)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
    np.testing.assert_array_equal(got.logits_last.numpy(),
                                  want.logits_last.numpy())


def test_second_generate_keeps_the_first_results_logits(wide):
    eng = _engine(wide)
    rng = np.random.default_rng(4)
    vocab = wide[3].vocab_size
    a = eng.generate({"tokens": torch.from_numpy(
        rng.integers(0, vocab, (2, 8)))}, steps=2)
    kept = a.logits_last.clone()
    eng.generate({"tokens": torch.from_numpy(
        rng.integers(0, vocab, (2, 8)))}, steps=2)
    assert torch.equal(a.logits_last, kept)


def test_prompt_past_max_len_raises(wide):
    eng = _engine(wide)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate({"tokens": torch.zeros((1, 40), dtype=torch.int32)},
                     steps=9)


@pytest.mark.parametrize("b", [1, 3])
def test_engine_through_the_store_matches_the_reference(wide, b):
    ref_model, params, axes, cfg = wide
    ref_registry.clear_memory()
    ref_eng = RefEngine(ref_model, params, axes, max_len=48, max_batch=4,
                        max_prompt=16, program_cache=False)
    eng = _engine(wide)
    eng.precompile()
    tokens = np.random.default_rng(10 + b).integers(0, cfg.vocab_size,
                                                    (b, 16))
    for _ in range(2):      # the second group replays held cells
        want = ref_eng.generate({"tokens": jnp.asarray(tokens, jnp.int32)}, 4)
        got = eng.generate({"tokens": torch.from_numpy(tokens)}, 4)
        assert got.buckets == want.buckets
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.logits_last.numpy(),
                                   np.asarray(want.logits_last), rtol=TOL,
                                   atol=TOL)
    assert eng.programs.stats()["eager"] == len(
        eng.buckets) * (1 + 3 * len(eng.grid.length))


def test_ragged_serve_through_the_store_matches_the_reference(wide):
    ref_model, params, axes, cfg = wide
    ref_registry.clear_memory()
    ref_eng = RefEngine(ref_model, params, axes, max_len=48, max_batch=4,
                        max_prompt=16, program_cache=False)
    eng = _engine(wide)
    eng.precompile()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 12)]
    want = ref_eng.serve([{"tokens": jnp.asarray(p, jnp.int32)}
                          for p in prompts], 3)
    got = eng.serve([{"tokens": torch.from_numpy(p)} for p in prompts], 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(w.tokens))
        np.testing.assert_allclose(g.logits_last.numpy(),
                                   np.asarray(w.logits_last), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_precompile_arch_checks_every_cell():
    from repro_torch.core.install import precompile_arch
    cfg = get_reduced_config("qwen1_5_4b")
    out = precompile_arch(cfg, (1, 2), (8, 16), max_len=32, device="cpu")
    assert len(out["rows"]) == 2 * (1 + 3 * 2) == len(out["checks"])
    assert all(c["equal"] for c in out["checks"])
    assert out["stats"]["eager"] == 14 and out["stats"]["captured"] == 0


def _launcher(tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans.json"),
               REPRO_TORCH_MEASURE_CACHE=str(tmp_path / "meas.json"),
               REPRO_TORCH_MISS_LOG=str(tmp_path / "misses.json"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1_5_4b", "--reduced", "--device", "cpu", "--trace", "1,3",
         "--steps", "2", "--prompt-len", "16", *extra], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)


def test_launcher_precompile_then_require_warm(tmp_path):
    out = _launcher(tmp_path, "--precompile", "--require-warm")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "precompiled 21 cells" in out.stdout
    assert "0 acquired cold by traffic" in out.stdout


def test_launcher_require_warm_fails_when_traffic_acquires(tmp_path):
    out = _launcher(tmp_path, "--require-warm")
    assert out.returncode != 0
    assert "--require-warm" in out.stderr


def test_cold_start_tool_on_the_cpu(tmp_path):
    from repro_torch.launch import cold_start
    path = tmp_path / "cold.json"
    rows = cold_start.main(["--reduced", "--device", "cpu", "--json",
                            str(path)])
    by = {r["row"]: r for r in rows}
    assert by["first_traffic_after_precompile_s"]["cold_cells"] == 0
    assert by["capture_at_first_traffic_s"]["eager"] > 0
    assert by["precompile_at_load_s"]["cells"] == 2 * (1 + 3 * 2)
    assert by["warm_restart_from_disk"]["value"] is None
    assert sum(r["row"] == "cell" for r in rows) == 14
    assert path.exists()
