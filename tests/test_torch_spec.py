"""The port's spec layer, planner and plan registry against the reference.

The grammar, plans and cost model are pure Python in both packages, so
everything here must agree exactly: enumeration, tuning keys, plan JSON,
the model-ranked plan choices and the prepacked layouts.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotuner as ref_autotuner
from repro.core import registry as ref_registry
from repro.core import tsmm as ref_tsmm
from repro.core.hw import TPU_V5E
from repro.core.plan import Plan as RefPlan
from repro.core.plan import Problem as RefProblem
from repro.kernels import variants as ref_variants
from repro_torch.core import autotuner, registry
from repro_torch.core.hw import H100, HwSpec, for_device
from repro_torch.core.plan import Plan, Problem
from repro_torch.core.tsmm import prepack_for
from repro_torch.kernels import variants

DATA = Path(__file__).parent / "data"
PORT_TPU = HwSpec(**dataclasses.asdict(TPU_V5E))

PROBLEMS = [(1, 2048, 1024, "float32"), (4, 1024, 4096, "bfloat16"),
            (16, 512, 2048, "float32"), (8192, 1024, 16, "bfloat16"),
            (2048, 4096, 128, "float32")]


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    """The port's plan, measurement and miss files in a temporary
    directory (planning persists)."""
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))

def _js(plan) -> str:
    return json.dumps(plan.to_json(), sort_keys=True)


@pytest.fixture
def ref_registry_isolated(tmp_path, monkeypatch):
    """The reference's default registry, reading and writing only a
    fresh temporary cache for the duration of the test."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_MEASURE_CACHE", str(tmp_path / "meas.json"))
    ref_registry.clear_memory()
    yield
    ref_registry.clear_memory()


def test_grammar_version_and_enumeration_counts():
    assert variants.GRAMMAR_VERSION == ref_variants.GRAMMAR_VERSION == "gen-1"
    for orient, prepack, count in (("tall_a", True, 22), ("skinny_a", True, 20),
                                   ("skinny_a", False, 36)):
        got = [s.key() for s in variants.specs_for(orient, prepack)]
        want = [s.key() for s in ref_variants.specs_for(orient, prepack)]
        assert got == want and len(got) == count


@pytest.mark.parametrize("text", ["baseline", "ksplit:splits=4",
                                  "gen:bres=resident,acc=revisit",
                                  "fused_pack", "nope", "gen:loop=sideways"])
def test_parse_spec_matches_reference(text):
    try:
        want = ref_variants.parse_spec(text).key()
    except ValueError:
        with pytest.raises(ValueError):
            variants.parse_spec(text)
        return
    assert variants.parse_spec(text).key() == want


def test_hw_spec_keeps_reference_fields():
    ref_fields = {f.name for f in dataclasses.fields(TPU_V5E)}
    assert ref_fields <= {f.name for f in dataclasses.fields(H100)}
    assert for_device("cpu") == H100
    assert (H100.peak_flops_bf16, H100.hbm_bw, H100.vmem_bytes) == \
        (989e12, 3.35e12, 232_448)


@pytest.mark.parametrize("m,k,n,dt", PROBLEMS)
def test_candidates_and_tuning_keys_match_reference(m, k, n, dt):
    """Every candidate, its tuning key, model score and plan JSON."""
    got = autotuner.candidate_blocks(Problem(m, k, n, dt), PORT_TPU)
    want = ref_autotuner.candidate_blocks(RefProblem(m, k, n, dt), TPU_V5E)
    assert [p.tuning_key() for p in got] == [p.tuning_key() for p in want]
    assert [_js(p) for p in got] == [_js(p) for p in want]


@pytest.mark.parametrize("m,k,n,dt", PROBLEMS)
def test_make_plan_matches_reference(m, k, n, dt, ref_registry_isolated):
    registry.clear_memory()
    got = autotuner.make_plan(Problem(m, k, n, dt), PORT_TPU, device="cpu")
    want = ref_autotuner.make_plan(RefProblem(m, k, n, dt), TPU_V5E,
                                   persist=False)
    assert _js(got) == _js(want)
    # the second call is a registry hit keyed "cpu/<problem>"
    before = registry.stats()["hits"]
    assert autotuner.make_plan(Problem(m, k, n, dt), PORT_TPU,
                               device="cpu") is got
    assert registry.stats()["hits"] == before + 1
    assert registry.peek(Problem(m, k, n, dt).key(), "cpu") is got


@pytest.mark.parametrize("k,n,dtype", [(1024, 1536, "float32"),
                                       (512, 2048, "bfloat16"),
                                       (2560, 768, "float32")])
def test_prepack_for_matches_reference(k, n, dtype, ref_registry_isolated):
    registry.clear_memory()
    rng = np.random.default_rng(0)
    w = rng.standard_normal((k, n)).astype(np.float32)
    wj = jnp.asarray(w).astype(dtype)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    buckets = (1, 2, 4)
    want = ref_tsmm.prepack_for(buckets, wj, hw=TPU_V5E)
    got = prepack_for(buckets, wt, hw=PORT_TPU)
    assert tuple(got.blocks.shape) == tuple(want.blocks.shape)
    assert torch.equal(got.blocks.float(),
                       torch.from_numpy(np.asarray(want.blocks, np.float32)))
    assert [(e[0], e[1].key(), e[2].key()) for e in got.kernel_specs] == \
        [(e[0], e[1].key(), e[2].key()) for e in want.kernel_specs]


@pytest.mark.parametrize("fname", ["pre_grammar_plans.json",
                                   "pre_grammar_measurements.json",
                                   "old_format_registry.json"])
def test_reference_fixtures_load_unchanged(fname):
    raw = json.loads((DATA / fname).read_text())
    for key, rec in raw.items():
        pj = rec["plan"] if "plan" in rec else rec
        got, want = Plan.from_json(pj), RefPlan.from_json(pj)
        assert _js(got) == _js(want)
        assert got.tuning_key() == want.tuning_key()
        assert key.split("/")[1] == got.problem.key()
        if "plan" in rec:
            assert key.endswith(got.tuning_key())


def test_registry_keeps_measured_winner():
    reg = registry.Registry()
    p = Plan(Problem(4, 1024, 2048, "float32"), "skinny_a", 4, 256, 256)
    measured = dataclasses.replace(p, bk=512, chosen_by="measured")
    assert reg.put(measured, "cpu") is measured
    assert reg.put(p, "cpu") is measured                 # model loses
    assert reg.put(p, "cpu", force=True) is p
    assert reg.get(p.problem.key(), "cpu") is p
    assert reg.get("m1_k1_n1_float32_s1", "cpu") is None
    assert reg.stats() == {"hits": 1, "misses": 1}
    reg.reset_stats()
    assert reg.stats() == {"hits": 0, "misses": 0}
