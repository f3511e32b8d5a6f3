"""The port's install-time stage against the reference, on the CPU.

Under the reference's spec (``HwSpec(**asdict(TPU_V5E))``) the measured
planner, the calibration fit, the serving problem set and the registry
must agree with the reference exactly.  Timings are the one input that
differs between a jax and a torch run, so both packages' ``time_samples``
are replaced by the same deterministic time per (problem, tuning key);
the candidates are still built and held to the serving path
(``parity_check``) in each package.  Every test reads and writes only a
temporary plan cache.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import autotuner as ref_autotuner
from repro.core import evaluator as ref_evaluator
from repro.core import install as ref_install
from repro.core import registry as ref_registry
from repro.core.hw import TPU_V5E
from repro.core.plan import BucketGrid as RefBucketGrid
from repro.core.plan import Plan as RefPlan
from repro.core.plan import Problem as RefProblem
from repro.core.registry import MeasureRecord as RefRecord
from repro.core.registry import Registry as RefRegistry
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import autotuner, evaluator, install, registry
from repro_torch.core.hw import HwSpec
from repro_torch.core.plan import BucketGrid, Plan, Problem, buckets_for, \
    length_buckets_for
from repro_torch.core.registry import MeasureRecord, Registry

PORT_TPU = HwSpec(**dataclasses.asdict(TPU_V5E))
# the reduced qwen1.5-4b enlarged so that every projection is TSMM-shaped
WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128)


def _js(plan) -> str:
    return json.dumps(plan.to_json(), sort_keys=True)


def _seconds(plan) -> float:
    """One deterministic time per (problem, tuning key), in [10, 1010) us."""
    h = hashlib.sha256(f"{plan.problem.key()}/{plan.tuning_key()}".encode())
    return 1e-5 + int(h.hexdigest()[:8], 16) / 2 ** 32 * 1e-3


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Both packages' registries on fresh temporary files, and both
    packages' timings replaced by :func:`_seconds`."""
    for var, name in (("REPRO_PLAN_CACHE", "ref_plans.json"),
                      ("REPRO_MEASURE_CACHE", "ref_meas.json"),
                      ("REPRO_MISS_LOG", "ref_misses.json"),
                      ("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    for mod, name in ((ref_evaluator, "_time_samples"),
                      (evaluator, "time_samples")):
        real = getattr(mod, "build_callable")

        def build(plan, *a, _real=real, **kw):
            fn = _real(plan, *a, **kw)
            fn.plan = plan
            return fn

        monkeypatch.setattr(mod, "build_callable", build)
        monkeypatch.setattr(
            mod, name, lambda fn, warmup=2, iters=5, **kw:
            [_seconds(fn.plan)] * iters)
    ref_registry.clear_memory()
    registry.clear_memory()
    prev = autotuner.set_default_hw(None)
    yield
    autotuner.set_default_hw(prev)
    ref_registry.clear_memory()
    registry.clear_memory()


PROBLEMS = [(4, 1024, 2048, "float32"), (2, 512, 1536, "bfloat16"),
            (1024, 512, 16, "float32"), (2048, 1024, 128, "bfloat16")]


def _records(reg_records) -> list:
    return sorted(r.key() for r in reg_records)


@pytest.mark.parametrize("m,k,n,dt", PROBLEMS)
def test_measured_make_plan_matches_reference(m, k, n, dt):
    got = autotuner.make_plan(Problem(m, k, n, dt), PORT_TPU,
                              measure="wallclock", persist=False,
                              device="cpu")
    want = ref_autotuner.make_plan(RefProblem(m, k, n, dt), TPU_V5E,
                                   measure="wallclock", persist=False)
    assert got.chosen_by == want.chosen_by == "measured"
    assert _js(got) == _js(want)
    assert got.tuning_key() == want.tuning_key()
    assert _records(registry.measurements("cpu")) == \
        _records(ref_registry.measurements())
    assert all(r.impl == "torch" for r in registry.measurements("cpu"))


@pytest.mark.parametrize("k,n,dt", [(1024, 2048, "float32"),
                                    (512, 1536, "bfloat16")])
def test_measured_make_plan_set_matches_reference(k, n, dt):
    buckets = (1, 2, 4)
    got = autotuner.make_plan_set(k, n, buckets, dt, PORT_TPU,
                                  measure="wallclock", device="cpu")
    want = ref_autotuner.make_plan_set(k, n, buckets, dt, hw=TPU_V5E,
                                       measure="wallclock")
    assert sorted(got.plans) == sorted(want.plans)
    for m in buckets:
        assert _js(got.plans[m]) == _js(want.plans[m])
    assert _records(registry.measurements("cpu")) == \
        _records(ref_registry.measurements())
    # one flush each: the plans are on disk, keyed alike
    got_disk = json.loads(registry.cache_path().read_text())
    want_disk = json.loads(ref_registry.cache_path().read_text())
    assert {k.split("/", 1)[1]: v for k, v in got_disk.items()} == \
        {k.split("/", 1)[1]: v for k, v in want_disk.items()}


@pytest.mark.parametrize("k,n,dt", [(512, 16, "float32"),
                                    (1024, 128, "bfloat16")])
def test_measured_make_plan_grid_matches_reference(k, n, dt):
    got = autotuner.make_plan_grid(k, n, BucketGrid((1, 2), (256, 512)), dt,
                                   PORT_TPU, measure="wallclock",
                                   device="cpu")
    want = ref_autotuner.make_plan_grid(k, n, RefBucketGrid((1, 2),
                                                            (256, 512)),
                                        dt, hw=TPU_V5E, measure="wallclock")
    assert json.dumps(got.to_json(), sort_keys=True) == \
        json.dumps(want.to_json(), sort_keys=True)
    assert _records(registry.measurements("cpu")) == \
        _records(ref_registry.measurements())


def _fit_records(seed: int, coefs, n: int = 24):
    """(port records, reference records) over the same candidate plans,
    with seconds from ``coefs`` (memory, compute, overhead) applied to the
    reference's features plus seeded noise."""
    from repro.core.vmem_model import features as ref_features
    rng = np.random.default_rng(seed)
    plans = []
    for m, k, nn, dt in PROBLEMS:
        plans += ref_autotuner.candidate_blocks(RefProblem(m, k, nn, dt),
                                                TPU_V5E)[:n // 4]
    ref_recs, port_recs = [], []
    for p in plans:
        t = float(np.dot(ref_features(p, TPU_V5E), coefs))
        t = abs(t) * (1 + 0.05 * rng.standard_normal()) + 1e-7
        ref_recs.append(RefRecord(plan=p, seconds=t, iters=5,
                                  dispersion=0.0))
        port_recs.append(MeasureRecord(plan=Plan.from_json(p.to_json()),
                                       seconds=t, iters=5, dispersion=0.0))
    return port_recs, ref_recs


@pytest.mark.parametrize("case,coefs", [
    ("all_terms", (1.6, 2.5, 3e-7)),
    ("dropped_memory", (-4.0, 3.0, 2e-7)),
    ("dropped_overhead", (1.2, 0.5, -5e-6)),
])
def test_fit_hw_matches_reference(case, coefs):
    port_recs, ref_recs = _fit_records(len(case), coefs)
    got = evaluator.fit_hw(port_recs, PORT_TPU)
    want = ref_evaluator.fit_hw(ref_recs, TPU_V5E)
    assert got.calibrated == want.calibrated
    for f in ("hbm_efficiency", "mxu_efficiency", "grid_overhead_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-9,
                                                abs=1e-18), f
    if case != "all_terms":
        assert evaluator.DROPPED_TERM_EFFICIENCY in (
            got.hbm_efficiency, got.mxu_efficiency) or \
            got.grid_overhead_s == 0.0


def test_fit_hw_refuses_thin_or_degenerate_records_as_reference():
    port_recs, ref_recs = _fit_records(0, (1.0, 1.0, 1e-7))
    assert evaluator.fit_hw(port_recs[:3], PORT_TPU) == PORT_TPU
    assert ref_evaluator.fit_hw(ref_recs[:3], TPU_V5E) == TPU_V5E
    same = [port_recs[0]] * 6
    assert evaluator.fit_hw(same, PORT_TPU) == PORT_TPU
    assert ref_evaluator.fit_hw([ref_recs[0]] * 6, TPU_V5E) == TPU_V5E


def test_spearman_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.integers(0, 6, 12).astype(float)     # ties included
        b = a + rng.standard_normal(12)
        assert evaluator.spearman(a, b) == pytest.approx(
            ref_evaluator.spearman(a, b), abs=1e-12)
    assert evaluator.spearman([1, 1, 1], [1, 2, 3]) == 0.0


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "glm4_9b"])
@pytest.mark.parametrize("max_batch,max_prompt", [(128, 512), (4, 256),
                                                  (2, 2048)])
def test_serving_problems_match_reference(arch, max_batch, max_prompt):
    buckets = buckets_for(max_batch)
    lengths = length_buckets_for(max_prompt)
    got = install.serving_problems(get_config(arch), buckets, lengths)
    want = ref_install.serving_problems(ref_get_config(arch), buckets,
                                        lengths)
    assert [p.key() for p in got] == [p.key() for p in want]
    assert install.serving_shapes(get_config(arch)) == \
        ref_install.serving_shapes(ref_get_config(arch))


def _registry_scenario(reg, put, get, plan_of, tmp) -> dict:
    """The same registry operations on either package's Registry; returns
    what they observed."""
    out = {}
    p = plan_of(Problem(4, 1024, 2048, "float32"), bk=256)
    measured = dataclasses.replace(p, bk=512, chosen_by="measured")
    q = plan_of(Problem(2, 512, 1536, "bfloat16"), bk=128)
    put(reg, measured)
    put(reg, q, persist=False)
    reg.flush()
    # atomic round trip: a fresh instance on the same files
    fresh = type(reg)(plan_path=reg.plan_path(),
                      measure_path=reg.measure_path())
    out["round_trip"] = sorted(_js(v) for v in fresh.snapshot_plans().values())
    # measured provenance survives disk: a model-ranked plan flushed by
    # another writer does not replace it
    other = type(reg)(plan_path=reg.plan_path(),
                      measure_path=reg.measure_path())
    put(other, p)
    out["provenance"] = _js(get(fresh, p.problem.key()))
    # the miss log drains once, counts repeated misses
    for key in ("m1_k1_n1_float32_s1", "m2_k1_n1_float32_s1",
                "m1_k1_n1_float32_s1"):
        get(reg, key)
    out["miss_records"] = [(r["key"], r["count"]) for r in reg.miss_records()]
    out["drained"] = reg.drain_misses()
    out["drained_again"] = reg.drain_misses()
    get(reg, "m3_k1_n1_float32_s1")
    out["flushed"] = reg.flush_misses(tmp / "misses.json")
    out["flushed_again"] = reg.flush_misses(tmp / "misses.json")
    out["miss_file"] = sorted(
        (k.split("/", 1)[1], v["count"])
        for k, v in json.loads((tmp / "misses.json").read_text()).items())
    # snapshot and preload
    snap = reg.snapshot_plans()
    out["snapshot"] = sorted(k.split("/", 1)[1] for k in snap)
    seed = type(reg)(plan_path=tmp / "seed.json",
                     measure_path=tmp / "seed_meas.json")
    out["preloaded"] = seed.preload_plans(snap)
    out["preloaded_again"] = seed.preload_plans(snap)
    # two instances keep their own counters
    out["stats"] = (reg.stats(), fresh.stats(), seed.stats())
    return out


def test_registry_behaves_as_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()

    def ref_plan(problem, bk):
        return RefPlan(RefProblem(problem.m, problem.k, problem.n,
                                  problem.dtype), "skinny_a", problem.m, bk,
                       256)

    def port_plan(problem, bk):
        return Plan(problem, "skinny_a", problem.m, bk, 256)

    want = _registry_scenario(
        RefRegistry(tmp_path / "ref" / "plans.json",
                    tmp_path / "ref" / "meas.json"),
        lambda reg, plan, persist=True: reg.put(plan, persist=persist),
        lambda reg, key: reg.get(key), ref_plan, tmp_path / "ref")
    got = _registry_scenario(
        Registry(tmp_path / "port" / "plans.json",
                 tmp_path / "port" / "meas.json"),
        lambda reg, plan, persist=True: reg.put(plan, "cpu", persist=persist),
        lambda reg, key: reg.get(key, "cpu"), port_plan, tmp_path / "port")
    assert got == want
    assert got["drained_again"] == [] and got["flushed_again"] == 0
    # the port's files are its own: keyed by the torch device's platform
    assert all(k.startswith("cpu/") for k in json.loads(
        (tmp_path / "port" / "plans.json").read_text()))


def test_default_paths_are_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    monkeypatch.delenv("REPRO_TORCH_MEASURE_CACHE")
    monkeypatch.delenv("REPRO_TORCH_MISS_LOG")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert registry.cache_path() == tmp_path / ".cache" / "repro_torch" / \
        "plans.json"
    assert registry.measure_cache_path().parent == registry.cache_path().parent
    assert registry.miss_log_path().parent == registry.cache_path().parent
    assert registry.cache_path() != ref_registry.cache_path()


def test_measured_record_survives_disk():
    rec = evaluator.measure_plan(
        autotuner.candidate_blocks(Problem(4, 1024, 2048, "float32"),
                                   PORT_TPU)[0], "cpu")
    registry.flush()
    registry.clear_memory()
    back = registry.lookup_measurement(rec.plan, "cpu")
    assert back == rec and back.impl == "torch"


def _install_cfgs():
    return (ref_reduced_config("qwen1_5_4b").reduced(**WIDE),
            get_reduced_config("qwen1_5_4b").reduced(**WIDE))


def test_install_then_check_is_lookup_only():
    ref_cfg, cfg = _install_cfgs()
    buckets, lengths = (1, 2, 4), (8, 16)
    n = install.install_arch(cfg, buckets, lengths, measure=True, iters=1,
                             device="cpu")
    assert n == ref_install.install_arch(ref_cfg, buckets, lengths)
    registry.flush()
    res = install.main(["--check", "--archs", "qwen1_5_4b", "--reduced",
                        "--override", ",".join(f"{k}={v}" for k, v in
                                               WIDE.items()),
                        "--max-batch", "4", "--max-prompt", "16",
                        "--device", "cpu"])
    assert res["stats"]["misses"] == 0 and res["stats"]["hits"] >= n
    assert res["grammar"]["failed"] == 0 and res["grammar"]["rows"] > 0


def test_check_fails_on_a_cold_cache():
    with pytest.raises(SystemExit):
        install.main(["--check", "--archs", "qwen1_5_4b", "--reduced",
                      "--override", "d_model=512,d_ff=1024",
                      "--max-batch", "1", "--max-prompt", "0",
                      "--device", "cpu"])


def test_background_tuner_commits_measured_plans():
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine

    _, cfg = _install_cfgs()
    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, axes, max_len=32, max_batch=2,
                 max_prompt=16, background_tune=True, device="cpu",
                 tuner_opts=dict(iters=1, warmup=0, top_k=2))
    eng.tuner.join(timeout=600)
    assert not eng.tuner.busy()
    assert eng.tuner.committed
    for plan in eng.tuner.committed:
        stood = registry.peek(plan.problem.key(), "cpu")
        assert stood is not None and stood.chosen_by == "measured"
    # the tuner flushed its plans and records
    disk = json.loads(registry.cache_path().read_text())
    assert any(v["chosen_by"] == "measured" for v in disk.values())
    assert registry.measure_cache_path().exists()
    # the engine ranked its misses against the (calibration-attempted)
    # spec it installed as the planning default
    assert autotuner.default_hw("cpu") is eng.tuner.hw


def test_engine_without_tuner_flushes_its_misses():
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine

    _, cfg = _install_cfgs()
    model = build_model(cfg)
    params, axes = model.init(torch.Generator().manual_seed(0))
    Engine(model, params, axes, max_len=32, max_batch=2, max_prompt=16,
           device="cpu")
    misses = json.loads(registry.miss_log_path().read_text())
    assert misses and all(k.startswith("cpu/m") for k in misses)
    assert registry.miss_records() == []


def test_cli_measure_calibrate_check_flow(capsys, monkeypatch):
    from repro_torch.core.hw import H100
    from repro_torch.core.smem_model import features
    # times that follow the H100 model's features, so the fit is defined
    monkeypatch.setattr(evaluator, "time_samples", lambda fn, iters=5, **kw: [
        float(np.dot(features(fn.plan, H100), (2.0, 3.0, 1e-6)))] * iters)
    argv = ["--archs", "qwen1_5_4b", "--reduced", "--override",
            ",".join(f"{k}={v}" for k, v in WIDE.items()), "--max-batch",
            "2", "--max-prompt", "8", "--device", "cpu", "--iters", "1"]
    res = install.main(argv + ["--measure"])
    assert res["plans"] > 0
    assert len(registry.measurements("cpu")) >= res["plans"]
    cal = install.main(argv + ["--calibrate"])
    assert cal["hw"].calibrated
    assert install.main(argv + ["--check"])["stats"]["misses"] == 0
    assert "check ok" in capsys.readouterr().out


def test_inner_kernel_select_runs_its_assertions(tmp_path):
    from repro_torch.launch import inner_kernel_select as iks
    blob = iks.run("cpu", tmp_path / "iks.json",
                   problems=[Problem(256, 512, 16, "float32"),
                             Problem(4, 512, 1024, "bfloat16")], rounds=1)
    assert [s["problem"] for s in blob["summary"]] == \
        ["m256_k512_n16_float32_s1", "m4_k512_n1024_bfloat16_s1"]
    for s in blob["summary"]:
        assert s["pick_s"] <= s["hand_best_s"] and s["space_growth"] >= 4
    assert json.loads((tmp_path / "iks.json").read_text())["device"] == "cpu"
