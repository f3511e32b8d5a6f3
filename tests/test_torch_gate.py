"""The H100 gate of the cost model and the launch key (pure; the CPU runs
what the card would plan).

Under the H100 spec a plan is feasible when the CUDA wrappers' launch
plans take its layout and their shared memory fits; the launch key names
the launches a plan produces, so the measured tournament times each
launch once.  Under the reference's spec the reference's gate stands.
"""

import dataclasses
from collections import Counter

import pytest
import torch

from repro.core import autotuner as ref_autotuner
from repro.core import vmem_model as ref_vmem
from repro.core.hw import TPU_V5E
from repro.core.plan import Problem as RefProblem
from repro_torch.core import autotuner, evaluator, registry
from repro_torch.core.hw import H100, VMEM_USABLE_FRACTION, HwSpec
from repro_torch.core.plan import Plan, Problem, ScheduleSpec
from repro_torch.core.smem_model import (call_pack_bytes, features,
                                         launch_count, launch_key,
                                         overhead_steps, plan_launches,
                                         predict, vmem_bytes_needed)
from repro_torch.kernels import tsmm as K
from repro_torch.kernels.variants import KernelSpec

PORT_TPU = HwSpec(**dataclasses.asdict(TPU_V5E))
GLM_KV = [Problem(2048, 4096, 256, "bfloat16"),
          Problem(4096, 4096, 256, "bfloat16")]


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    registry.clear_memory()
    yield
    registry.clear_memory()


@pytest.mark.parametrize("prob", GLM_KV, ids=lambda p: p.key())
def test_glm_kv_tall_problems_have_h100_candidates(prob):
    cands = autotuner.candidate_blocks(prob, H100)
    assert cands and all(c.orientation == "tall_a" for c in cands)
    # the whole-block VMEM gate refused every one of them on the card
    assert all(vmem_bytes_needed(c, H100) > H100.vmem_bytes
               * VMEM_USABLE_FRACTION for c in cands)
    # one kernel launch per k block keeps the k-outer point off the top
    assert cands[0].gen_spec().loop == "kinner"
    kouter = [c for c in cands if c.gen_spec().loop == "kouter"]
    assert kouter and all(
        overhead_steps(c, H100) >= c.grid[1] * H100.launch_steps
        for c in kouter)


def test_kouter_launch_charge_is_h100_only():
    plan = Plan(GLM_KV[0], "tall_a", 256, 128, 256,
                kernel=KernelSpec.make("kmajor"))
    assert overhead_steps(plan, PORT_TPU) == plan.grid[1]
    assert overhead_steps(plan, H100) == plan.grid[1] * (1 + H100.launch_steps)


class _Spy:
    """Records what the CUDA wrappers would plan for each call, from the
    tensors they receive, then runs the plain version (CPU tensors)."""

    def __init__(self, monkeypatch):
        self.launches = Counter()
        real_tall, real_skinny = K.launch_tall, K.launch_skinny
        real_pack = K.pack_blocks_kernel

        def tall(name, a, b, bias, act, *, mode, splits=1, k0=0, k1=None,
                 out=None, impl=None):
            m, k = K._tall_dims(a)
            kk = (k if k1 is None else k1) - k0
            packed = a.dim() == 4
            tp = K.tall_plan(m, k, b.shape[1], dtype=a.dtype, packed=packed,
                             pbm=a.shape[2] if packed else 0,
                             pbk=a.shape[3] if packed else 0, mode=mode,
                             splits=splits, kps=kk // splits, sms=132)
            self.launches[("tsmm_tall", mode, splits, kk // splits, tp,
                           (m, k, b.shape[1]))] += 1
            return real_tall(name, a, b, bias, act, mode=mode, splits=splits,
                             k0=k0, k1=k1, out=out, impl=impl)

        def skinny(name, x, w, bias, act, *, natural, splits, mode, bk=0,
                   bn=0, impl=None):
            m, k = x.shape
            if not natural:
                _, nn, bk, bn = w.shape
                n = nn * bn
            else:
                n = w.shape[1]
            sp = K.skinny_plan(m, k, n, dtype=x.dtype, natural=natural,
                               bk=bk, bn=bn, mode=mode, splits=splits,
                               kps=k // splits, sms=132)
            self.launches[("tsmm_skinny", mode, splits, k // splits, sp,
                           (m, k, n))] += 1
            return real_skinny(name, x, w, bias, act, natural=natural,
                               splits=splits, mode=mode, bk=bk, bn=bn,
                               impl=impl)

        def pack(a, bm, bk, *, alpha=1.0, impl=None):
            pp = K.pack_plan(1, a.shape[-2], a.shape[-1], bm, bk, a.dtype,
                             16, 132)
            self.launches[("pack_blocks", pp,
                           (1, a.shape[-2], a.shape[-1], bm, bk))] += 1
            return real_pack(a, bm, bk, alpha=alpha, impl=impl)

        monkeypatch.setattr(K, "launch_tall", tall)
        monkeypatch.setattr(K, "launch_skinny", skinny)
        monkeypatch.setattr(K, "pack_blocks_kernel", pack)


def _modelled(plan) -> Counter:
    """plan_launches, in the spy's terms (kernel launches only)."""
    out = Counter()
    for entry in plan_launches(plan, H100):
        if entry[0] == "torch":
            continue
        kernel, mode, splits, kps, lp, _layout, dims, count, smem = entry
        assert smem <= H100.vmem_bytes
        if kernel == "pack_blocks":
            out[("pack_blocks", lp, dims)] += count
        else:
            out[(kernel, mode, splits, kps, lp, dims)] += count
    return out


@pytest.mark.parametrize("prob", [Problem(512, 1024, 128, "bfloat16"),
                                  Problem(256, 512, 200, "float32"),
                                  Problem(4, 1024, 768, "bfloat16"),
                                  Problem(16, 512, 1024, "float32")],
                         ids=lambda p: p.key())
def test_every_h100_candidate_is_planned_by_its_wrappers(prob):
    """Each feasible candidate, run through the serving path's wrappers on
    the CPU, asks them for exactly the launches the model predicted, and
    every one of those launch plans exists (no wrapper refuses it)."""
    from repro_torch.core import packing
    from repro_torch.core.tsmm import tsmm_dot
    cands = autotuner.candidate_blocks(prob, H100)
    assert cands
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, prob.dtype)
    a = torch.randn((prob.m, prob.k), generator=g).to(dt)
    b = torch.randn((prob.k, prob.n), generator=g).to(dt)
    for plan in cands[::3]:
        wb = b
        if plan.orientation == "skinny_a" and plan.prepack:
            wb = packing.pack(b, plan.bk, plan.bn)   # packed at load
        with pytest.MonkeyPatch.context() as mp:
            spy = _Spy(mp)
            tsmm_dot(a, wb, plan=plan)
        assert spy.launches == _modelled(plan), str(plan)


def test_launch_key_ignores_axes_the_card_does_not_see():
    prob = GLM_KV[0]
    base = Plan(prob, "tall_a", 512, 256, 256, prepack=False)
    same = [dataclasses.replace(base, schedule=ScheduleSpec(m_split=2)),
            dataclasses.replace(base, schedule=ScheduleSpec(
                dims=("parallel", "arbitrary"))),
            dataclasses.replace(base, schedule=ScheduleSpec(multibuffer=3)),
            dataclasses.replace(base, bm=2048),
            dataclasses.replace(base, bk=1024),
            dataclasses.replace(base, kernel=KernelSpec.make("b_resident"))]
    for p in same:
        assert launch_key(p, H100) == launch_key(base, H100), str(p)
    differ = [dataclasses.replace(base, prepack=True),
              dataclasses.replace(base, kernel=KernelSpec.make("ksplit",
                                                               splits=2)),
              dataclasses.replace(base, kernel=KernelSpec.make("kmajor")),
              dataclasses.replace(base, kernel=KernelSpec.make(
                  "gen", acc="revisit"))]
    keys = {launch_key(p, H100) for p in differ + [base]}
    assert len(keys) == len(differ) + 1
    # a packed A keeps its block in the key
    assert launch_key(dataclasses.replace(base, prepack=True), H100) != \
        launch_key(dataclasses.replace(base, prepack=True, bm=256), H100)


@pytest.mark.parametrize("prob", [GLM_KV[0], Problem(2, 4096, 256,
                                                     "bfloat16")],
                         ids=lambda p: p.key())
def test_tournament_times_each_launch_once(prob, monkeypatch):
    timed = []

    def fake_measure(plan, device="cpu", **kw):
        timed.append(plan)
        return evaluator.MeasureRecord(plan=plan, seconds=1e-3 + len(timed),
                                       iters=1, dispersion=0.0)

    monkeypatch.setattr(evaluator, "measure_plan", fake_measure)
    cands = autotuner.candidate_blocks(prob, H100)
    assert len({launch_key(c, H100) for c in cands[:8]}) < 8
    plan = autotuner.make_plan(prob, H100, measure="wallclock", top_k=8,
                               stable=8, persist=False, device="cpu")
    keys = [launch_key(p, H100) for p in timed]
    assert len(keys) == len(set(keys)) == min(8, len(
        {launch_key(c, H100) for c in cands}))
    # each launch stood for by its model-best plan
    firsts = {}
    for c in cands:
        firsts.setdefault(launch_key(c, H100), c)
    assert all(firsts[k].tuning_key() == p.tuning_key()
               for k, p in zip(keys, timed))
    assert plan.chosen_by == "measured"


def test_reference_spec_keeps_the_reference_gate_and_terms():
    for m, k, n, dt in ((2048, 4096, 256, "bfloat16"), (4, 2560, 6912,
                                                        "bfloat16"),
                        (1024, 512, 16, "float32")):
        got = autotuner.candidate_blocks(Problem(m, k, n, dt), PORT_TPU)
        want = ref_autotuner.candidate_blocks(RefProblem(m, k, n, dt),
                                              TPU_V5E)
        assert [p.tuning_key() for p in got] == \
            [p.tuning_key() for p in want]
        for p, q in zip(got[:40], want[:40]):
            assert features(p, PORT_TPU) == ref_vmem.features(q, TPU_V5E)
            assert predict(p, PORT_TPU).score == \
                ref_vmem.predict(q, TPU_V5E).score
        # no launch dedupe under the reference's gate
        assert autotuner.dedupe_short_list(got, PORT_TPU) == got


def _noisy_samples(seed, base):
    """A ``time_samples`` stand-in: each candidate's five samples are its
    base time (by launch key) times 1.00-1.04 in a shuffled order, plus a
    per-candidate offset of up to 0.5 %, so every leader's dispersion
    (IQR over min, ~2 %) covers the offsets between equal bases."""
    rng = __import__("numpy").random.default_rng(seed)

    def samples(fn, *, warmup=2, iters=5, device="cpu"):
        t = base(fn.plan) * (1 + rng.uniform(0, 0.005))
        steps = rng.permutation([0.0, 0.01, 0.02, 0.03, 0.04])
        return [t * (1 + s) for s in steps[:iters]]
    return samples


def _tournament(prob, seed, base, monkeypatch):
    registry.clear_memory()
    real_build = evaluator.build_callable

    def build(plan, device="cpu", **kw):
        fn = real_build(plan, device, **kw)
        fn.plan = plan
        return fn

    monkeypatch.setattr(evaluator, "build_callable", build)
    monkeypatch.setattr(evaluator, "time_samples", _noisy_samples(seed, base))
    timed = []
    real_measure = evaluator.measure_plan

    def measure(plan, device="cpu", **kw):
        timed.append(plan)
        return real_measure(plan, device, **kw)

    monkeypatch.setattr(evaluator, "measure_plan", measure)
    plan = autotuner.make_plan(prob, H100, measure="wallclock", top_k=6,
                               stable=6, persist=False, device="cpu")
    return plan, timed


@pytest.mark.parametrize("prob", [Problem(2, 4096, 256, "bfloat16"),
                                  Problem(512, 1024, 128, "bfloat16")],
                         ids=lambda p: p.key())
def test_tournament_pick_is_stable_under_noise(prob, monkeypatch):
    """Candidates that tie within their dispersion give one pick on every
    run, the one of fewest launches (then the model's first); a challenger
    faster by more than the dispersion still wins."""
    picks = set()
    for seed in range(4):
        plan, timed = _tournament(prob, seed, lambda p: 1e-3, monkeypatch)
        assert len(timed) >= 3
        picks.add(plan.tuning_key())
        fewest = min(launch_count(p, H100) for p in timed)
        first = next(p for p in timed if launch_count(p, H100) == fewest)
        assert plan.tuning_key() == first.tuning_key()
    assert len(picks) == 1
    # the most-launching timed plan, 10 % faster, wins on every run
    _, timed = _tournament(prob, 0, lambda p: 1e-3, monkeypatch)
    fast = max(timed, key=lambda p: launch_count(p, H100))
    for seed in range(4):
        plan, _ = _tournament(
            prob, seed, lambda p: 0.9e-3 if p.tuning_key() ==
            fast.tuning_key() else 1e-3, monkeypatch)
        assert plan.tuning_key() == fast.tuning_key()


def test_tall_pack_is_timed_and_charged_on_the_card_only(monkeypatch):
    """A packed tall plan's timed call packs A, as ``tsmm_dot`` does on
    every call, and the launch gate's model charges that pack; the
    reference's spec amortizes it."""
    prob = Problem(512, 1024, 128, "float32")
    plan = Plan(prob, "tall_a", 256, 256, 128, prepack=True)
    fn = evaluator.build_callable(plan, "cpu")
    packs = []
    real = K.pack_blocks_kernel
    monkeypatch.setattr(K, "pack_blocks_kernel",
                        lambda *a, **kw: packs.append(1) or real(*a, **kw))
    fn()
    fn()
    assert len(packs) == 2
    natural = dataclasses.replace(plan, prepack=False)
    assert call_pack_bytes(natural, H100) == 0
    assert call_pack_bytes(plan, PORT_TPU) == 0
    assert call_pack_bytes(plan, H100) == 2 * 512 * 1024 * 4
    assert features(plan, H100)[0] > features(natural, H100)[0]
    assert features(plan, PORT_TPU)[0] == features(natural, PORT_TPU)[0]


def test_natural_tall_siblings_compete_on_the_card_only():
    """Under the launch gate each packed tall plan has a natural-A sibling,
    and with the per-call pack charged a natural plan ranks first at
    GLM-4-9B's K/V; the reference's spec enumerates packed A only."""
    for prob in GLM_KV:
        cands = autotuner.candidate_blocks(prob, H100)
        assert {c.prepack for c in cands} == {True, False}
        assert not cands[0].prepack
        ref = autotuner.candidate_blocks(prob, PORT_TPU)
        assert all(c.prepack for c in ref)


@pytest.mark.parametrize("entry", [
    "measure_plan", "measure_plans", "measure_plans_interleaved",
    "build_callable", "parity_check", "time_samples", "time_callable"])
def test_evaluator_defaults_to_the_card(entry, monkeypatch):
    """Every public timing entry point of the evaluator defaults to the
    card, like the rest of the port: called without a device where there
    is no GPU it raises before it makes operands or times anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    made, ran = [], []
    monkeypatch.setattr(evaluator, "_materialize",
                        lambda *a, **k: made.append(a))

    def fn():
        ran.append(1)

    plan = autotuner.candidate_blocks(Problem(4, 1024, 2048, "float32"),
                                      PORT_TPU)[0]
    calls = {
        "measure_plan": lambda: evaluator.measure_plan(plan),
        "measure_plans": lambda: evaluator.measure_plans([plan]),
        "measure_plans_interleaved":
            lambda: evaluator.measure_plans_interleaved([plan]),
        "build_callable": lambda: evaluator.build_callable(plan),
        "parity_check": lambda: evaluator.parity_check(plan, fn=fn),
        "time_samples": lambda: evaluator.time_samples(fn),
        "time_callable": lambda: evaluator.time_callable(fn),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not made and not ran
    assert registry.measurements("cpu") == []
