"""The H100 cost model's repair (pure; the CPU runs what the card would
plan): the fp32 rate of the port's SIMT kernels, the occupancy term built
from the launch plans, the fit staying linear in its three coefficients,
and the pack-once placement of a packed tall A.

Under the reference's spec (``HwSpec(**asdict(TPU_V5E))``) none of it
applies: the reference's fp32 rate and scores stand (test_torch_gate.py
holds them to the reference).
"""

import dataclasses

import numpy as np
import pytest

from repro.core.hw import TPU_V5E
from repro_torch.core import autotuner, evaluator, registry
from repro_torch.core.hw import H100, HwSpec
from repro_torch.core.plan import Plan, Problem
from repro_torch.core.registry import MeasureRecord
from repro_torch.core.smem_model import (call_pack_bytes, compute_time_s,
                                         features, memory_time_s, occupancy,
                                         overhead_steps, plan_launches,
                                         predict)
from repro_torch.kernels import tsmm as K

PORT_TPU = HwSpec(**dataclasses.asdict(TPU_V5E))
CALIBRATED = dataclasses.replace(H100, hbm_efficiency=0.8, mxu_efficiency=0.6,
                                 grid_overhead_s=2e-6, calibrated=True)
PROBLEMS = [Problem(2048, 4096, 256, "bfloat16"),
            Problem(16384, 1024, 128, "float32"),
            Problem(2048, 2048, 128, "float32"),
            Problem(4, 2560, 6912, "bfloat16"),
            Problem(16, 4096, 2048, "float32")]


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    registry.clear_memory()
    yield
    registry.clear_memory()


def _score_without_occupancy(plan, hw):
    """The score the model gave before the occupancy term."""
    t_c, t_m = compute_time_s(plan, hw), memory_time_s(plan, hw)
    base = (t_c + t_m) if hw.calibrated else max(t_c, t_m)
    return base + overhead_steps(plan, hw) * hw.grid_overhead_s


def test_fp32_peak_is_the_simt_rate_not_a_tpu_ratio():
    assert H100.peak_flops("float32") == 67e12
    assert H100.peak_flops("float32") != H100.peak_flops_bf16 / 4
    assert H100.peak_flops("bfloat16") == 989e12
    # a spec rebuilt from the reference's fields keeps its rate
    assert PORT_TPU.peak_flops("float32") == TPU_V5E.peak_flops_f32
    plan = autotuner.candidate_blocks(Problem(16384, 1024, 128, "float32"),
                                      H100)[0]
    assert compute_time_s(plan, H100) == pytest.approx(
        2 * 16384 * 1024 * 128 / 67e12)


@pytest.mark.parametrize("prob", PROBLEMS, ids=lambda p: p.key())
@pytest.mark.parametrize("calibrated", [False, True])
def test_plans_that_fill_the_card_score_as_before(prob, calibrated):
    """A plan whose launches fill every SM in whole waves has occupancy 1
    and keeps its score exactly; every other plan's compute term grows, so
    it scores higher under the fitted additive form and no lower under
    the data sheet's max()."""
    hw = CALIBRATED if calibrated else H100
    for plan in autotuner.candidate_blocks(prob, H100):
        occ = occupancy(plan, hw)
        before = _score_without_occupancy(plan, hw)
        assert occ >= 1.0
        if occ == 1.0:
            assert predict(plan, hw).score == before
        elif calibrated:
            assert predict(plan, hw).score > before
        else:
            assert predict(plan, hw).score >= before


def test_whole_waves_score_one():
    """The term itself: CTAs in whole multiples of the card's slots score
    1; a partial last wave scores the slots it leaves idle."""
    sms = H100.sm_count
    # bf16 tall (wgmma, one CTA an SM): 132 row tiles of 64, one column
    plan = Plan(Problem(132 * 64, 1024, 128, "bfloat16"), "tall_a", 8448,
                1024, 128, prepack=False)
    (entry,) = plan_launches(plan, H100)
    assert K.grid_ctas(entry[4], *entry[6][::2], entry[2]) == sms
    assert occupancy(plan, H100) == 1.0
    for hw in (H100, CALIBRATED):
        assert predict(plan, hw).score == _score_without_occupancy(plan, hw)
    # two and a half waves of the fp32 SIMT tall kernel (64 x 128 tiles,
    # two CTAs an SM): the last half wave's idle slots are priced
    slots = sms * K.TALL_SIMT_CTAS[(64, 128)]
    plan = Plan(Problem(64 * slots * 5 // 2, 1024, 128, "float32"), "tall_a",
                256, 1024, 128, prepack=False)
    (entry,) = plan_launches(plan, H100)
    assert (entry[4].design, entry[4].bm, entry[4].nt) == ("simt", 64, 128)
    assert occupancy(plan, H100) == pytest.approx(3 / 2.5)
    # the reference's gate prices no occupancy
    assert occupancy(plan, PORT_TPU) == 1.0


def test_under_filled_plans_score_worse_as_ctas_fall():
    """The fp32 skinny SIMT kernel launches N / 64 CTAs of 64 rows (at 64
    rows, fp32, a product bound by its operations): as N falls, fewer
    CTAs fill fewer of the card's slots, and the model's seconds per unit
    of work rise with the occupancy."""
    occ, per_flop = [], []
    for n in (8192, 4096, 2048, 1024, 512):
        prob = Problem(64, 4096, n, "float32")
        plan = Plan(prob, "skinny_a", 64, 4096, n, prepack=True)
        (entry,) = plan_launches(plan, H100)
        assert entry[4].design == "simt"
        assert K.grid_ctas(entry[4], 64, n, 1) == n // 64
        assert compute_time_s(plan, H100) > memory_time_s(plan, H100)
        occ.append(occupancy(plan, H100))
        per_flop.append(predict(plan, H100).score / (2 * 64 * 4096 * n))
    assert all(a < b for a, b in zip(occ, occ[1:]))
    assert all(a < b for a, b in zip(per_flop, per_flop[1:]))
    slots = H100.sm_count * K.SKINNY_SIMT_CTAS[64]
    assert occ[-1] == slots / (512 // 64)


def test_fit_recovers_known_coefficients_through_occupancy():
    """``features`` stays linear in the three fitted coefficients: times
    made from known coefficients over plans of every occupancy fit back
    to those coefficients."""
    plans = []
    for prob in PROBLEMS:
        plans += autotuner.candidate_blocks(prob, H100)[:12]
    assert any(occupancy(p, H100) > 1.5 for p in plans)
    c_m, c_c, oh = 1.25, 1.6, 3e-6
    recs = [MeasureRecord(plan=p, seconds=float(np.dot(features(p, H100),
                                                       (c_m, c_c, oh))),
                          iters=5, dispersion=0.0, impl="torch",
                          source="test", wall_time=0.0) for p in plans]
    fit = evaluator.fit_hw(recs, H100)
    assert fit.calibrated
    assert fit.hbm_efficiency == pytest.approx(1 / c_m, rel=1e-6)
    assert fit.mxu_efficiency == pytest.approx(1 / c_c, rel=1e-6)
    assert fit.grid_overhead_s == pytest.approx(oh, rel=1e-6)
    # and the fitted model predicts those times
    for r in recs:
        assert predict(r.plan, fit).score == pytest.approx(r.seconds,
                                                           rel=1e-6)


def test_pack_once_places_the_tall_pack_outside_the_call(monkeypatch):
    """A caller that packs A once (``HwSpec.pack_once``): the model charges
    no per-call pack, only packed tall plans compete, and the evaluator's
    timed call runs on an A packed before it."""
    once = dataclasses.replace(H100, pack_once=True)
    prob = Problem(512, 1024, 128, "float32")
    plan = Plan(prob, "tall_a", 256, 256, 128, prepack=True)
    assert call_pack_bytes(plan, H100) > 0
    assert call_pack_bytes(plan, once) == 0
    assert features(plan, once)[0] < features(plan, H100)[0]
    assert {c.prepack for c in autotuner.candidate_blocks(prob, H100)} == \
        {True, False}
    assert all(c.prepack for c in autotuner.candidate_blocks(prob, once))
    packs = []
    real = K.pack_blocks_kernel
    monkeypatch.setattr(K, "pack_blocks_kernel",
                        lambda *a, **kw: packs.append(1) or real(*a, **kw))
    fn = evaluator.build_callable(plan, "cpu", pack_once=True)
    assert len(packs) == 1          # A packed once, before the call
    fn()
    fn()
    assert len(packs) == 1
    evaluator.parity_check(plan, "cpu", fn=fn)


def test_pack_once_tournament_keeps_its_own_registry():
    """The pack-once tournament's records stay in the registry it is
    given: the process registry, which answers serving lookups, gets
    none."""
    once = dataclasses.replace(H100, pack_once=True)
    prob = Problem(512, 1024, 128, "float32")
    cands = autotuner.dedupe_short_list(autotuner.candidate_blocks(prob, once),
                                        once)
    own = registry.Registry()
    best = autotuner.measure_short_list(cands, top_k=2, stable=1, iters=1,
                                        warmup=0, device="cpu", hw=once,
                                        reg=own)
    assert best.prepack and best.chosen_by == "measured"
    assert own.measurements("cpu")
    assert not registry.measurements("cpu")
