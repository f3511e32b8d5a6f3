"""The H100 cost model's repair (pure; the CPU runs what the card would
plan): the fp32 rates of the port's kernels (FMA for the ``f32``
designs, a third of TF32 for ``tf32x3``), the
occupancy term built from the launch plans, the fit staying linear in
its three coefficients, and the pack-once placement of a packed tall A.

Under the reference's spec (``HwSpec(**asdict(TPU_V5E))``) none of it
applies: the reference's fp32 rate and scores stand (test_torch_gate.py
holds them to the reference).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.hw import TPU_V5E
from repro_torch.core import autotuner, evaluator, registry
from repro_torch.core.hw import H100, HwSpec
from repro_torch.core.plan import Plan, Problem
from repro_torch.core.registry import MeasureRecord
from repro_torch.core.smem_model import (TF32X3_ACHIEVED, call_pack_bytes,
                                         compute_time_s, features,
                                         launch_rate, memory_time_s,
                                         occupancy, overhead_steps,
                                         peak_rate, plan_launches, predict)
from repro_torch.kernels import tsmm as K

PORT_TPU = HwSpec(**dataclasses.asdict(TPU_V5E))
CALIBRATED = dataclasses.replace(H100, hbm_efficiency=0.8, mxu_efficiency=0.6,
                                 grid_overhead_s=2e-6, calibrated=True)
PROBLEMS = [Problem(2048, 4096, 256, "bfloat16"),
            Problem(16384, 1024, 128, "float32"),
            Problem(2048, 2048, 128, "float32"),
            Problem(4, 2560, 6912, "bfloat16"),
            Problem(16, 4096, 2048, "float32"),
            # fp32 skinny launches that leave SMs idle even at their
            # narrowest tiles
            Problem(128, 1024, 128, "float32")]


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
    """fp32 FMA at the data sheet's 67 TFLOP/s (the skinny and tall ``f32``
    designs); the tall ``tf32x3`` design bounded by a
    third of TF32's 495 and priced at the share of it the design reaches;
    each over its launch's padded width."""
    assert H100.peak_flops("float32") == 67e12
    assert H100.peak_flops("float32") != H100.peak_flops_bf16 / 4
    assert H100.peak_flops("bfloat16") == 989e12
    # a spec rebuilt from the reference's fields keeps its rate
    assert PORT_TPU.peak_flops("float32") == TPU_V5E.peak_flops_f32
    x3 = 495e12 / 3
    assert 0 < TF32X3_ACHIEVED <= 1
    for n, design, rate in ((16, "f32", 67e12), (4, "f32", 67e12),
                            (128, "tf32x3", x3 * TF32X3_ACHIEVED),
                            (240, "tf32x3", x3 * TF32X3_ACHIEVED)):
        plan = autotuner.candidate_blocks(Problem(16384, 1024, n, "float32"),
                                          H100)[0]
        (entry,) = [e for e in plan_launches(plan, H100)
                    if e[0] == "tsmm_tall"]
        assert entry[4].design == design
        assert launch_rate(entry[4], "float32", H100) == rate
        assert peak_rate(entry[4], "float32", H100) == (
            x3 if design == "tf32x3" else 67e12)
        m, k, width = entry[6]
        assert width == K.tall_width(n, torch.float32) < 128 + n
        assert compute_time_s(plan, H100) == pytest.approx(
            2 * m * k * width / rate)
    # the reference's fields price every fp32 launch at its fp32 rate
    assert launch_rate(entry[4], "float32", PORT_TPU) == TPU_V5E.peak_flops_f32


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
    # two and a half waves of the fp32 tall kernel (the f32 design at N =
    # 16: 128 x 16 tiles, one CTA an SM): the last half wave's idle SMs
    # are priced
    plan = Plan(Problem(128 * sms * 5 // 2, 1024, 16, "float32"), "tall_a",
                256, 1024, 128, prepack=False)
    (entry,) = plan_launches(plan, H100)
    assert (entry[4].design, entry[4].bm, entry[4].nt) == ("f32", 128, 16)
    assert occupancy(plan, H100) == pytest.approx(3 / 2.5)
    # one whole wave of the tf32x3 design (two 120-column tiles): 1
    plan = Plan(Problem(64 * sms, 1024, 240, "float32"), "tall_a", 64 * 12,
                1024, 128, prepack=False)
    (entry,) = plan_launches(plan, H100)
    assert (entry[4].design, entry[4].bm, entry[4].nt) == ("tf32x3", 128,
                                                           120)
    assert K.grid_ctas(entry[4], *entry[6][::2], entry[2]) == sms
    assert occupancy(plan, H100) == 1.0
    # the reference's gate prices no occupancy
    assert occupancy(plan, PORT_TPU) == 1.0


def test_under_filled_plans_score_worse_as_ctas_fall():
    """The fp32 skinny design at 256 rows (``tf32x3``, a product bound by
    its operations): even on 8-CTA clusters of 128-column tiles a narrower
    N launches fewer CTAs, which fill fewer of the card's SMs, and the
    model's seconds per unit of work rise with the occupancy."""
    occ, per_flop, ctas = [], [], []
    for n in (512, 256, 128):
        prob = Problem(256, 4096, n, "float32")
        plan = Plan(prob, "skinny_a", 256, 4096, n, prepack=True)
        (entry,) = plan_launches(plan, H100)
        assert (entry[4].design, entry[4].nt, entry[4].cluster) == (
            "tf32x3", 128, 8)
        ctas.append(K.grid_ctas(entry[4], 256, n, 1))
        assert compute_time_s(plan, H100) > memory_time_s(plan, H100)
        occ.append(occupancy(plan, H100))
        per_flop.append(predict(plan, H100).score / (2 * 256 * 4096 * n))
    assert all(a > b for a, b in zip(ctas, ctas[1:])) and ctas[0] <= H100.sm_count
    assert all(a < b for a, b in zip(occ, occ[1:]))
    assert all(a < b for a, b in zip(per_flop, per_flop[1:]))
    assert occ[-1] == H100.sm_count / ctas[-1]


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
