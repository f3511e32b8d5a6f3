"""The paper's own experiment on the port (CPU, plain versions) against
the reference: ``configs/tsmm_paper.py``, the pack, the planned row of
``launch/prepack_vs_conventional.py``, the epilogue tool and the formulas
of the paper tools.

Inputs come from one numpy seed and go to both packages.  Tolerances: the
pack and unpack are bit-equal; the planned row's fp32 output is held to
``jnp.dot`` within 1e-4 + 1e-4 |ref| (K = 512 terms); the fused epilogue
to the reference's post-hoc one within the same.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import epilogue_fusion as ref_epi
from benchmarks import packing_fraction as ref_pf
from benchmarks import prepack_vs_conventional as ref_pvc
from repro.configs import tsmm_paper as ref_cfg
from repro.kernels import ops as ref_ops
from repro_torch.configs import tsmm_paper
from repro_torch.core import registry
from repro_torch.core.hw import H100
from repro_torch.kernels import ops
from repro_torch.launch import epilogue_fusion, packing_fraction
from repro_torch.launch import prepack_vs_conventional as pvc

TINY = tsmm_paper.TSMMWorkload(M=512, K=512, n_sweep=(4, 48, 240),
                               repeats=3, dtypes=("float32",))
TOL = 1e-4


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    registry.clear_memory()
    yield
    registry.clear_memory()


def _np(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", ["PAPER_WORKLOAD", "BENCH_WORKLOAD"])
def test_workloads_equal_the_reference(name):
    ours, theirs = getattr(tsmm_paper, name), getattr(ref_cfg, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(tsmm_paper.TSMMWorkload()) == \
        dataclasses.asdict(ref_cfg.TSMMWorkload())


@pytest.mark.parametrize("n", TINY.n_sweep)
def test_pack_layout_and_unpack_match_the_reference(n):
    """A at the tiny workload, and its B, packed into the conventional
    path's 256 x 256 blocks: bit-equal to the reference's layout, and
    unpacked back bit for bit."""
    a, b = _np(n, (TINY.M, TINY.K), (TINY.K, n))
    for x in (a, b):
        got = ops.pack_blocks(torch.from_numpy(x), pvc.PACK_BLOCK,
                              pvc.PACK_BLOCK)
        want = np.asarray(ref_ops.pack_blocks(jnp.asarray(x), pvc.PACK_BLOCK,
                                              pvc.PACK_BLOCK))
        assert np.array_equal(got.numpy(), want)
        back = ops.unpack_blocks(got, *x.shape)
        assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("n", TINY.n_sweep)
def test_planned_row_matches_the_reference_product(n):
    """The planned row: the pack-once tournament's plan, A packed once,
    the plan's tall kernel replayed (its plain twin on the CPU), against
    ``jnp.dot`` on the same numpy inputs."""
    a, b = _np(100 + n, (TINY.M, TINY.K), (TINY.K, n))
    plan = pvc.plan_packed_once(TINY.M, TINY.K, n, "cpu", top_k=2, iters=1)
    assert plan.prepack and plan.chosen_by == "measured"
    seconds, out = pvc.replay(plan, torch.from_numpy(a), torch.from_numpy(b),
                              TINY.repeats, "cpu")
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b)))
    assert seconds > 0 and out.shape == (TINY.M, n)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    assert pvc.check_planned(out, torch.tensor(want), TINY.K) <= \
        pvc.f32_tol(TINY.K) * (1 + np.abs(want).max())


def test_sweep_rows_on_the_cpu():
    """The tool's rows: one per N, the three rows and the pack share, the
    planned row's plan packed and its launch counter a tall kernel's."""
    rows = list(pvc.sweep(TINY, "cpu", iters=1, top_k=2))
    assert [r["n"] for r in rows] == list(TINY.n_sweep)
    for r in rows:
        assert r["conventional"]["speedup"] == 1.0
        assert r["prepack"]["speedup"] > 1.0
        assert r["planned"]["plan"]["prepack"]
        assert r["planned"]["launch"] in ("tsmm_packed_a", "tall_kinner",
                                          "tall_ksplit", "tall_kouter")
        assert 0 < r["pack_share"] < 1
        assert r["planned"]["bound_ms"] > 0


def test_formulas_match_the_reference(monkeypatch):
    """``speedup``, the GFLOP/s and ``pack_share`` against the rows the
    reference's tools print from the same (stubbed) timings."""
    wl = ref_cfg.TSMMWorkload(M=256, K=256, n_sweep=(4, 48), repeats=20,
                              dtypes=("float32",))
    times = {"pvc": [3e-3, 1e-3, 2e-3], "pf": [3e-3, 1e-3, 2e-3]}
    for mod, key in ((ref_pvc, "pvc"), (ref_pf, "pf")):
        monkeypatch.setattr(mod, "timeit",
                            lambda fn, seq=iter(times[key]), **kw: next(seq))
        monkeypatch.setattr(mod, "emit", lambda rows: rows)
    rows = ref_pvc.run(wl)
    t_pack, comps = times["pvc"][0], times["pvc"][1:]
    for (name, us, derived), n, t_comp in zip(rows, wl.n_sweep, comps):
        assert name == f"prepack_vs_conv_n{n}"
        t_conv = t_pack + t_comp
        t_pre = pvc.amortized(t_comp, t_pack, wl.repeats)
        assert us == round(t_pre * 1e6, 1)
        assert derived == (
            f"speedup={pvc.speedup(t_conv, t_pre):.2f}x|"
            f"conv_gflops={pvc.gflops(wl.M, wl.K, n, t_conv):.2f}|"
            f"prepack_gflops={pvc.gflops(wl.M, wl.K, n, t_pre):.2f}")
    rows = ref_pf.run(wl)
    for (_, us, derived), t_comp in zip(rows, comps):
        assert us == round((t_pack + t_comp) * 1e6, 1)
        assert derived == f"pack_share={pvc.pack_share(t_pack, t_comp):.3f}"


def test_packing_fraction_tool_on_the_cpu():
    rows = packing_fraction.run(TINY, "cpu", iters=1, json_path=None)
    assert [r["n"] for r in rows] == list(TINY.n_sweep)
    assert all(0 < r["pack_share"] < 1 for r in rows)


@pytest.mark.parametrize("prob", epilogue_fusion.GATE_PROBLEMS,
                         ids=lambda p: p.key())
def test_fused_epilogue_matches_reference_posthoc(prob):
    """The tool's fused call (the plan's tall kernel with bias and gelu in
    its epilogue; the plain twin on the CPU) against the reference's
    post-hoc epilogue over ``jnp.dot``, and the two post-hoc epilogues
    against each other, on the same numpy operands."""
    a, b, bias = epilogue_fusion._operands(prob, "cpu", seed=7)
    plan = epilogue_fusion.plan_for(prob, H100)
    fused, posthoc = epilogue_fusion.fused_and_posthoc(plan, a, b, bias)
    aj, bj, biasj = (jnp.asarray(t.numpy()) for t in (a, b, bias))
    want = np.asarray(ref_epi._posthoc_epilogue(jnp.dot(aj, bj), biasj,
                                                epilogue_fusion.ACT))
    np.testing.assert_allclose(fused().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(posthoc().numpy(), want, rtol=TOL, atol=TOL)
    out = np.asarray(jnp.dot(aj, bj))
    np.testing.assert_allclose(
        epilogue_fusion._posthoc_epilogue(torch.tensor(out), bias,
                                          "gelu").numpy(),
        np.asarray(ref_epi._posthoc_epilogue(jnp.asarray(out), biasj,
                                             "gelu")),
        rtol=TOL, atol=TOL)


def test_epilogue_tool_rows_on_the_cpu():
    rows = epilogue_fusion.run("cpu", rounds=2, json_path=None)
    fused = [r for r in rows if r["name"].startswith("epilogue_fusion_")]
    sched = [r for r in rows if r["name"].startswith("schedule_axis_")]
    assert len(fused) == len(epilogue_fusion.GATE_PROBLEMS)
    assert all(r["traffic_posthoc"] - r["traffic_fused"]
               == r["model_credit_bytes"] > 0 for r in fused)
    # on the card a non-default schedule launches its default twin's
    # kernels: nothing is timed
    assert sched and all(r["same_launches_as_default"] and not r["timed"]
                         for r in sched)
