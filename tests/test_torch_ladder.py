"""The kernel ladder of ``core/tsmm.py::tsmm_dot`` against the
reference's (DESIGN.md §16).

Inputs from a numpy seed go through the port and through the reference
at (m, k, n) = (2048, 512, 16), fp32, in three layouts: B natural (the
planned tall-A path), A packed per call (an explicit ``prepack`` tall
plan) and W pre-packed (a ``PackedTensor``: the skinny-A path).  On the
CPU rung 1 and rung 2 are the same plain function, so rung 2 is
bit-equal to rung 1; rung 3 (``torch.matmul``) is held within
``TOL``, and every degraded output within ``TOL`` of the reference's
``tsmm_dot`` under the same failpoints.  The ladder catches only an
injected fault: a launch the host-side plan refuses, a kernel library
that did not build and an error after an enqueue raise through, never
demoted.  The card's
cases (rung 2 on CUDA tensors, no kernel launched when demoted) are in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as ref_registry
from repro.core.packing import pack as ref_pack
from repro.core.tsmm import tsmm_dot as ref_tsmm_dot
from repro.resilience import degrade as ref_degrade
from repro.resilience import failpoints as ref_fp
from repro_torch.core import packing, registry, tsmm
from repro_torch.core.plan import Plan, Problem
from repro_torch.core.tsmm import tsmm_dot
from repro_torch.kernels import cuda, variants
from repro_torch.kernels import tsmm as K
from repro_torch.resilience import degrade, failpoints

M, KD, N = 2048, 512, 16
# fp32 sums over K = 512 in another order (einsum blocks vs one matmul)
TOL = dict(rtol=1e-4, atol=1e-4)
RUNG2 = {"kernels.lower.skinny": "raise", "kernels.lower.tall": "raise"}
RUNG3 = {**RUNG2, "kernels.xla.skinny": "raise", "kernels.xla.tall": "raise"}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json"),
                      ("REPRO_PLAN_CACHE", "ref_plans.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    registry.clear_memory()
    ref_registry.clear_memory()
    failpoints.reset()
    ref_fp.reset()
    yield
    failpoints.reset()
    ref_fp.reset()
    registry.clear_memory()
    ref_registry.clear_memory()


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, KD)).astype(np.float32),
            rng.standard_normal((KD, N)).astype(np.float32))


def _port(layout, a, b, faults=None, stats=None):
    """The port's tsmm_dot of numpy operands in ``layout``, under
    ``faults``; returns numpy."""
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    kw = {}
    if layout == "packed_w":
        bt = packing.pack(bt, 128, 128)
    elif layout == "tall_packed_a":
        kw["plan"] = Plan(Problem(M, KD, N, "float32"), "tall_a", bm=256,
                          bk=256, bn=128, prepack=True)
    if faults:
        failpoints.configure(faults)
    try:
        with degrade.use(stats or degrade.DegradeStats()):
            return tsmm_dot(at, bt, **kw).numpy()
    finally:
        failpoints.reset()


def _ref(layout, a, b, faults=None):
    """The reference's tsmm_dot of the same operands and faults."""
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    if layout == "packed_w":
        bj = ref_pack(bj, 128, 128)
    if faults:
        ref_fp.configure(faults)
    try:
        with ref_degrade.use(ref_degrade.DegradeStats()):
            return np.asarray(ref_tsmm_dot(aj, bj))
    finally:
        ref_fp.reset()


LAYOUTS = ["natural", "tall_packed_a", "packed_w"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rung2_bit_equal_to_rung1_on_the_cpu(layout):
    a, b = _operands(1)
    healthy = _port(layout, a, b)
    stats = degrade.DegradeStats()
    degraded = _port(layout, a, b, RUNG2, stats)
    assert stats.counts == {"kernel.variant": 1}
    np.testing.assert_array_equal(degraded, healthy)
    np.testing.assert_allclose(healthy, a @ b, **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rung3_within_tolerance(layout):
    a, b = _operands(2)
    healthy = _port(layout, a, b)
    stats = degrade.DegradeStats()
    degraded = _port(layout, a, b, RUNG3, stats)
    assert stats.counts == {"kernel.variant": 1, "kernel.xla": 1}
    np.testing.assert_allclose(degraded, healthy, **TOL)


@pytest.mark.parametrize("faults", [None, RUNG2, RUNG3],
                         ids=["healthy", "rung2", "rung3"])
@pytest.mark.parametrize("layout", ["natural", "packed_w"])
def test_each_rung_matches_the_reference(layout, faults):
    a, b = _operands(3)
    np.testing.assert_allclose(_port(layout, a, b, faults),
                               _ref(layout, a, b, faults), **TOL)


def test_breaker_pins_fallback_after_k_failures():
    a, b = _operands(4)
    stats = degrade.DegradeStats(breaker_threshold=2)
    outs = [_port("natural", a, b, RUNG2, stats) for _ in range(4)]
    # the first 2 calls fail the planned rung; then the breaker is open
    # and the fallback is pinned without another attempt
    assert stats.counts == {"kernel.variant": 2, "kernel.pinned": 2}
    assert len(stats.breaker.report()["open"]) == 1
    for o in outs:
        np.testing.assert_array_equal(o, outs[0])


def test_a_clean_call_resets_a_pending_failure():
    """One failure below the threshold, then the failpoint disarmed: the
    next clean call of the key resets its count, as the reference's
    breaker does."""
    a, b = _operands(4)
    stats = degrade.DegradeStats(breaker_threshold=3)
    _port("natural", a, b, RUNG2, stats)
    assert sum(stats.breaker.report()["failures"].values()) == 1
    _port("natural", a, b, None, stats)
    assert stats.breaker.report() == {"threshold": 3, "open": [],
                                      "failures": {}}
    assert stats.counts == {"kernel.variant": 1}


def test_an_idle_ladder_runs_rung_1_without_its_key():
    """Nothing armed and no key failing: rung 1 runs, and the breaker key
    is never built (the eager hot path)."""
    built = []

    def key_of():
        built.append(1)
        return "k"

    assert tsmm._laddered("tall", key_of, lambda: "rung1", None,
                          None) == "rung1"
    assert built == []
    failpoints.configure({"registry.load": "raise"})   # another seam
    assert tsmm._laddered("tall", key_of, lambda: "rung1", None,
                          None) == "rung1"
    assert built == [1]


def test_breaker_and_counts_match_the_reference():
    a, b = _operands(5)
    ours = degrade.DegradeStats(breaker_threshold=2)
    theirs = ref_degrade.DegradeStats(breaker_threshold=2)
    failpoints.configure(RUNG2)
    ref_fp.configure(RUNG2)
    for _ in range(4):
        with degrade.use(ours):
            tsmm_dot(torch.from_numpy(a), torch.from_numpy(b))
        with ref_degrade.use(theirs):
            ref_tsmm_dot(jnp.asarray(a), jnp.asarray(b))
    assert ours.counts == theirs.counts
    assert ours.breaker.threshold == theirs.breaker.threshold


@pytest.mark.parametrize("layout", LAYOUTS)
def test_refused_launch_raises_through(monkeypatch, layout):
    """A host-side launch plan refusing the layout is the planner's fault
    to fix: it raises through tsmm_dot, uncounted, and the plain version
    does not serve it (a wrapper takes it only when asked, or on the
    CPU)."""
    calls = []

    def refuse(*args, impl=None, **kw):
        calls.append(impl)
        raise K.LaunchRefused("plan: refused")

    monkeypatch.setattr(variants, "run_tall_a", refuse)
    monkeypatch.setattr(variants, "run_skinny_a", refuse)
    a, b = _operands(6)
    stats = degrade.DegradeStats()
    with pytest.raises(K.LaunchRefused, match="refused"):
        _port(layout, a, b, None, stats)
    assert calls == [None]
    assert stats.total == 0
    assert stats.breaker.report()["failures"] == {}


@pytest.mark.parametrize("error", [cuda.KernelBuildError,
                                   cuda.KernelLaunchError])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_and_launch_errors_are_never_demoted(monkeypatch, error,
                                                   layout):
    """A library that did not build, or an error after an enqueue, is
    not one plan's failure: it raises through tsmm_dot, uncounted."""
    def broken(*args, impl=None, **kw):
        raise error("the card's error")

    monkeypatch.setattr(variants, "run_tall_a", broken)
    monkeypatch.setattr(variants, "run_skinny_a", broken)
    a, b = _operands(7)
    stats = degrade.DegradeStats()
    with pytest.raises(error, match="the card's error"):
        _port(layout, a, b, None, stats)
    assert stats.total == 0
    assert stats.breaker.report()["failures"] == {}


def test_a_failed_build_raises_from_load(monkeypatch, tmp_path):
    """``cuda.load`` raises the build error class without nvcc and on a
    library that does not load; ``cuda.check`` the launch error class."""
    build = tmp_path / "kernels-x"
    monkeypatch.setattr(cuda, "_build_dir", lambda: build)
    monkeypatch.setattr(cuda, "_libs", {})
    monkeypatch.setattr(cuda.shutil, "which", lambda _: None)
    real_exists = cuda.os.path.exists
    monkeypatch.setattr(cuda.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else real_exists(p))
    with pytest.raises(cuda.KernelBuildError, match="nvcc"):
        cuda.load()
    for name in cuda.SOURCES:               # built, but not a library
        (build / f"lib{name}.so").write_bytes(b"not an ELF file")
    with pytest.raises(cuda.KernelBuildError, match="did not load"):
        cuda.load()
    with pytest.raises(cuda.KernelLaunchError):
        cuda.check(700, "tsmm_tall_a")
    assert issubclass(K.LaunchRefused, ValueError)


def test_impl_threads_to_every_wrapper():
    """``impl="torch"`` (the ladder's rung 2) runs the plain versions on
    any device, through every wrapper the planned rung runs; None
    follows the device; nothing else is a choice."""
    a, b = _operands(8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ap = packing.pack(at, 256, 256, impl="torch")
    wp = packing.pack(bt, 128, 128, impl="torch")
    np.testing.assert_array_equal(ap.blocks.numpy(),
                                  packing.pack(at, 256, 256).blocks.numpy())
    for packed, lhs in ((False, at), (True, ap.blocks)):
        np.testing.assert_array_equal(
            variants.run_tall_a(variants.BASELINE, lhs, bt, bm=256, bk=256,
                                packed=packed, impl="torch")[:M].numpy(),
            variants.run_tall_a(variants.BASELINE, lhs, bt, bm=256, bk=256,
                                packed=packed)[:M].numpy())
    np.testing.assert_array_equal(
        variants.run_skinny_a(variants.BASELINE, at, wp.blocks, bk=128,
                              bn=128, impl="torch").numpy(),
        variants.run_skinny_a(variants.BASELINE, at, wp.blocks, bk=128,
                              bn=128).numpy())
    for impl in ("cuda", "auto", "xla"):
        with pytest.raises(ValueError, match="unknown impl"):
            K.pack_blocks_kernel(at, 128, 128, impl=impl)
    assert K.plain(wp.blocks, "torch", "x") and K.plain(at, None, "x")


def test_tsmm_dot_takes_no_implementation_choice(monkeypatch):
    """The ladder alone asks for the plain versions: ``tsmm_dot`` has no
    ``impl`` argument and reads no environment variable for one."""
    a, b = _operands(9)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(TypeError):
        tsmm_dot(at, bt, impl="torch")
    assert not hasattr(tsmm, "impl_choice")
    want = tsmm_dot(at, bt).numpy()
    monkeypatch.setenv("REPRO_TSMM_IMPL", "torch")
    stats = degrade.DegradeStats()
    with degrade.use(stats):
        np.testing.assert_array_equal(tsmm_dot(at, bt).numpy(), want)
    assert stats.total == 0
