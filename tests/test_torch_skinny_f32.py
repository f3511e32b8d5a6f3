"""The fp32 skinny-A designs on the CPU (pure: the card runs what these
plan): ``f32`` (the TMA-fed FMA stream, k split over a cluster) at few
rows and ``tf32x3`` (3xTF32 on wgmma) above the crossover.

* the launch plan's tiles, clusters and rings at the calibration gate's,
  the decode and the prefill shapes (``kernels/tsmm.py::skinny_plan``);
* every (bk, bn) the planner and the serving pack emit for fp32 is taken,
  and the layouts neither design takes raise;
* the cost model's rates for both designs (``core/smem_model.py``);
* the 3xTF32 split emulated in torch (round to nearest at 10 mantissa
  bits, each 32-deep stage's sums added to fp32 running sums): within
  ``F32_TOL`` of the fp64 product at K = 8192, where one unsplit TF32
  product is not;
* the port's fp32 skinny functions (their plain versions on the CPU)
  against the reference's Pallas kernels in interpret mode at the ragged
  rows and split layouts the designs take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import variants as ref_variants
from repro.kernels.variants.spec import KernelSpec as RefKernelSpec
from repro_torch.core import autotuner, registry
from repro_torch.core.hw import H100
from repro_torch.core.plan import Plan, Problem
from repro_torch.core.smem_model import (TF32X3_ACHIEVED, compute_time_s,
                                         launch_rate, occupancy, peak_rate,
                                         plan_launches)
from repro_torch.core.tsmm import prepack_blocks
from repro_torch.kernels import gen, ops, tsmm, variants
from repro_torch.kernels.variants import KernelSpec, specs_for

F32 = torch.float32
SMS = 132
SMEM_OPTIN = 232448
F32_TOL = dict(rtol=1e-4, atol=1e-4)

# (m, K, N): the calibration gate's fp32 context problems, decode rows of
# qwen1.5-4b's projections, and prefill rows of its gate / up projection
GATE = ((16, 4096, 2048), (32, 8192, 1024))
DECODE = ((1, 2560, 6912), (4, 2560, 2560), (1, 6912, 2560), (1, 2560, 151936),
          (2, 16384, 5120))
PREFILL = ((32, 8192, 1024), (256, 2560, 6912), (1024, 2560, 6912),
           (2048, 2560, 6912), (2048, 4096, 13696), (128, 5120, 1536))


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    registry.clear_memory()
    yield
    registry.clear_memory()


def _plan(m, k, n, *, natural=False, bk=128, bn=128, mode=tsmm.EPILOGUE,
          splits=1, sms=SMS):
    return tsmm.skinny_plan(m, k, n, dtype=F32, natural=natural, bk=bk,
                            bn=bn, mode=mode, splits=splits, kps=k // splits,
                            sms=sms)


def _ring_holds_tile(p) -> bool:
    """The drained ring holds what the design's epilogue puts there: the
    f32 cluster's reduction buffer (bm x nt fp32) or tf32x3's transposed
    tile (bm rows of nt + 4 floats), as ``csrc/tsmm_skinny.cu`` checks."""
    if p.design == "f32":
        stage = (p.bm + p.nt) * 128
        return p.stages * stage >= p.bm * p.nt * 4
    stage = (p.nt + 2 * p.bm) * 128
    return p.stages * stage >= p.bm * (p.nt + 4) * 4


@pytest.mark.parametrize("m,k,n", [s for s in GATE + DECODE
                                   if s[0] <= tsmm.SKINNY_F32_CROSSOVER])
def test_f32_tiles_and_clusters_at_the_gate_and_decode_shapes(m, k, n):
    """At few rows: the widest column tile whose 8-CTA clusters reach
    ``SKINNY_F32_FILL`` of the SMs; the smallest cluster that gives every
    SM a CTA, unless a doubling would leave a rank fewer than
    ``SKINNY_F32_MIN_RANK_STAGES`` 32-deep stages; rows a power of two
    holding m and one consumer thread row."""
    p = _plan(m, k, n)
    assert p.design == "f32"
    wider = [t for t in tsmm.SKINNY_F32_NT if t > p.nt and n % t == 0]
    assert all((n // t) * tsmm.SKINNY_MAX_CLUSTER
               < tsmm.SKINNY_F32_FILL * SMS for t in wider)
    assert p.bm == max(8, 512 // p.nt, 1 << (m - 1).bit_length())
    ktiles = k // tsmm.SKINNY_FBK
    ctas = tsmm.grid_ctas(p, m, n, 1)
    assert ctas == (n // p.nt) * p.cluster
    assert (ctas >= SMS or p.cluster == tsmm.SKINNY_MAX_CLUSTER
            or ktiles < 2 * p.cluster * tsmm.SKINNY_F32_MIN_RANK_STAGES)
    assert p.cluster == 1 or (ctas // 2 < SMS and ktiles >= p.cluster
                              * tsmm.SKINNY_F32_MIN_RANK_STAGES)
    assert p.stages == tsmm.SKINNY_F32_STAGES


def test_gate_shapes_spread_w_over_every_sm():
    """The gate's context problems, N / 64 one-tile CTAs on the SIMT
    kernel (32 and 16), now stream W from 8-CTA clusters: ``f32`` on 16
    tiles of 128 columns (128 CTAs) at 16 rows, ``tf32x3`` on 8 tiles of
    128 W columns by the 32 rows (64 CTAs) at 32."""
    assert _plan(16, 4096, 2048) == tsmm.SkinnyPlan("f32", 16, 128, 8, 4)
    assert _plan(32, 8192, 1024) == tsmm.SkinnyPlan("tf32x3", 32, 128, 8, 4)
    assert [tsmm.grid_ctas(_plan(m, k, n), m, n, 1) for m, k, n in GATE] \
        == [128, 64]


@pytest.mark.parametrize("m,k,n", PREFILL)
def test_tf32x3_tiles_at_the_prefill_shapes(m, k, n):
    """Above the crossover: the fewest equal row tiles (a multiple of 8,
    at most 128) covering m; 128 W columns where they divide N, else 64;
    the smallest cluster that gives ``SKINNY_X3_FILL`` of the SMs a CTA
    while each rank keeps ``SKINNY_X3_MIN_RANK_STAGES`` stages."""
    p = _plan(m, k, n)
    assert p.design == "tf32x3"
    assert p.bm % 8 == 0 and 8 <= p.bm <= tsmm.SKINNY_X3_ROWS
    tiles = -(-m // p.bm)
    assert tiles == -(-m // tsmm.SKINNY_X3_ROWS)
    assert tiles * p.bm >= m > tiles * (p.bm - 8)
    assert p.nt == (128 if n % 128 == 0 else 64)
    ctas = tsmm.grid_ctas(p, m, n, 1)
    ktiles = k // tsmm.SKINNY_FBK
    fill = tsmm.SKINNY_X3_FILL * SMS
    assert (ctas >= fill or p.cluster == tsmm.SKINNY_MAX_CLUSTER
            or ktiles < 2 * p.cluster * tsmm.SKINNY_X3_MIN_RANK_STAGES)
    assert p.cluster == 1 or ctas // 2 < fill


@pytest.mark.parametrize("m", [1, 4, 16, 32, 33, 64, 128, 256, 2048])
@pytest.mark.parametrize("k,n", [(4096, 2048), (8192, 1024), (2560, 6912),
                                 (16384, 5120), (2560, 151936)])
def test_each_ring_fits_and_holds_its_tile(m, k, n):
    p = _plan(m, k, n)
    assert tsmm.skinny_smem(p) <= SMEM_OPTIN
    assert _ring_holds_tile(p)
    assert tsmm.grid_ctas(p, m, n, 1) * p.nt >= n


@pytest.mark.parametrize("m,k,n", [(4, 2560, 6912), (16, 4096, 2048),
                                   (256, 2560, 2560), (2048, 1024, 512)])
def test_every_fp32_layout_the_planner_emits_is_taken(m, k, n):
    """Every (bk, bn) the autotuner enumerates (multiples of 128 up to
    2048 and the largest power of two under K) through every grammar
    point (k-splits among them), packed and natural, plans its launches
    on the fp32 design of its rows, in a ring that fits."""
    prob = Problem(m, k, n, "float32")
    bns = [b for b in (128, 256, 512, 1024, 2048) if b <= -(-n // 128) * 128]
    bks = sorted({128, 256, 512, 1024, 2048, autotuner._pow2_below(k)}
                 - {b for b in (256, 512, 1024, 2048) if b > k})
    seen = set()
    for prepack in (True, False):
        for spec in specs_for("skinny_a", prepack):
            g = variants.grammar.from_kernel_spec(spec)
            for bk in bks:
                for bn in bns:
                    for e in gen.launches(g, "skinny_a", m, k, n, dtype=F32,
                                          bm=m, bk=bk, bn=bn,
                                          prepack=prepack, sms=SMS):
                        if e[0] == "tsmm_skinny":
                            seen.add(e[4].design)
                            assert e[8] <= SMEM_OPTIN
    assert seen == {"f32" if m <= tsmm.SKINNY_F32_CROSSOVER else "tf32x3"}
    assert autotuner.candidate_blocks(prob, H100)


@pytest.mark.parametrize("k,n", [(2560, 6912), (6912, 2560), (2560, 151936),
                                 (16384, 5120), (5120, 576)])
def test_the_serving_pack_layouts_are_taken(k, n):
    """The blocks ``serve/engine.py`` packs an fp32 weight into for the
    parity phases' buckets (prefill rows and decode) plan on the fp32
    designs at every bucket."""
    blocks = prepack_blocks((1, 256), k, n, "float32", device="cpu",
                            pad=n % 128 != 0)
    assert blocks is not None
    bk, bn = blocks
    kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
    for m in (1, 256):
        p = _plan(m, kp, np_, bk=bk, bn=bn)
        assert p.design in ("f32", "tf32x3")


def test_layouts_neither_design_takes_raise():
    with pytest.raises(ValueError, match="32-deep"):
        _plan(4, 144, 256, natural=True, bk=48)
    with pytest.raises(ValueError, match="32-deep"):
        _plan(300, 192, 256, natural=True, bk=96, mode=tsmm.RAW_F32,
              splits=4)
    with pytest.raises(ValueError, match="cut by the fp32 tiles"):
        _plan(4, 4 * 48, 256, bk=48)
    with pytest.raises(ValueError, match="cut by the fp32 tiles"):
        _plan(300, 1024, 2 * 96, bk=128, bn=96)
    with pytest.raises(ValueError, match="multiple of 64"):
        _plan(2048, 1024, 96, natural=True, bn=32)
    with pytest.raises(ValueError, match="splits in mode"):
        _plan(4, 1024, 256, mode=tsmm.EPILOGUE, splits=2)


@pytest.mark.parametrize("m,design", [(1, "f32"), (16, "f32"),
                                      (256, "tf32x3"), (2048, "tf32x3")])
def test_cost_model_rates_of_the_fp32_skinny_designs(m, design):
    """``f32`` at fp32 FMA's 67 TFLOP/s; ``tf32x3`` bounded by a third of
    TF32's 495 and priced at the share the design reaches; the compute
    term over the launch's rows padded to 8; a launch of at least one
    wave fills the card (occupancy from whole waves of its CTAs)."""
    k, n = 4096, 2048
    plan = Plan(Problem(m, k, n, "float32"), "skinny_a", m, k, 128,
                prepack=True)
    (entry,) = [e for e in plan_launches(plan, H100)
                if e[0] == "tsmm_skinny"]
    lp = entry[4]
    assert lp.design == design
    x3 = 495e12 / 3
    assert peak_rate(lp, "float32", H100) == (x3 if design == "tf32x3"
                                              else 67e12)
    rate = x3 * TF32X3_ACHIEVED if design == "tf32x3" else 67e12
    assert launch_rate(lp, "float32", H100) == rate
    assert compute_time_s(plan, H100) == pytest.approx(
        2 * (-(-m // 8) * 8) * k * n / rate)
    ctas = tsmm.grid_ctas(lp, m, n, 1)
    assert occupancy(plan, H100) == pytest.approx(
        max(1.0, -(-ctas // SMS) * SMS / ctas))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32``: half an ulp of TF32 added to the magnitude's
    bits, the 13 low bits cleared."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32x3(x: torch.Tensor, w: torch.Tensor, stage: int = 32):
    """The design's arithmetic: both operands split into big and small,
    each stage's small.big + big.small + big.big summed in fp32 (the
    products of TF32 values are exact in fp32) and added to fp32 running
    sums."""
    xb = _tf32(x)
    xs = _tf32(x - xb)
    wb = _tf32(w)
    ws = _tf32(w - wb)
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=F32)
    for k0 in range(0, x.shape[1], stage):
        s = slice(k0, k0 + stage)
        out = out + (xs[:, s] @ wb[s] + xb[:, s] @ ws[s] + xb[:, s] @ wb[s])
    return out


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0e-30], dtype=F32)
    got = _tf32(x)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                         1.0], dtype=F32)
    assert torch.equal(got[:5], want)
    assert float(got[5]) == pytest.approx(3.0e-30, rel=2 ** -10)
    # the small part carries the next 11 bits: big + small is x to ~2^-21
    y = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big = _tf32(y)
    rel = ((big + _tf32(y - big) - y).abs() / y.abs()).max()
    assert float(rel) < 2 ** -20


def test_3xtf32_holds_fp32_tolerance_where_tf32_does_not():
    """At K = 8192 (the gate's second context problem) the design's
    arithmetic stays within F32_TOL of the fp64 product; one unsplit TF32
    product (big.big) does not."""
    rng = np.random.default_rng(0)
    m, k, n = 16, 8192, 256
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32))
    ref = x.double() @ w.double()
    bound = F32_TOL["atol"] + F32_TOL["rtol"] * ref.abs()
    err3 = (_tf32x3(x, w).double() - ref).abs()
    assert bool((err3 <= bound).all()), float(err3.max())
    err1 = (_tf32(x) @ _tf32(w)).double() - ref
    assert not bool((err1.abs() <= bound).all())
    assert float(err1.abs().max()) > 10 * float(err3.max())


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("m", [3, 17, 33, 70])
@pytest.mark.parametrize("layout", ["baseline", "ksplit2", "ksplit4",
                                    "packfuse"])
def test_fp32_skinny_matches_pallas_interpret(m, layout):
    """Ragged rows (the f32 tile's zero rows, tf32x3's padded row tiles)
    and the split layouts (k-split partials 2 and 4; the natural W of a
    pack-fusing point): the port's fp32 skinny functions against the
    reference's Pallas kernels in interpret mode, bias and SiLU fused;
    within 2e-4, scaled by K / 512 for k-splits (their partials
    reassociate), as tests/test_torch_kernels.py holds them."""
    rng = np.random.default_rng(m)
    k, n, bk, bn = 1024, 384, 128, 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    if layout == "baseline":
        want = ref_ops.tsmm_skinny(jx, ref_ops.pack_blocks(jw, bk, bn), jb,
                                   act="silu", impl="pallas_interpret")
        got = tsmm.tsmm_skinny_a(tx, ops.pack_blocks(tw, bk, bn), tb,
                                 act="silu")
        tol = 2e-4
    elif layout == "packfuse":
        want = ref_variants.run_skinny_a(
            RefKernelSpec.make("gen", packfuse=1), jx, jw, jb, "silu", bk=bk,
            bn=bn, packed=False, impl="pallas_interpret")
        got = variants.run_skinny_a(KernelSpec.make("gen", packfuse=1), tx,
                                    tw, tb, "silu", bk=bk, bn=bn,
                                    packed=False)
        tol = 2e-4
    else:
        s = int(layout[-1])
        want = ref_variants.run_skinny_a(
            RefKernelSpec.make("ksplit", splits=s), jx,
            ref_ops.pack_blocks(jw, bk, bn), jb, "silu", bk=bk, bn=bn,
            packed=True, impl="pallas_interpret")
        got = variants.run_skinny_a(KernelSpec.make("ksplit", splits=s), tx,
                                    ops.pack_blocks(tw, bk, bn), tb, "silu",
                                    bk=bk, bn=bn, packed=True)
        tol = 2e-4 * k / 512
    want = np.asarray(want, np.float32)[:m, :n]
    got = _np(got)[:m, :n]
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the design the card would run at these rows
    p = _plan(m, k, n)
    assert p.design == ("f32" if m <= tsmm.SKINNY_F32_CROSSOVER else "tf32x3")
