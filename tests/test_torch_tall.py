"""The port's tall-A kernels and the pack kernel on the CPU (plain
versions) against the reference's Pallas kernels in interpret mode.

One test family per TPU kernel (reference ``kernels/tsmm.py``
``tsmm_tall_a``, ``tsmm_packed_a``, ``pack_blocks_kernel``;
``kernels/gen.py`` ``_tall_kinner``, ``_tall_ksplit``, ``_tall_kouter``),
then the tall grammar through ``run_tall_a``, on the same seeded numpy
inputs.  Tolerances:

* float32: rtol 1e-5 and atol 1e-6 * K (fp32 sums taken in another
  order; the split-K reassociation grows with K);
* bfloat16: 1.6e-2 + 1.6e-2 * |ref| (one bf16 rounding of the output,
  two for ``epi=split`` points, in different places);
* pack: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gen as ref_gen
from repro.kernels import ops as ref_ops
from repro.kernels import tsmm as ref_tsmm
from repro.kernels import variants as ref_variants
from repro_torch.kernels import gen, ops, tsmm, variants

M, K, N, BM, BK = 256, 512, 128, 128, 128
ACTS = (None, "silu", "gelu")


def _inputs(m, k, n, dtype, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    c = rng.standard_normal((n,)).astype(np.float32) if bias else None
    j = [None if x is None else jnp.asarray(x).astype(dtype) for x in (a, b, c)]
    t = [None if x is None else torch.from_numpy(x).to(getattr(torch, dtype))
         for x in (a, b, c)]
    return j, t


def _check(got, want, dtype, k):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1.6e-2, atol=1.6e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * k)


@pytest.mark.parametrize("m_split", [1, 2])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tsmm_tall_a_matches_pallas_interpret(dtype, bias, act, m_split):
    (ja, jb, jc), (ta, tb, tc) = _inputs(M, K, N, dtype, bias=bias)
    want = ref_tsmm.tsmm_tall_a(ja, jb, jc, bm=BM, bk=BK, act=act,
                                m_split=m_split, interpret=True)
    got = tsmm.tsmm_tall_a(ta, tb, tc, bm=BM, bk=BK, act=act, m_split=m_split)
    assert got.dtype == ta.dtype
    _check(got, want, dtype, K)


@pytest.mark.parametrize("m_split", [1, 2])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tsmm_packed_a_matches_pallas_interpret(dtype, bias, act, m_split):
    (ja, jb, jc), (ta, tb, tc) = _inputs(M, K, N, dtype, seed=1, bias=bias)
    want = ref_tsmm.tsmm_packed_a(ref_ops.pack_blocks(ja, BM, BK), jb, jc,
                                  act=act, m_split=m_split, interpret=True)
    got = tsmm.tsmm_packed_a(ops.pack_blocks(ta, BM, BK), tb, tc, act=act,
                             m_split=m_split)
    _check(got, want, dtype, K)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_tall_wrappers_match_reference(dtype, act):
    """M = 300, N = 100: the wrappers pad M to the row block and N to 128
    columns and slice back, natural and packed, as the reference's do."""
    m, k, n = 300, 384, 100
    (ja, jb, jc), (ta, tb, tc) = _inputs(m, k, n, dtype, seed=2)
    want = ref_ops.tsmm(ja, jb, jc, bm=128, bk=128, act=act,
                        impl="pallas_interpret")
    got = ops.tsmm(ta, tb, tc, bm=128, bk=128, act=act)
    _check(got, want, dtype, k)
    want = ref_ops.tsmm_packed(ref_ops.pack_blocks(ja, 128, 128), jb, jc,
                               act=act, impl="pallas_interpret")
    got = ops.tsmm_packed(ops.pack_blocks(ta, 128, 128), tb, tc, act=act)
    _check(got, want, dtype, k)


@pytest.mark.parametrize("shape,bm,bk", [((256, 512), 128, 256),
                                         ((300, 520), 128, 256),
                                         ((3, 96, 384), 32, 128)])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_blocks_kernel_bit_equal(shape, bm, bk, alpha, dtype):
    a = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ja = jnp.asarray(a).astype(dtype)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    mats = [ja] if len(shape) == 2 else list(ja)
    # the reference pads ragged operands in ops.pack_blocks, then re-tiles
    # with its kernel (which needs block multiples)
    want = np.stack([np.asarray(ref_ops.pack_blocks(
        x, bm, bk, alpha=alpha, impl="pallas_interpret"), np.float32)
        for x in mats]).reshape(
        *shape[:-2], -(-shape[-2] // bm), -(-shape[-1] // bk), bm, bk)
    got = tsmm.pack_blocks_kernel(ta, bm, bk, alpha=alpha)
    assert got.dtype == ta.dtype
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("m_split", [1, 2])
@pytest.mark.parametrize("resident,revisit", [(False, False), (True, False),
                                              (False, True), (True, True)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tall_kinner_matches_pallas_interpret(dtype, packed, resident,
                                              revisit, m_split):
    """The reference at ``m_split`` 1 and 2; the port has no such axis on
    the card, and its result is the same either way."""
    act = "gelu" if revisit else "silu"
    (ja, jb, jc), (ta, tb, tc) = _inputs(M, K, N, dtype, seed=4)
    if packed:
        ja, ta = ref_ops.pack_blocks(ja, BM, BK), ops.pack_blocks(ta, BM, BK)
    want = ref_gen._tall_kinner(ja, jb, jc, bm=BM, bk=BK, act=act,
                                packed=packed, resident=resident,
                                revisit=revisit, dims=(), m_split=m_split,
                                interpret=True)
    got = gen._tall_kinner(ta, tb, tc, bm=BM, bk=BK, act=act, packed=packed,
                           resident=resident, revisit=revisit)
    assert got.dtype == (torch.float32 if revisit else ta.dtype)
    _check(got, want, dtype if not revisit else "float32", K)


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tall_ksplit_matches_pallas_interpret(dtype, packed, resident,
                                              splits):
    (ja, jb, _), (ta, tb, _) = _inputs(M, K, N, dtype, seed=5, bias=False)
    if packed:
        ja, ta = ref_ops.pack_blocks(ja, BM, BK), ops.pack_blocks(ta, BM, BK)
    want = ref_gen._tall_ksplit(ja, jb, bm=BM, bk=BK, splits=splits,
                                packed=packed, resident=resident, dims=(),
                                interpret=True)
    got = gen._tall_ksplit(ta, tb, bm=BM, bk=BK, splits=splits,
                           packed=packed, resident=resident)
    assert got.dtype == torch.float32
    _check(got, want, "float32", K)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tall_kouter_matches_pallas_interpret(dtype, packed):
    (ja, jb, _), (ta, tb, _) = _inputs(M, K, N, dtype, seed=6, bias=False)
    if packed:
        ja, ta = ref_ops.pack_blocks(ja, BM, BK), ops.pack_blocks(ta, BM, BK)
    want = ref_gen._tall_kouter(ja, jb, bm=BM, bk=BK, packed=packed, dims=(),
                                interpret=True)
    got = gen._tall_kouter(ta, tb, bm=BM, bk=BK, packed=packed)
    _check(got, want, "float32", K)


def _grammar_cases():
    seen, out = set(), []
    for prepack in (True, False):
        for spec in ref_variants.sampled_specs_for("tall_a", prepack):
            if spec.key() not in seen:
                seen.add(spec.key())
                out += [(spec, False), (spec, True)]
    return [(spec, packed, dt, ACTS[i % len(ACTS)])
            for i, (spec, packed) in enumerate(out)
            for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("spec,packed,dtype,act", _grammar_cases(),
                         ids=lambda v: getattr(v, "key", lambda: str(v))())
def test_tall_dispatch_matches_pallas_interpret(spec, packed, dtype, act):
    """Every sampled tall grammar point, natural and packed, through
    ``run_tall_a`` on both sides (ragged N = 100 columns)."""
    m, k, n = 256, 1024, 100
    (ja, jb, jc), (ta, tb, tc) = _inputs(m, k, n, dtype, seed=7)
    if packed:
        ja, ta = ref_ops.pack_blocks(ja, BM, BK), ops.pack_blocks(ta, BM, BK)
    want = ref_variants.run_tall_a(spec, ja, jb, jc, act, bm=BM, bk=BK,
                                   packed=packed, impl="pallas_interpret")
    got = variants.run_tall_a(spec, ta, tb, tc, act, bm=BM, bk=BK,
                              packed=packed)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype, k)


# fp32 at narrow N: the port pads B to ``tall_width`` (8, 24, 200 columns),
# where the reference pads every dtype to 128; both slice the result back
NARROW_N = (4, 24, 200)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", NARROW_N)
def test_fp32_tall_a_at_narrow_n_matches_pallas_interpret(n, packed):
    """``tsmm_tall_a`` / ``tsmm_packed_a`` through the padding wrappers,
    ragged M, bias and SiLU."""
    m, k = 300, 384
    (ja, jb, jc), (ta, tb, tc) = _inputs(m, k, n, "float32", seed=8)
    if packed:
        want = ref_ops.tsmm_packed(ref_ops.pack_blocks(ja, 128, 128), jb, jc,
                                   act="silu", impl="pallas_interpret")
        got = ops.tsmm_packed(ops.pack_blocks(ta, 128, 128), tb, tc,
                              act="silu")
    else:
        want = ref_ops.tsmm(ja, jb, jc, bm=128, bk=128, act="silu",
                            impl="pallas_interpret")
        got = ops.tsmm(ta, tb, tc, bm=128, bk=128, act="silu")
    assert ops.pad_tall(ta, tb, 128, 128)[1].shape[1] == tsmm.tall_width(
        n, torch.float32) < 128 + n
    _check(got, want, "float32", k)


NARROW_POINTS = {"b_resident": {}, "ksplit": {"splits": 4}, "kmajor": {}}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("point", ["b_resident", "revisit", "ksplit",
                                   "kmajor"])
@pytest.mark.parametrize("n", NARROW_N)
def test_fp32_tall_points_at_narrow_n_match_pallas_interpret(n, point,
                                                             packed):
    """The three tall grammar kernels (``_tall_kinner`` epilogue and
    revisit, ``_tall_ksplit``, ``_tall_kouter``) through ``run_tall_a``
    in fp32 at N = 4, 24, 200, bias and GELU."""
    m, k = 256, 512
    (ja, jb, jc), (ta, tb, tc) = _inputs(m, k, n, "float32", seed=9)
    if point == "revisit":
        rspec = ref_variants.parse_spec("gen:acc=revisit")
        spec = variants.parse_spec("gen:acc=revisit")
    else:
        rspec = ref_variants.KernelSpec.make(point, **NARROW_POINTS[point])
        spec = variants.KernelSpec.make(point, **NARROW_POINTS[point])
    if packed:
        ja, ta = ref_ops.pack_blocks(ja, BM, BK), ops.pack_blocks(ta, BM, BK)
    want = ref_variants.run_tall_a(rspec, ja, jb, jc, "gelu", bm=BM, bk=BK,
                                   packed=packed, impl="pallas_interpret")
    got = variants.run_tall_a(spec, ta, tb, tc, "gelu", bm=BM, bk=BK,
                              packed=packed)
    assert got.dtype == torch.float32
    _check(got, want, "float32", k)
