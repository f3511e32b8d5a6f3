"""The launch plan of the port's pack kernel on the CPU:
``kernels/tsmm.py::pack_plan`` and the chunk mapping ``pack_work`` that
``csrc/pack_blocks.cu`` follows, pure functions of shapes, dtype, the
source alignment and the SM count, so no card is needed.  Shapes:
GLM-4-9B's per-call decode pack of wk/wv ((4096, 256) into (256, 128)),
its prefill A pack ((2048, 4096) into (256, 128)) and its largest
layer-stacked leaf at load ((40, 4096, 13696) into (128, 128)), then
ragged, misaligned and layer-stacked shapes at small sizes.  The replay
of a plan's chunks in torch is held to ``kernels/ref.py::pack_ref`` bit
for bit (the bits compared as integers, so a -0.0 pad counts)."""

import math

import pytest
import torch

from repro_torch.kernels import tsmm
from repro_torch.kernels.ref import pack_ref

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
ESIZE = {BF16: 2, F32: 4}
BITS = {BF16: torch.int16, F32: torch.int32}


def _plan(L, m, k, bm, bk, dtype=BF16, align=16, sms=H100_SMS):
    return tsmm.pack_plan(L, m, k, bm, bk, dtype, align, sms)


@pytest.fixture(params=["vec", "tma"])
def design(request, monkeypatch):
    """The design the small shapes below should take: ``vec`` as planned,
    or ``tma`` with the size threshold lifted, so the TMA design takes any
    layout it allows (the plan is cached, so the cache is cleared on both
    sides)."""
    tsmm.pack_plan.cache_clear()
    if request.param == "tma":
        monkeypatch.setattr(tsmm, "PACK_TMA_MIN_BYTES", 0)
    yield request.param
    tsmm.pack_plan.cache_clear()


def _tma_refused(k, bm, bk, dtype, align):
    es = ESIZE[dtype]
    return (not tsmm.pack_tma_box(k, bk, es, align)
            or not [r for r in tsmm.pack_tma_rows(bm)
                    if r * bk * es <= tsmm.PACK_TMA_CHUNK_BYTES])


def _replay(a, bm, bk, plan, alpha=1.0):
    """Move ``a`` (L, M, K) as ``plan``'s CTAs would, chunk by chunk, into a
    NaN-filled output; returns the output and how often each output row
    was written."""
    L, m, k = a.shape
    nm, nk = -(-m // bm), -(-k // bk)
    out = torch.full((L * nm * nk * bm, bk), float("nan"), dtype=a.dtype)
    writes = torch.zeros(L * nm * nk * bm, dtype=torch.int64)
    for _, blk, l, i, j, r0, r1 in tsmm.pack_work(plan, L, m, k, bm, bk):
        rows = torch.zeros((r1 - r0, bk), dtype=a.dtype)
        src = a[l, i * bm + r0:min(i * bm + r1, m), j * bk:min(j * bk + bk, k)]
        rows[:src.shape[0], :src.shape[1]] = src
        if alpha != 1.0:
            rows = (rows.float() * alpha).to(a.dtype)
        out[blk * bm + r0:blk * bm + r1] = rows
        writes[blk * bm + r0:blk * bm + r1] += 1
    return out.reshape(L, nm, nk, bm, bk), writes


def _bit_equal(got, want):
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(BITS[got.dtype]),
        want.contiguous().view(BITS[want.dtype]))


# ---- which design -------------------------------------------------------

def test_decode_pack_runs_vec_over_the_card():
    """GLM-4-9B's wk/wv, packed on every decode call: 2 MB, so the vec
    design, spread over at least every SM (the parent used 32 CTAs)."""
    p = _plan(1, 4096, 256, 256, 128)
    assert p.design == "vec" and p.stages == 0
    assert p.box * 2 == 16            # 16-byte accesses
    assert p.grid >= H100_SMS
    assert p.grid == 16 * 2 * -(-256 // p.rows)


@pytest.mark.parametrize("L,m,k,bm,bk", [(1, 2048, 4096, 256, 128),
                                         (40, 4096, 13696, 128, 128),
                                         (40, 13696, 4096, 128, 128),
                                         (1, 4096, 151552, 128, 128)])
def test_large_packs_run_tma(L, m, k, bm, bk):
    """The prefill A pack and the weights at load: the TMA design, a
    persistent grid of a few CTAs an SM."""
    p = _plan(L, m, k, bm, bk)
    assert p.design == "tma"
    assert p.box == bk and bm % p.rows == 0
    assert p.rows * bk * 2 <= tsmm.PACK_TMA_CHUNK_BYTES
    assert p.grid == tsmm.PACK_TMA_CTAS_PER_SM * H100_SMS
    assert p.stages == tsmm.PACK_TMA_STAGES


def test_threshold_is_the_output_bytes():
    """Just below the TMA threshold the vec design runs, at it TMA."""
    bk = 128
    rows_at = tsmm.PACK_TMA_MIN_BYTES // (bk * 2)
    assert _plan(1, rows_at, bk, 128, bk).design == "tma"
    assert _plan(1, rows_at - 128, bk, 128, bk).design == "vec"


@pytest.mark.parametrize("k,dtype", [(1001, BF16), (4100, BF16),
                                     (4098, F32), (4097, F32)])
def test_misaligned_rows_refuse_tma(k, dtype):
    """A row stride that is not a multiple of 16 bytes: no tensor map, so
    the vec design (its predicated element-wise path) at any size."""
    assert (k * ESIZE[dtype]) % 16
    assert _plan(1, 8192, k, 128, 128, dtype).design == "vec"
    assert tsmm.pack_tma_box(k, 128, ESIZE[dtype], 16) == 0


@pytest.mark.parametrize("align", [2, 4, 8])
def test_misaligned_base_refuses_tma(align):
    assert _plan(1, 8192, 4096, 128, 128, align=align).design == "vec"
    assert _plan(1, 8192, 4096, 128, 128, align=16).design == "tma"


@pytest.mark.parametrize("bk,box", [(128, 128), (256, 256), (512, 256),
                                    (1024, 256), (64, 64), (8, 8)])
def test_box_of_the_block_width(bk, box):
    """A box is at most 256 elements: wider blocks move as bk / 256 boxes."""
    assert tsmm.pack_tma_box(4096, bk, 2, 16) == box
    p = _plan(1, 8192, 4096, 128, bk)
    if p.design == "tma":
        assert p.box == box and bk % p.box == 0


@pytest.mark.parametrize("bk,dtype", [(384, BF16), (640, BF16), (4, BF16),
                                      (2, F32), (100, BF16)])
def test_box_limits_refuse_tma(bk, dtype):
    """bk past 256 and not a multiple of it, or a box row under 16 bytes
    or not a multiple of them: the vec design."""
    assert tsmm.pack_tma_box(4096, bk, ESIZE[dtype], 16) == 0
    assert _plan(1, 8192, 4096, 128, bk, dtype).design == "vec"


@pytest.mark.parametrize("bm", [100, 4, 12])
def test_block_heights_off_the_box_refuse_tma(bm):
    """No chunk height of 8-row multiples divides bm: the vec design."""
    assert not tsmm.pack_tma_rows(bm)
    assert _plan(1, 8192, 4096, bm, 128).design == "vec"


def test_wide_rows_that_overflow_a_chunk_refuse_tma():
    """Eight rows of a 4096-wide bf16 block are 64 KB, past the chunk."""
    assert 8 * 4096 * 2 > tsmm.PACK_TMA_CHUNK_BYTES
    assert _plan(1, 8192, 8192, 128, 4096).design == "vec"


@pytest.mark.parametrize("L,m,k,bm,bk,dtype", [
    (1, 2048, 4096, 256, 128, BF16), (40, 4096, 13696, 128, 128, BF16),
    (1, 4096, 4096, 128, 512, BF16), (1, 4096, 4096, 128, 128, F32),
    (3, 1000, 4000, 64, 256, F32)])
def test_tma_plans_fit_the_card(L, m, k, bm, bk, dtype):
    p = _plan(L, m, k, bm, bk, dtype)
    es = ESIZE[dtype]
    assert p.design == "tma"
    assert p.box <= tsmm.PACK_BOX_MAX and (p.box * es) % 16 == 0
    assert p.rows <= tsmm.PACK_BOX_MAX and (p.rows * p.box * es) % 128 == 0
    assert tsmm.pack_tma_smem(p.rows, bk, es, p.stages) * \
        tsmm.PACK_TMA_CTAS_PER_SM <= 228 * 1024
    chunks = L * -(-m // bm) * -(-k // bk) * (bm // p.rows)
    assert p.grid <= chunks and p.threads % 32 == 0


@pytest.mark.parametrize("bk,dtype,box", [(128, BF16, 8), (100, BF16, 4),
                                          (12, BF16, 4), (7, BF16, 1),
                                          (6, F32, 2), (130, F32, 2),
                                          (64, F32, 4), (3, F32, 1)])
def test_vec_access_is_the_widest_that_divides_a_row(bk, dtype, box):
    p = _plan(1, 64, 64, 32, bk, dtype)
    es = ESIZE[dtype]
    assert p.design == "vec" and p.box == box
    assert p.box * es == math.gcd(16, bk * es) and bk % p.box == 0


def test_vec_rows_shrink_until_the_card_fills():
    """Few blocks: the chunk falls to one row a thread; many: four."""
    few = _plan(1, 4096, 256, 256, 128)
    many = _plan(1, 8192, 4096, 100, 128)
    _, ty = tsmm.pack_vec_shape(128, 2, tsmm.PACK_VEC_THREADS)
    assert few.rows == ty
    assert many.rows == ty * tsmm.PACK_VEC_UNROLL


@pytest.mark.parametrize("args,exc", [((1, 0, 4, 2, 2, BF16), ValueError),
                                      ((1, 4, 4, 0, 2, BF16), ValueError),
                                      ((0, 4, 4, 2, 2, BF16), ValueError),
                                      ((1, 4, 4, 2, 2, torch.float16),
                                       TypeError),
                                      ((1, 2 ** 31, 1, 1, 1, F32),
                                       ValueError)])
def test_refusals(args, exc):
    with pytest.raises(exc):
        tsmm.pack_plan(*args, 16, H100_SMS)


# ---- the grid covers every chunk once, and the replay is pack_ref ----------

SHAPES = [  # (L, M, K, bm, bk, dtype, align)
    (1, 256, 512, 128, 128, BF16, 16),       # aligned
    (1, 300, 520, 128, 256, BF16, 16),       # ragged M and K
    (1, 96, 1001, 32, 128, BF16, 16),        # misaligned rows (bf16 K = 1001)
    (1, 40, 7, 8, 8, F32, 4),                # misaligned rows and base, fp32
    (3, 96, 384, 32, 128, BF16, 16),         # layer-stacked
    (2, 70, 600, 16, 512, BF16, 16),         # bk past one box, ragged
    (2, 33, 130, 24, 64, F32, 16),           # fp32, ragged, stacked
]


@pytest.mark.parametrize("sms", [1, 3, H100_SMS])
@pytest.mark.parametrize("shape", SHAPES)
def test_grid_covers_every_chunk_once(design, shape, sms):
    L, m, k, bm, bk, dtype, align = shape
    p = _plan(L, m, k, bm, bk, dtype, align, sms)
    if p.design != design:
        # only the TMA design refuses layouts
        assert design == "tma" and _tma_refused(k, bm, bk, dtype, align)
        return
    nm, nk = -(-m // bm), -(-k // bk)
    seen = {}
    ctas = set()
    for cta, blk, l, i, j, r0, r1 in tsmm.pack_work(p, L, m, k, bm, bk):
        assert 0 <= cta < p.grid
        assert blk == (l * nm + i) * nk + j and 0 <= r0 < r1 <= bm
        if p.design == "tma":
            assert r1 - r0 == p.rows
        for r in range(r0, r1):
            seen[(blk, r)] = seen.get((blk, r), 0) + 1
        ctas.add(cta)
    assert len(seen) == L * nm * nk * bm and set(seen.values()) == {1}
    assert ctas == set(range(p.grid))      # no CTA idles


@pytest.mark.parametrize("alpha", [1.0, 0.5, -0.5])
@pytest.mark.parametrize("sms", [3, H100_SMS])
@pytest.mark.parametrize("shape", SHAPES)
def test_replayed_plan_is_pack_ref_bit_for_bit(design, shape, sms, alpha):
    L, m, k, bm, bk, dtype, align = shape
    g = torch.Generator().manual_seed(m * k + L)
    a = torch.randn((L, m, k), generator=g).to(dtype)
    p = _plan(L, m, k, bm, bk, dtype, align, sms)
    assert p.design == design or _tma_refused(k, bm, bk, dtype, align)
    got, writes = _replay(a, bm, bk, p, alpha)
    assert bool((writes == 1).all())
    assert _bit_equal(got, pack_ref(a, bm, bk, alpha=alpha))


@pytest.mark.parametrize("shape", [(4096, 256, 256, 128),
                                   (2048, 4096, 256, 128)])
def test_replayed_glm_packs_are_pack_ref(shape):
    """The decode and prefill packs of GLM-4-9B at full size, by the plans
    the card runs (vec and TMA)."""
    m, k, bm, bk = shape
    a = torch.randn((1, m, k), generator=torch.Generator().manual_seed(0)
                    ).to(BF16)
    p = _plan(1, m, k, bm, bk)
    got, writes = _replay(a, bm, bk, p)
    assert bool((writes == 1).all())
    assert _bit_equal(got, pack_ref(a, bm, bk))


def test_wrapper_on_the_cpu_is_pack_ref():
    """A CPU tensor takes the plain version; the plan is never asked."""
    a = torch.randn((2, 50, 70)).to(BF16)
    before = tsmm.pack_plan.cache_info().misses
    assert _bit_equal(tsmm.pack_blocks_kernel(a, 16, 32, alpha=0.5)
                      .reshape(2, 4, 3, 16, 32),
                      pack_ref(a, 16, 32, alpha=0.5))
    assert tsmm.pack_plan.cache_info().misses == before
