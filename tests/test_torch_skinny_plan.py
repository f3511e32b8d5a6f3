"""The launch plan of the port's skinny-A kernel on the CPU:
``kernels/tsmm.py::skinny_plan``, a pure function of shapes, dtype and
the SM count, so no card is needed.  Shapes are the skinny projections of
qwen1.5-4b and GLM-4-9B at decode and prefill."""

import pytest
import torch

from repro_torch.kernels import tsmm

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
SMEM_OPTIN = 232448

# (K, N) of the packed projections: q/o, gate/up, down, head
QWEN = ((2560, 2560), (2560, 6912), (6912, 2560), (2560, 151936))
GLM = ((4096, 4096), (4096, 13696), (13696, 4096), (4096, 151552))


def _plan(m, k, n, *, dtype=BF16, natural=False, bk=128, bn=128,
          mode=tsmm.EPILOGUE, splits=1, sms=H100_SMS):
    return tsmm.skinny_plan(m, k, n, dtype=dtype, natural=natural, bk=bk,
                            bn=bn, mode=mode, splits=splits, kps=k // splits,
                            sms=sms)


def _ctas(p, m, n, splits=1):
    return -(-m // p.bm) * (n // p.nt) * splits * p.cluster


def _ring(p):
    """(ring bytes, fp32 tile bytes) of a bf16 CTA, as
    ``csrc/tsmm_skinny.cu`` lays it out: 1 KB of alignment slack, then per
    stage the X rows x 64 k and 64 k x 128 W columns (bf16) and two 8-byte
    mbarriers; the fp32 tile (rows x 136 floats, one slot per cluster
    rank) reuses the ring."""
    stage = p.bm * 64 * 2 + 64 * p.nt * 2
    return (1024 + p.stages * (stage + 16),
            p.cluster * p.bm * (p.nt + 8) * 4 <= p.stages * stage)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7, 8])
def test_decode_rows_stream_the_weight(m):
    p = _plan(m, 2560, 6912)
    assert (p.design, p.bm, p.nt) == ("stream", 8, 128)


@pytest.mark.parametrize("m", [9, 16, 100, 256, 1000, 1024, 2048, 4096])
def test_prefill_rows_run_wgmma(m):
    p = _plan(m, 4096, 4096)
    assert p.design == "wgmma" and p.bm in (64, 128) and p.cluster == 1


def test_threshold_is_eight_rows():
    assert tsmm.SKINNY_STREAM_M == 8
    assert _plan(tsmm.SKINNY_STREAM_M, 4096, 4096).design == "stream"
    assert _plan(tsmm.SKINNY_STREAM_M + 1, 4096, 4096).design == "wgmma"


@pytest.mark.parametrize("m", [1, 8, 9, 16, 32, 33, 64, 65, 256, 2048])
def test_fp32_design_by_rows_around_the_crossover(m):
    """fp32 runs ``f32`` (the FMA stream, its tile's rows a power of two
    holding m) at m <= ``SKINNY_F32_CROSSOVER`` and ``tf32x3`` (row tiles
    of at most 128, a multiple of 8, covering m) above it; no other
    design."""
    p = _plan(m, 2560, 2560, dtype=F32)
    if m <= tsmm.SKINNY_F32_CROSSOVER:
        assert p.design == "f32" and p.nt in tsmm.SKINNY_F32_NT
        assert p.bm >= m and p.bm & (p.bm - 1) == 0 and p.bm >= 512 // p.nt
    else:
        assert p.design == "tf32x3" and p.cluster in (1, 2, 4, 8)
        assert p.bm % 8 == 0 and p.bm <= tsmm.SKINNY_X3_ROWS
        assert p.nt in tsmm.SKINNY_X3_NT
        assert -(-m // p.bm) * p.bm >= m > (-(-m // p.bm) - 1) * p.bm


@pytest.mark.parametrize("k,n", QWEN + GLM + ((4096, 256),))
@pytest.mark.parametrize("m", [1, 4, 1024, 2048])
def test_tiles_cover_n_and_rings_fit(k, n, m):
    """Every column of every path shape is covered by whole 128-column
    tiles (the heads' 1187 and 1184 tiles included), the rows by whole
    row tiles, and each CTA's ring fits shared memory and holds its fp32
    tile."""
    p = _plan(m, k, n)
    assert n % p.nt == 0 and (n // p.nt) * p.nt == n
    assert -(-m // p.bm) * p.bm >= m
    ring, holds_tile = _ring(p)
    assert ring <= SMEM_OPTIN and holds_tile
    if p.design == "wgmma":
        # two 128-row CTAs or three 64-row CTAs share an SM
        assert {128: 2, 64: 3}[p.bm] * (ring + 1024) <= 233472


def test_heads_have_an_odd_or_wide_tile_count():
    assert _plan(4, 2560, 151936).nt * 1187 == 151936
    assert _plan(2048, 4096, 151552).nt * 1184 == 151552
    assert _ctas(_plan(4, 2560, 151936), 4, 151936) == 1187


@pytest.mark.parametrize("k,n,cluster", [(2560, 2560, 4), (4096, 4096, 4),
                                         (2560, 6912, 4), (4096, 13696, 2),
                                         (13696, 4096, 8), (2560, 151936, 1)])
def test_decode_clusters_at_the_path_shapes(k, n, cluster):
    """The clusters the rule gives qwen1.5-4b's and GLM-4-9B's decode
    projections on an H100 (the fastest or within a few percent of it in
    ``launch/skinny_sweep.py``'s measurements, PERF.md §6)."""
    assert _plan(1, k, n).cluster == cluster


def test_glm_w_down_decode_fills_the_card():
    """GLM-4-9B's w_down at m = 1: 32 column tiles, K = 13696 = 214 stages
    of 64 (107 blocks of 128, prime): a cluster that gives at least one
    CTA per SM, every rank at least one stage of its unequal range."""
    k, n = 13696, 4096
    p = _plan(1, k, n)
    assert p.design == "stream" and p.cluster in (1, 2, 4, 8)
    assert _ctas(p, 1, n) >= H100_SMS
    t = k // 64
    ranges = [(q * t // p.cluster, (q + 1) * t // p.cluster)
              for q in range(p.cluster)]
    assert ranges[0][0] == 0 and ranges[-1][1] == t
    assert all(hi - lo >= 1 for lo, hi in ranges)
    assert len({hi - lo for lo, hi in ranges}) > 1      # 214 / 8: unequal


@pytest.mark.parametrize("k,n,splits", [(k, n, s) for k, n in QWEN[:3] + GLM[:3]
                                         for s in (1, 2)]
                         + [(4096, 256, 8)])
def test_decode_plans_fill_the_card_or_stop_at_a_limit(k, n, splits):
    """At decode the cluster grows until every SM has a CTA, unless the
    cluster is at its limit (8) or a doubling would leave a CTA fewer
    than ``SKINNY_MIN_RANK_STAGES`` stages; a cluster never leaves a CTA
    without a stage."""
    p = _plan(4, k, n, mode=tsmm.RAW_F32 if splits > 1 else tsmm.EPILOGUE,
              splits=splits)
    ktiles = k // splits // 64
    assert (_ctas(p, 4, n, splits) >= H100_SMS or p.cluster == 8
            or ktiles < 2 * p.cluster * tsmm.SKINNY_MIN_RANK_STAGES)
    assert ktiles >= p.cluster
    assert p.cluster == 1 or ktiles >= p.cluster * tsmm.SKINNY_MIN_RANK_STAGES


def test_prefill_row_tile_fills_the_card():
    """128-row tiles where they give every SM two CTAs, else 64-row tiles
    (three CTAs an SM); a 3-deep ring for both."""
    assert _plan(2048, 4096, 4096).bm == 128        # 16 x 32 tiles
    assert _plan(2048, 13696, 4096).bm == 128       # 16 x 32
    assert _plan(1024, 2560, 6912).bm == 128        # 8 x 54 = 432
    assert _plan(1024, 2560, 2560).bm == 64         # 8 x 20 = 160 < 264
    assert _plan(1024, 6912, 2560).bm == 64
    assert _plan(256, 2560, 2560).bm == 64          # 2 x 20 = 40
    assert _plan(100, 1024, 512).bm == 64
    assert _plan(2048, 4096, 151552).stages == 3


@pytest.mark.parametrize("natural", [False, True])
def test_natural_and_packed_plan_alike(natural):
    assert (_plan(4, 4096, 13696, natural=natural, bk=128, bn=128)
            == _plan(4, 4096, 13696))


def test_refuses_a_k_range_off_the_stage():
    with pytest.raises(ValueError, match="64-deep"):
        _plan(4, 96, 256, natural=True, bk=96)
    with pytest.raises(ValueError, match="64-deep"):
        _plan(2048, 384, 256, natural=True, mode=tsmm.RAW_F32, splits=4,
              bk=96)


@pytest.mark.parametrize("bk,bn", [(32, 128), (96, 256), (128, 64), (128, 192)])
def test_refuses_blocks_the_tile_would_cut(bk, bn):
    with pytest.raises(ValueError, match="cut by the tile"):
        _plan(4, 3 * 64 * bk, 3 * bn * 128, bk=bk, bn=bn)


@pytest.mark.parametrize("m", [1, 2048])
def test_refuses_n_off_the_tile(m):
    with pytest.raises(ValueError, match="128-column tile"):
        _plan(m, 1024, 192, natural=True, bn=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        _plan(m, 1024, 96, dtype=F32, natural=True, bn=32)


def test_refuses_splits_outside_the_partial_mode_and_other_dtypes():
    with pytest.raises(ValueError, match="splits in mode"):
        _plan(4, 4096, 4096, mode=tsmm.EPILOGUE, splits=2)
    with pytest.raises(TypeError):
        _plan(4, 4096, 4096, dtype=torch.float16)


def test_launch_skinny_keeps_the_plain_version_on_the_cpu():
    """A CPU tensor never reaches the plan or the kernel: the wrapper
    returns the plain version, whatever the layout."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 256), generator=g).to(BF16)
    w = torch.randn((256, 192), generator=g).to(BF16)
    got = tsmm.launch_skinny("t", x, w, None, None, natural=True, splits=1,
                             mode=tsmm.EPILOGUE, bk=128, bn=64)
    want = (x.float() @ w.float()).to(BF16)
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1.6e-2)
