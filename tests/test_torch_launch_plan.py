"""The launch-configuration functions of the port's Hopper kernels, on the
CPU: ``kernels/tsmm.py::tall_plan`` / ``tall_width`` / ``tall_smem`` /
``check_tma``, the tall padding of ``kernels/ops.py`` and
``kernels/gen.py::launches``, and
``kernels/flash_attention.py::flash_design``.  Pure functions of shapes,
dtypes and the SM count, so no card is needed."""

import pytest
import torch

from repro_torch.kernels import gen, ops, tsmm
from repro_torch.kernels.flash_attention import flash_design
from repro_torch.kernels.variants.grammar import BASELINE_POINT

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132


def _ctas(p, m, n, splits=1):
    return -(-m // p.bm) * -(-n // p.nt) * splits * p.cluster


def _ring_bytes(p):
    """The wgmma CTA's dynamic shared memory, as ``csrc/tsmm_tall.cu``
    lays it out: 1 KB of alignment slack, then per stage a 64 x 64 A tile,
    a 64 x nt B tile (bf16) and two 8-byte mbarriers."""
    return 1024 + p.stages * (64 * 64 * 2 + 64 * p.nt * 2 + 16)


def _plan(m, k, n, *, dtype=BF16, packed=False, pbm=0, pbk=0,
          mode=tsmm.EPILOGUE, splits=1, kps=None, sms=H100_SMS):
    return tsmm.tall_plan(m, k, n, dtype=dtype, packed=packed, pbm=pbm,
                          pbk=pbk, mode=mode, splits=splits,
                          kps=k // splits if kps is None else kps, sms=sms)


@pytest.mark.parametrize("m", [2048, 4096])
@pytest.mark.parametrize("packed", [False, True])
def test_glm_kv_projection_fills_the_card(m, packed):
    """GLM-4-9B's wk/wv at a 1- and 2-prompt prefill: at least one CTA per
    SM, the k split dividing the k range in whole 64-deep tiles, and each
    CTA within 227 KB of shared memory."""
    k, n = 4096, 256
    p = _plan(m, k, n, packed=packed, pbm=256 if packed else 0,
              pbk=128 if packed else 0)
    assert p.design == "wgmma" and p.bm == 64 and n % p.nt == 0
    assert _ctas(p, m, n) >= H100_SMS
    assert p.cluster in (1, 2, 4, 8)
    assert k % (tsmm.TALL_BK * p.cluster) == 0
    assert p.stages >= 3
    assert _ring_bytes(p) <= 232448 and 2 * (_ring_bytes(p) + 1024) <= 233472
    # the reduction buffer (cluster x 64/cluster rows x (nt + 8) fp32)
    # lives in the drained ring
    assert 64 * (p.nt + 8) * 4 <= p.stages * (64 * 64 * 2 + 64 * p.nt * 2)


@pytest.mark.parametrize("n", [128, 256, 384, 512])
def test_column_tiles_cover_n_and_two_ctas_share_an_sm(n):
    p = _plan(300, 1024, n)
    assert n % p.nt == 0 and 2 * (_ring_bytes(p) + 1024) <= 233472
    # the card is filled, or the cluster can grow no further
    assert (_ctas(p, 300, n) >= H100_SMS or p.cluster == 8
            or (1024 // 64) % (2 * p.cluster))


@pytest.mark.parametrize("n,design,nt", [
    (4, "f32", 8), (8, "f32", 8), (12, "f32", 16), (24, "f32", 32),
    (28, "tf32x3", 32), (32, "tf32x3", 32), (40, "tf32x3", 40),
    (48, "tf32x3", 48), (64, "tf32x3", 64),
    (96, "tf32x3", 96), (128, "tf32x3", 128), (192, "tf32x3", 64),
    (200, "tf32x3", 72), (240, "tf32x3", 80), (256, "tf32x3", 88),
    (384, "tf32x3", 128)])
def test_fp32_column_tile_is_the_whole_skinny_width(n, design, nt):
    """fp32 picks its design by N (``f32`` below the measured crossover,
    ``tf32x3`` at or above it) and its column tiles at the paper's M =
    25600: the narrowest FMA tile that holds N, or the wgmma width of N
    rounded up to 8 in equal tiles of at most 128 columns, the fewest
    such tiles or one more by waves of the card x columns (two tiles at N
    = 192 leave the fourth wave nearly empty)."""
    assert tsmm.TALL_F32_CROSSOVER % 8 == 0
    p = _plan(25600, 25600, n, dtype=F32)
    assert (p.design, p.nt, p.cluster) == (design, nt, 1)
    assert (design == "f32") == (tsmm.tall_width(n, F32)
                                 < tsmm.TALL_F32_CROSSOVER)
    if design == "tf32x3":
        tiles = -(-n // nt)
        assert tiles - -(-n // tsmm.TALL_X3_NT) in (0, 1) and nt % 8 == 0
        assert nt == tsmm.tall_width(-(-n // tiles), F32)
    assert tsmm.tall_smem(p) <= tsmm.TALL_SMEM_MAX


@pytest.mark.parametrize("n,nt", [(48, 24), (128, 64), (240, 80)])
def test_fp32_wide_tiles_split_where_the_grid_underfills(n, nt):
    """At M = 300 (3 row tiles) every grid fits one wave, so the tf32x3
    tile takes one more split: half the columns a CTA in the same wave."""
    p = _plan(300, 1024, n, dtype=F32)
    assert (p.design, p.bm, p.nt) == ("tf32x3", 64, nt)


@pytest.mark.parametrize("n", [48, 64, 128])
def test_fp32_many_waves_keep_the_wide_tile(n):
    """A k-split of 8 at the paper's M gives 1600 CTAs a column tile, so
    waves barely quantise and a narrower tile would pay each CTA's fixed
    cost twice: one tile."""
    p = _plan(25600, 25600, n, dtype=F32, mode=tsmm.RAW_F32, splits=8,
              kps=3200)
    assert (p.design, p.bm, p.nt) == ("tf32x3", 128, n)


def test_kouter_single_block_range_gets_a_valid_plan():
    """``loop=kouter``: one 128-deep k block per launch into the fp32
    accumulator; the split may not assume a deeper range."""
    p = _plan(2048, 4096, 256, mode=tsmm.ACCUM_F32, kps=128)
    assert p.design == "wgmma"
    assert 128 % (64 * p.cluster) == 0 and p.cluster <= 2


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_ksplit_partials_keep_the_split_whole(splits):
    k = 1024
    p = _plan(2050, k, 256, mode=tsmm.RAW_F32, splits=splits)
    assert (k // splits) % (64 * p.cluster) == 0
    assert _ctas(p, 2050, 256, splits) >= H100_SMS


@pytest.mark.parametrize("pbm,pbk", [(32, 128), (256, 32), (96, 128),
                                     (64, 96)])
def test_packed_layouts_the_tile_does_not_cut_are_rejected(pbm, pbk):
    with pytest.raises(ValueError, match="wgmma tile"):
        _plan(1024, 1024, 256, packed=True, pbm=pbm, pbk=pbk)


def test_k_range_off_the_stage_depth_is_rejected():
    with pytest.raises(ValueError, match="64-deep"):
        _plan(1024, 1024, 256, kps=96)


@pytest.mark.parametrize("n", [4, 32, 128, 240])
def test_fp32_row_tile_fills_the_card(n):
    """Both fp32 designs take rows in tiles of 128 where that still gives
    every SM a CTA, else 64; the paper's A (25600 rows) fills the card at
    128."""
    assert _plan(2048, 4096, n, dtype=F32).bm == 64
    p = _plan(8192, 4096, n, dtype=F32)
    assert p.bm == (128 if 64 * -(-n // p.nt) >= H100_SMS else 64)
    p = _plan(25600, 25600, n, dtype=F32)
    assert p.bm == 128 and _ctas(p, 25600, n) >= H100_SMS
    assert _plan(25600, 25600, n, dtype=F32, mode=tsmm.RAW_F32, splits=8,
                 kps=3200).bm == 128


@pytest.mark.parametrize("n", [4, 24, 48, 200, 240])
@pytest.mark.parametrize("m", [300, 25600])
def test_fp32_rings_fit_shared_memory(m, n):
    """Every fp32 plan's ring fits the 227 KB a CTA may opt into: ``f32``
    at its fixed depth, ``tf32x3`` as deep as fits (at least double
    buffered, at most 4 stages)."""
    p = _plan(m, 4096, n, dtype=F32)
    assert tsmm.tall_smem(p) <= tsmm.TALL_SMEM_MAX
    if p.design == "f32":
        assert p.stages == tsmm.TALL_F32_STAGES
    else:
        assert 2 <= p.stages <= tsmm.TALL_X3_STAGES
        deeper = tsmm.TallPlan(p.design, p.bm, p.nt, 1, p.stages + 1)
        assert (p.stages == tsmm.TALL_X3_STAGES
                or tsmm.tall_smem(deeper) > tsmm.TALL_SMEM_MAX)


def test_fp32_tall_smem_is_the_kernels_layout():
    """1 KB of alignment slack, then per stage the fp32 A tile (bm x 32),
    B's tile (f32: 32 x nt; tf32x3: B^T big and small, nt x 32 each) and
    two 8-byte mbarriers."""
    f = tsmm.TallPlan("f32", 128, 16, 1, 4)
    assert tsmm.tall_smem(f) == 1024 + 4 * (128 * 128 + 32 * 16 * 4 + 16)
    x = tsmm.TallPlan("tf32x3", 128, 120, 1, 4)
    assert tsmm.tall_smem(x) == 1024 + 4 * (128 * 128 + 2 * 120 * 128 + 16)


@pytest.mark.parametrize("kw,match", [
    (dict(n=6), "multiple of 4"),
    (dict(kps=48), "32-deep"),
    (dict(k=1026, kps=1024), "16-byte"),
    (dict(packed=True, pbm=12, pbk=128), "fp32 tiles"),
    (dict(packed=True, pbm=64, pbk=48, kps=48 * 8), "fp32 tiles")])
def test_fp32_layouts_no_design_takes_are_rejected(kw, match):
    """There is no other fp32 path: a layout neither design takes raises."""
    args = dict(m=1024, k=1024, n=32, dtype=F32)
    args.update(kw)
    m, k, n = args.pop("m"), args.pop("k"), args.pop("n")
    with pytest.raises(ValueError, match=match):
        _plan(m, k, n, **args)


def test_tall_width_never_pads_fp32_to_128():
    """fp32 pads N to 8 (<= 8 at N = 4, 48 at 48, 240 at 240), bf16 to
    the wgmma design's 128 columns; a padded width plans the design its N
    does."""
    assert tsmm.tall_width(4, F32) <= 8
    assert tsmm.tall_width(48, F32) in (48, 64)
    assert tsmm.tall_width(240, F32) == 240
    assert all(tsmm.tall_width(n, F32) < 128 for n in range(1, 121))
    assert [tsmm.tall_width(n, BF16) for n in (4, 128, 200)] == [128, 128, 256]
    for n in range(4, 260, 4):
        w = tsmm.tall_width(n, F32)
        assert w >= n and tsmm.tall_width(w, F32) == w
        assert (_plan(4096, 1024, n, dtype=F32).design
                == _plan(4096, 1024, w, dtype=F32).design)


@pytest.mark.parametrize("n", [4, 24, 100, 240])
def test_tall_wrappers_pad_fp32_to_tall_width(n):
    """``ops.pad_tall`` / ``pad_b_for_packed`` (and the bias beside them)
    pad B's columns to ``tall_width``: fp32 to a multiple of 8, bf16 to
    128."""
    for dt in (F32, BF16):
        a, b = torch.zeros((300, 200), dtype=dt), torch.zeros((200, n), dtype=dt)
        ap, bp, bm = ops.pad_tall(a, b, 128, 128)
        assert bp.shape == (256, tsmm.tall_width(n, dt)) and bm == 128
        assert ap.shape == (384, 256)
        packed = ops.pack_blocks(a, 128, 128)
        assert ops.pad_b_for_packed(packed, b).shape == bp.shape
    assert ops.pad_tall(torch.zeros((64, 64)), torch.zeros((64, 4)), 64,
                        64)[1].shape == (64, 8)


@pytest.mark.parametrize("prepack", [False, True])
@pytest.mark.parametrize("n", [4, 40, 200])
def test_gen_launches_plan_fp32_at_tall_width(n, prepack):
    """What the cost model plans for a tall fp32 problem is launched at
    ``tall_width``: N = 4 as 8 columns on the ``f32`` design, never 128."""
    g = BASELINE_POINT
    (entry,) = [e for e in gen.launches(g, "tall_a", 25600, 25600, n,
                                        dtype=F32, bm=256, bk=128, bn=128,
                                        prepack=prepack, sms=H100_SMS)
                if e[0] == "tsmm_tall"]
    dims, lp = entry[6], entry[4]
    assert dims == (25600, 25600, tsmm.tall_width(n, F32))
    assert lp.design == ("f32" if n < tsmm.TALL_F32_CROSSOVER else "tf32x3")
    assert entry[8] == tsmm.tall_smem(lp)
    (bf,) = [e for e in gen.launches(g, "tall_a", 25600, 25600, n,
                                     dtype=BF16, bm=256, bk=128, bn=128,
                                     prepack=prepack, sms=H100_SMS)
             if e[0] == "tsmm_tall"]
    assert bf[6][2] == 128 * -(-n // 128) and bf[4].design == "wgmma"


@pytest.mark.parametrize("n", [100, 0])
def test_n_off_the_column_tile_is_rejected(n):
    """bf16 still takes N in whole 128-column tiles only."""
    with pytest.raises(ValueError, match="multiple of 128" if n else "output"):
        _plan(1024, 1024, n)


@pytest.mark.parametrize("dtype,d,design", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "simt"),
    (F32, 64, "simt"), (F32, 128, "simt"), (F32, 32, "simt")])
def test_flash_design_by_dtype_and_head_dim(dtype, d, design):
    assert flash_design(dtype, d) == design


def test_tma_checks_raise_on_misaligned_views():
    base = torch.zeros(4 * 256 + 8, dtype=BF16)
    tsmm.check_tma(base[:1024].view(4, 256), "t", "A")          # aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        tsmm.check_tma(base[1:1025].view(4, 256), "t", "A")
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tsmm.check_tma(torch.zeros((4, 260), dtype=BF16)[:, :256], "t", "A")
    with pytest.raises(ValueError, match="contiguous"):
        tsmm.check_tma(base[:1024].view(4, 256).t(), "t", "A")
    # a (B, S, H, D) view whose head stride is off the 16-byte rule
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tsmm.check_tma(torch.zeros((1, 8, 2, 68), dtype=BF16)[..., :64], "f", "q")
    tsmm.check_tma(torch.zeros((1, 8, 2, 72), dtype=BF16)[..., :64], "f", "q")
