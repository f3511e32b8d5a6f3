"""The launch-configuration functions of the port's wgmma kernels, on the
CPU: ``kernels/tsmm.py::tall_plan`` / ``check_tma`` and
``kernels/flash_attention.py::flash_design``.  Pure functions of shapes,
dtypes and the SM count, so no card is needed."""

import pytest
import torch

from repro_torch.kernels import tsmm
from repro_torch.kernels.flash_attention import flash_design

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132


def _ctas(p, m, n, splits=1):
    return -(-m // p.bm) * (n // p.nt) * splits * p.cluster


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


@pytest.mark.parametrize("n,nt", [(128, 128), (256, 256), (384, 128)])
def test_fp32_column_tile_is_the_whole_skinny_width(n, nt):
    assert _plan(300, 1024, n, dtype=F32).nt == nt


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


def test_fp32_keeps_the_simt_tile():
    """fp32 has no wgmma path: the SIMT kernel's largest row tile that
    still gives every SM a CTA."""
    assert _plan(2048, 4096, 256, dtype=F32).bm == 16
    assert _plan(8192, 4096, 256, dtype=F32).bm == 32
    p = _plan(16384, 4096, 256, dtype=F32)
    assert (p.design, p.bm, p.cluster) == ("simt", 64, 1)
    assert _ctas(p, 16384, 256) >= H100_SMS


@pytest.mark.parametrize("n", [100, 0])
def test_n_off_the_column_tile_is_rejected(n):
    with pytest.raises(ValueError, match="multiple of 128"):
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
