"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the
kernels have no CPU mode).  On the card run
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q``.
Tolerances: f32 within 1e-4 (fp32 sums reassociated); bf16 within 1.6e-2
(one bf16 rounding of outputs of magnitude ~1, in different places).
"""

import pytest
import torch

from repro_torch.kernels import cuda, gen, ops, ref, tsmm
from repro_torch.kernels.flash_attention import _torch_attention, flash_attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 8, 70])
def test_skinny_modes_match_plain(dev, dtype, m):
    g = torch.Generator(device=dev).manual_seed(m)
    k, n, bk, bn = 1024, 384, 128, 128
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    b = torch.randn((n,), generator=g, device=dev).to(dtype)
    wp = ops.pack_blocks(w, bk, bn)
    before = cuda.launches["tsmm_skinny_a"]
    _close(tsmm.tsmm_skinny_a(x, wp, b, act="gelu"),
           tsmm._torch_skinny(x, wp, b, "gelu", natural=False, splits=1,
                              mode=tsmm.EPILOGUE), dtype)
    assert cuda.launches["tsmm_skinny_a"] == before + 1
    _close(gen._skinny_kinner(x, w, b, bk=bk, bn=bn, act="silu", natural=True,
                              resident=False, revisit=False),
           tsmm._torch_skinny(x, w, b, "silu", natural=True, splits=1,
                              mode=tsmm.EPILOGUE), dtype)
    for s in (2, 4, 8):
        _close(gen._skinny_ksplit(x, wp, bk=bk, bn=bn, splits=s,
                                  natural=False, resident=False),
               tsmm._torch_skinny(x, wp, None, None, natural=False, splits=s,
                                  mode=tsmm.RAW_F32), torch.float32)


def test_cuda_tensor_never_takes_the_plain_version(dev):
    x = torch.zeros((2, 256), device=dev, dtype=torch.float32)
    wp = torch.zeros((2, 1, 128, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tsmm.tsmm_skinny_a(x, wp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d", [(1, 64, 2, 2, 32), (2, 100, 4, 2, 64),
                                        (1, 256, 4, 4, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_plain(dev, dtype, b, s, h, kh, d, causal):
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, kh, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    _close(flash_attention(q, k, v, causal=causal),
           _torch_attention(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(300, 128), (2048, 256), (64, 384)])
def test_tall_modes_match_plain(dev, dtype, m, n):
    """Every tall mode (natural / packed A, epilogue / k-split partials /
    fp32 accumulate) against the plain version on the card."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    k, bm, bk = 1024, 64, 128
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    c = torch.randn((n,), generator=g, device=dev).to(dtype)
    ap = ops.pack_blocks(a, bm, bk)
    for x in (a, ap):
        _close(tsmm.launch_tall("t", x, b, c, "gelu", mode=tsmm.EPILOGUE),
               tsmm._torch_tall(x, b, c, "gelu", mode=tsmm.EPILOGUE,
                                splits=1, k0=0, k1=k, out=None), dtype)
        for s in (2, 4, 8):
            _close(tsmm.launch_tall("t", x, b, None, None, mode=tsmm.RAW_F32,
                                    splits=s),
                   tsmm._torch_tall(x, b, None, None, mode=tsmm.RAW_F32,
                                    splits=s, k0=0, k1=k, out=None),
                   torch.float32)
        rows = x.shape[0] * x.shape[2] if x.dim() == 4 else m
        got = torch.ones((rows, n), device=dev)
        want = torch.ones((rows, n), device=dev)
        for k0 in range(0, k, bk):
            tsmm.launch_tall("t", x, b, None, None, mode=tsmm.ACCUM_F32,
                             k0=k0, k1=k0 + bk, out=got)
            tsmm._torch_tall(x, b, None, None, mode=tsmm.ACCUM_F32, splits=1,
                             k0=k0, k1=k0 + bk, out=want)
        tsmm.launch_tall("t", x, b, c, "silu", mode=tsmm.ACCUM_F32, out=got)
        tsmm._torch_tall(x, b, c, "silu", mode=tsmm.ACCUM_F32, splits=1, k0=0,
                         k1=k, out=want)
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bm,bk", [((2048, 4096), 256, 128),
                                         ((300, 520), 128, 256),
                                         ((3, 96, 384), 32, 128)])
def test_pack_kernel_bit_equal_to_plain(dev, dtype, shape, bm, bk):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    a = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = cuda.launches["pack_blocks"]
    got = tsmm.pack_blocks_kernel(a, bm, bk)
    assert cuda.launches["pack_blocks"] == before + 1
    assert torch.equal(got, ref.pack_ref(a, bm, bk))
    torch.testing.assert_close(tsmm.pack_blocks_kernel(a, bm, bk, alpha=0.5),
                               ref.pack_ref(a, bm, bk, alpha=0.5), rtol=0,
                               atol=0)


@pytest.mark.parametrize("b,s,h,kh", [(1, 2048, 32, 2), (2, 1024, 8, 2)])
def test_flash_gqa16_long_prefill_matches_plain(dev, b, s, h, kh):
    """GLM-4-9B's prefill attention: S = 2048, 16 query heads per KV head."""
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, s, h, 128), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kh, 128), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    _close(flash_attention(q, k, v, causal=True),
           _torch_attention(q, k, v, causal=True), torch.bfloat16)
