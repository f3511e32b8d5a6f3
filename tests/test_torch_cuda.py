"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the
kernels have no CPU mode).  On the card run
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q``.
Tolerances: f32 within 1e-4 (fp32 sums reassociated); bf16 within 1.6e-2
(one bf16 rounding of outputs of magnitude ~1, in different places).
The bf16 skinny, tall and flash cases also assert, through
``cuda.design_launches``, that the Hopper designs (wgmma, and the
skinny kernel's byte-streaming design at decode) ran them; the fp32
skinny and tall cases that ``f32`` or ``tf32x3`` (3xTF32, held to the
same fp32 tolerance) did; the pack cases (bit-equal) that the TMA or the vec
design ran each.
"""

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import cuda, gen, ops, ref, tsmm
from repro_torch.kernels.flash_attention import _torch_attention, flash_attention
from repro_torch.models import attention
from repro_torch.models.layers import apply_rope, rope_tables

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    """The port's plan, measurement and miss files in a temporary
    directory (planning persists)."""
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))

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


# (shape, bm, bk, source offset in elements, the design the plan picks):
# the prefill A pack, ragged and stacked small packs, GLM-4-9B's per-call
# decode pack of wk/wv, a layer-stacked GLM-like leaf at reduced size
# (ragged K), a misaligned row stride (K = 1001), a misaligned base, and
# bk = 512 (two 256-wide TMA boxes a chunk) on both designs
PACK_CASES = [((2048, 4096), 256, 128, 0, "tma"),
              ((300, 520), 128, 256, 0, "vec"),
              ((3, 96, 384), 32, 128, 0, "vec"),
              ((4096, 256), 256, 128, 0, "vec"),
              ((8, 1024, 1712), 128, 128, 0, "tma"),
              ((2048, 1001), 256, 128, 0, "vec"),
              ((2048, 4096), 256, 128, 1, "vec"),
              ((2048, 4096), 128, 512, 0, "tma"),
              ((300, 1100), 64, 512, 0, "vec")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bm,bk,offset,design", PACK_CASES)
def test_pack_kernel_bit_equal_to_plain(dev, dtype, shape, bm, bk, offset,
                                        design):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    n = torch.Size(shape).numel()
    a = torch.randn((n + offset,), generator=g, device=dev).to(dtype)
    a = a[offset:].view(shape)
    before = cuda.launches["pack_blocks"]
    got, ran = _designs(lambda: tsmm.pack_blocks_kernel(a, bm, bk))
    assert cuda.launches["pack_blocks"] == before + 1
    assert ran == {f"pack_{design}": 1}
    assert torch.equal(got, ref.pack_ref(a, bm, bk))
    got, ran = _designs(lambda: tsmm.pack_blocks_kernel(a, bm, bk, alpha=0.5))
    assert ran == {f"pack_{design}": 1}
    torch.testing.assert_close(got, ref.pack_ref(a, bm, bk, alpha=0.5),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bm,bk", [((3, 300, 520), 64, 256),
                                         ((2, 256, 1024), 128, 512)])
def test_pack_every_plan_bit_equal(dev, dtype, shape, bm, bk):
    """Every TMA plan (chunk heights, rings of 2 to 4, persistent grids of
    1 CTA to one per chunk) and every vec plan (128 or 256 threads, 1 to 8
    rows a thread) through the C entry, ragged and stacked, alpha 1 and
    0.5: bit-equal to the plain version."""
    a = torch.randn(shape, generator=torch.Generator(device=dev)
                    .manual_seed(bk), device=dev).to(dtype)
    L, m, k = shape
    es = a.element_size()
    blocks = L * -(-m // bm) * -(-k // bk)
    plans = []
    box = tsmm.pack_tma_box(k, bk, es, 16)
    for rows in (r for r in tsmm.pack_tma_rows(bm) if r & (r - 1) == 0):
        chunks = blocks * (bm // rows)
        plans += [tsmm.PackPlan("tma", rows, grid, 128, stages, box)
                  for stages in (2, 3, 4) for grid in (1, 7, chunks)
                  if tsmm.pack_tma_smem(rows, bk, es, stages)
                  <= tsmm.PACK_SMEM_MAX]
    for threads in (128, 256):
        vbox, ty = tsmm.pack_vec_shape(bk, es, threads)
        plans += [tsmm.PackPlan("vec", ty * per, blocks * -(-bm // (ty * per)),
                                threads, 0, vbox) for per in (1, 2, 4, 8)]
    assert box and len(plans) > 20
    out = torch.empty_like(ref.pack_ref(a, bm, bk))
    for alpha in (1.0, 0.5):
        want = ref.pack_ref(a, bm, bk, alpha=alpha)
        for p in plans:
            out.fill_(float("nan"))
            tsmm.launch_pack(a, out, bm, bk, alpha, p)
            assert torch.equal(out, want), (p, alpha)


def test_pack_refuses_a_one_stage_ring(dev):
    """A TMA ring refills a stage only after the next chunk's store, so
    one stage cannot run: the C entry refuses it and the launch raises."""
    a = torch.ones((256, 256), device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(ref.pack_ref(a, 128, 128))
    with pytest.raises(RuntimeError, match="failed to launch"):
        tsmm.launch_pack(a, out, 128, 128, 1.0,
                         tsmm.PackPlan("tma", 64, 4, 128, 1, 128))


@pytest.mark.parametrize("b,s,h,kh", [(1, 2048, 32, 2), (2, 1024, 8, 2)])
def test_flash_gqa16_long_prefill_matches_plain(dev, b, s, h, kh):
    """GLM-4-9B's prefill attention: S = 2048, 16 query heads per KV head."""
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, s, h, 128), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kh, 128), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    _close(flash_attention(q, k, v, causal=True),
           _torch_attention(q, k, v, causal=True), torch.bfloat16)


def _designs(fn):
    """Run ``fn``; return its result and the design launches it added."""
    before = dict(cuda.design_launches)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in cuda.design_launches.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("m", [300, 2050])
@pytest.mark.parametrize("n", [128, 256, 384])
@pytest.mark.parametrize("pbm", [64, 256])
def test_tall_wgmma_modes_match_plain(dev, m, n, pbm):
    """bf16 tall-A through the wgmma design: ragged M, N of one or several
    column tiles, natural and packed A, every mode (fused epilogue,
    k-split partials 2/4/8, one-block k-outer passes, revisit)."""
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(m + n + pbm)
    k, bk = 1024, 128
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    c = torch.randn((n,), generator=g, device=dev).to(dtype)
    ap = ops.pack_blocks(a, pbm, bk)

    def run():
        for x in (a, ap):
            _close(tsmm.launch_tall("t", x, b, c, "gelu", mode=tsmm.EPILOGUE),
                   tsmm._torch_tall(x, b, c, "gelu", mode=tsmm.EPILOGUE,
                                    splits=1, k0=0, k1=k, out=None), dtype)
            for s in (2, 4, 8):
                _close(tsmm.launch_tall("t", x, b, None, None,
                                        mode=tsmm.RAW_F32, splits=s),
                       tsmm._torch_tall(x, b, None, None, mode=tsmm.RAW_F32,
                                        splits=s, k0=0, k1=k, out=None),
                       torch.float32)
            rows = x.shape[0] * x.shape[2] if x.dim() == 4 else m
            got = torch.ones((rows, n), device=dev)
            want = torch.ones((rows, n), device=dev)
            for k0 in range(0, k, bk):
                tsmm.launch_tall("t", x, b, None, None, mode=tsmm.ACCUM_F32,
                                 k0=k0, k1=k0 + bk, out=got)
                tsmm._torch_tall(x, b, None, None, mode=tsmm.ACCUM_F32,
                                 splits=1, k0=k0, k1=k0 + bk, out=want)
            _close(got, want, torch.float32)
            got = torch.zeros((rows, n), device=dev)
            want = torch.zeros((rows, n), device=dev)
            tsmm.launch_tall("t", x, b, c, "silu", mode=tsmm.ACCUM_F32, out=got)
            tsmm._torch_tall(x, b, c, "silu", mode=tsmm.ACCUM_F32, splits=1,
                             k0=0, k1=k, out=want)
            _close(got, want, torch.float32)

    _, designs = _designs(run)
    per_layout = 1 + 3 + k // bk + 1
    assert designs == {"tall_wgmma": 2 * per_layout}


@pytest.mark.parametrize("m,cluster", [(2048, 4), (4096, 2), (8192, 1)])
def test_tall_wgmma_glm_kv_shapes_match_plain(dev, m, cluster):
    """GLM-4-9B's wk/wv with their bias at the prefill of one and two
    2048-token prompts (and four), natural and packed at (256, 128): the
    plan's cluster at each m, against the plain version."""
    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 4096, 256
    a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    c = (0.1 * torch.randn((n,), generator=g, device=dev)).to(torch.bfloat16)
    plan = tsmm.tall_plan(m, k, n, dtype=torch.bfloat16, packed=False, pbm=0,
                          pbk=0, mode=tsmm.EPILOGUE, splits=1, kps=k,
                          sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert plan.cluster == cluster
    want = tsmm._torch_tall(a, b, c, None, mode=tsmm.EPILOGUE, splits=1, k0=0,
                            k1=k, out=None)
    ap = ops.pack_blocks(a, 256, 128)
    got, designs = _designs(lambda: [tsmm.launch_tall("t", x, b, c, None,
                                                      mode=tsmm.EPILOGUE)
                                     for x in (a, ap)])
    assert designs == {"tall_wgmma": 2}
    for y in got:
        _close(y, want, torch.bfloat16)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_tall_wgmma_every_column_tile_and_cluster(dev, cluster):
    """The wgmma kernel at its one column tile (128) and every cluster
    size, through its C interface, with the ring depths
    ``launch/tall_sweep.py`` times; it refuses another column tile and a
    ring deeper than shared memory holds."""
    g = torch.Generator(device=dev).manual_seed(cluster)
    m, k, n = 300, 1024, 256
    a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    c = torch.randn((n,), generator=g, device=dev).to(torch.bfloat16)
    want = tsmm._torch_tall(a, b, c, "relu", mode=tsmm.EPILOGUE, splits=1, k0=0,
                            k1=k, out=None)
    lib = cuda.load()["tsmm_tall"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)

    def launch(nt, stages):
        return lib.tsmm_tall_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    out.data_ptr(), None, m, k, n, 0, 0, 0, 0,
                                    k, 1, 0, 64, nt, cluster, stages,
                                    tsmm.EPILOGUE, 1, 1, stream)

    for stages in (3, 4, 5):
        out.zero_()
        cuda.check(launch(tsmm.TALL_NT, stages), "tsmm_tall")
        _close(out, want, torch.bfloat16)
    assert launch(256, 4) != 0
    assert launch(tsmm.TALL_NT, 10) != 0


def test_tall_fp32_runs_its_designs_and_every_design_refuses_bad_layouts(dev):
    """fp32 runs ``f32`` below the crossover and ``tf32x3`` at or above it
    (never another path); a layout a design cannot take raises instead of
    taking another path, fp32 and bf16."""
    g = torch.Generator(device=dev).manual_seed(7)
    k = 512
    a = torch.randn((256, k), generator=g, device=dev)
    for n, design in ((16, "tall_f32"), (256, "tall_tf32x3")):
        b = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
        got, designs = _designs(lambda: tsmm.launch_tall(
            "t", a, b, None, None, mode=tsmm.EPILOGUE))
        assert designs == {design: 1}
        _close(got, a @ b, torch.float32)
    with pytest.raises(ValueError, match="fp32 tiles"):
        tsmm.launch_tall("t", ops.pack_blocks(a, 12, 128), b, None, None,
                         mode=tsmm.EPILOGUE)
    with pytest.raises(ValueError, match="32-deep"):
        tsmm.launch_tall("t", a, b, None, None, mode=tsmm.ACCUM_F32, k0=0,
                         k1=48, out=torch.zeros((256, 256), device=dev))
    with pytest.raises(ValueError, match="multiple of 4"):
        tsmm.launch_tall("t", a, b[:, :6].contiguous(), None, None,
                         mode=tsmm.EPILOGUE)
    flat = torch.zeros(256 * k + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        tsmm.launch_tall("t", flat[1:].view(256, k), b, None, None,
                         mode=tsmm.EPILOGUE)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma tile"):
        tsmm.launch_tall("t", ops.pack_blocks(ab, 32, 128), bb, None, None,
                         mode=tsmm.EPILOGUE)
    flat = torch.zeros(256 * k + 1, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        tsmm.launch_tall("t", flat[1:].view(256, k), bb, None, None,
                         mode=tsmm.EPILOGUE)
    with pytest.raises(ValueError, match="64-deep"):
        tsmm.launch_tall("t", ab, bb, None, None, mode=tsmm.ACCUM_F32, k0=0,
                         k1=96, out=torch.zeros((256, 256), device=dev))


FP32_NS = (4, 8, 24, 48, 64, 96, 128, 200, 240, 256)


@pytest.mark.parametrize("n", FP32_NS)
@pytest.mark.parametrize("layout", ["natural", (256, 128), (8, 32)])
def test_tall_fp32_designs_match_plain(dev, n, layout):
    """Each fp32 design (``f32`` below the crossover, ``tf32x3`` at or
    above it) against the plain version at the unchanged fp32 tolerance:
    ragged M (300 rows), natural A and A packed at (256, 128) or (8, 32)
    (a block shorter than the row tile), the fused epilogue with the bias
    and each activation, k-split partials 1 and 8, one-block k-outer
    passes and a revisit with bias and SiLU into an fp32 output."""
    g = torch.Generator(device=dev).manual_seed(n)
    m, k, bk = 300, 1024, 128
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    c = torch.randn((n,), generator=g, device=dev)
    x = a if layout == "natural" else ops.pack_blocks(a, *layout)
    rows = x.shape[0] * x.shape[2] if x.dim() == 4 else m
    design = ("tall_f32" if tsmm.tall_width(n, torch.float32)
              < tsmm.TALL_F32_CROSSOVER else "tall_tf32x3")

    def plain(mode, bias=None, act=None, splits=1, k0=0, k1=k, out=None):
        return tsmm._torch_tall(x, b, bias, act, mode=mode, splits=splits,
                                k0=k0, k1=k1, out=out)

    def run():
        for act in (None, "relu", "silu", "gelu"):
            _close(tsmm.launch_tall("t", x, b, c, act, mode=tsmm.EPILOGUE),
                   plain(tsmm.EPILOGUE, c, act), torch.float32)
        for s in (1, 8):
            _close(tsmm.launch_tall("t", x, b, None, None, mode=tsmm.RAW_F32,
                                    splits=s),
                   plain(tsmm.RAW_F32, splits=s), torch.float32)
        got = torch.ones((rows, n), device=dev)
        want = torch.ones((rows, n), device=dev)
        for k0 in range(0, k, bk):
            tsmm.launch_tall("t", x, b, None, None, mode=tsmm.ACCUM_F32,
                             k0=k0, k1=k0 + bk, out=got)
            plain(tsmm.ACCUM_F32, k0=k0, k1=k0 + bk, out=want)
        _close(got, want, torch.float32)
        got = torch.zeros((rows, n), device=dev)
        want = torch.zeros((rows, n), device=dev)
        tsmm.launch_tall("t", x, b, c, "silu", mode=tsmm.ACCUM_F32, out=got)
        plain(tsmm.ACCUM_F32, c, "silu", out=want)
        _close(got, want, torch.float32)

    _, designs = _designs(run)
    assert designs == {design: 4 + 2 + k // bk + 1}


@pytest.mark.parametrize("design", ["f32", "tf32x3"])
def test_tall_fp32_every_plan_through_the_c_entry(dev, design):
    """Every row tile, column tile and ring depth of each fp32 design
    (what ``launch/tall_sweep.py --dtype float32`` times), through the C
    interface, against the plain version; the entry refuses a column
    tile the design does not take, a ring deeper than shared memory and a
    tf32x3 launch without its scratch."""
    g = torch.Generator(device=dev).manual_seed(len(design))
    m, k = 300, 1024
    lib = cuda.load()["tsmm_tall"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ntiles = (tsmm.TALL_F32_NT if design == "f32" else (8, 48, 64, 120, 128))
    for nt in ntiles:
        n = nt if design == "tf32x3" else max(4, nt - 4)
        a = torch.randn((m, k), generator=g, device=dev)
        b = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
        c = torch.randn((n,), generator=g, device=dev)
        want = tsmm._torch_tall(a, b, c, "gelu", mode=tsmm.EPILOGUE, splits=1,
                                k0=0, k1=k, out=None)
        out = torch.empty((m, n), device=dev)
        scratch = torch.empty((2, nt, k), device=dev)

        def launch(bm, stages, nt=nt, scratch=scratch.data_ptr()):
            return lib.tsmm_tall_launch(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                scratch, m, k, n, 0, 0, 0, 0, k, 1, tsmm._TALL_DESIGN[design],
                bm, nt, 1, stages, tsmm.EPILOGUE, 3, 0, stream)

        for bm in (64, 128):
            for stages in (2, 3, 4, 6):
                plan = tsmm.TallPlan(design, bm, nt, 1, stages)
                if tsmm.tall_smem(plan) > tsmm.TALL_SMEM_MAX:
                    assert launch(bm, stages) != 0
                    continue
                out.zero_()
                cuda.check(launch(bm, stages), "tsmm_tall")
                _close(out, want, torch.float32)
        assert launch(128, 4, nt=nt + 4) != 0
        if design == "tf32x3":
            assert launch(128, 2, scratch=None) != 0


@pytest.mark.parametrize("s", [100, 256, 1024, 2048])
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_matches_plain(dev, s, group, d, causal):
    """bf16 flash through the wgmma design: ragged and long S, MHA and
    GQA 4 / 16, both head dims, causal and full."""
    kh = 2
    g = torch.Generator(device=dev).manual_seed(s + group + d)
    q = torch.randn((1, s, kh * group, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, s, kh, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    got, designs = _designs(lambda: flash_attention(q, k, v, causal=causal))
    assert designs == {"flash_wgmma": 1}
    _close(got, _torch_attention(q, k, v, causal=causal), torch.bfloat16)


def test_flash_wgmma_on_the_models_qkv_views(dev):
    """The q/k/v the attention block makes (projections with bias, RoPE) go
    through the wgmma design as the prefill gives them."""
    cfg = get_config("glm4_9b").reduced(d_model=512, num_heads=8,
                                        num_kv_heads=2, head_dim=128,
                                        d_ff=1024, dtype="bfloat16")
    gen_ = torch.Generator(device=dev).manual_seed(3)
    p, _ = attention.init_gqa(gen_, cfg)
    for name in ("bq", "bk", "bv"):
        p[name] = 0.1 * torch.randn(p[name].shape, generator=gen_, device=dev
                                    ).to(p[name].dtype)
    b, s = 2, 512
    x = torch.randn((b, s, cfg.d_model), generator=gen_, device=dev).to(torch.bfloat16)
    q, k, v = attention._qkv(p, cfg, x)
    cos, sin = rope_tables(torch.arange(s, device=dev), cfg.head_dim,
                           cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    got, designs = _designs(lambda: attention.chunked_attention(q, k, v,
                                                                causal=True))
    assert designs == {"flash_wgmma": 1}
    _close(got, _torch_attention(q, k, v, causal=True), torch.bfloat16)


def test_flash_fp32_and_d32_run_simt(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 32)):
        q = torch.randn((1, 128, 4, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((1, 128, 2, d), generator=g, device=dev).to(dtype)
                for _ in range(2))
        got, designs = _designs(lambda: flash_attention(q, k, v))
        assert designs == {"flash_simt": 1}
        _close(got, _torch_attention(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 100, 1000, 2048])
@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("bn", [128, 256])
def test_skinny_bf16_designs_match_plain(dev, m, natural, bn):
    """bf16 skinny-A through its two Hopper designs (stream at m <= 8,
    wgmma above): packed and natural W, blocks 128 and 256 wide, every
    activation with and without bias, k-split partials 2/4/8."""
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(m + bn + natural)
    k, n, bk = 1024, 512, 128
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    c = torch.randn((n,), generator=g, device=dev).to(dtype)
    wq = w if natural else ops.pack_blocks(w, bk, bn)
    design = "skinny_stream" if m <= tsmm.SKINNY_STREAM_M else "skinny_wgmma"

    def run():
        for act in (None, "relu", "silu", "gelu"):
            for bias in (None, c):
                _close(tsmm.launch_skinny("t", x, wq, bias, act,
                                          natural=natural, splits=1,
                                          mode=tsmm.EPILOGUE, bk=bk, bn=bn),
                       tsmm._torch_skinny(x, wq, bias, act, natural=natural,
                                          splits=1, mode=tsmm.EPILOGUE),
                       dtype)
        for s in (2, 4, 8):
            _close(tsmm.launch_skinny("t", x, wq, None, None, natural=natural,
                                      splits=s, mode=tsmm.RAW_F32, bk=bk,
                                      bn=bn),
                   tsmm._torch_skinny(x, wq, None, None, natural=natural,
                                      splits=s, mode=tsmm.RAW_F32),
                   torch.float32)

    _, designs = _designs(run)
    assert designs == {design: 8 + 3}


@pytest.mark.parametrize("m", [1, 2, 2048])
def test_skinny_glm_w_down_matches_plain(dev, m):
    """GLM-4-9B's w_down (K = 13696 = 214 stages of 64, no split divides
    its 107 blocks) with SiLU and bias: at decode through the stream
    design on an 8-CTA cluster of unequal k ranges, at prefill through
    wgmma."""
    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 13696, 4096
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    c = (0.1 * torch.randn((n,), generator=g, device=dev)).to(torch.bfloat16)
    wp = ops.pack_blocks(w, 128, 128)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tsmm.skinny_plan(m, k, n, dtype=torch.bfloat16, natural=False,
                            bk=128, bn=128, mode=tsmm.EPILOGUE, splits=1,
                            kps=k, sms=sms)
    if m <= tsmm.SKINNY_STREAM_M and sms == 132:
        assert plan.cluster == 8
    got, designs = _designs(lambda: tsmm.tsmm_skinny_a(x, wp, c, act="silu"))
    assert designs == {f"skinny_{plan.design}": 1}
    _close(got, tsmm._torch_skinny(x, wp, c, "silu", natural=False, splits=1,
                                   mode=tsmm.EPILOGUE), torch.bfloat16)


def test_skinny_every_plan_through_the_c_entry(dev):
    """Both bf16 designs at every plan ``launch/skinny_sweep.py`` times
    (wgmma row tiles 64 / 128 x rings 2-6 that hold the fp32 tile; stream
    clusters 1-8 x rings 2-6), through the C interface; the entry refuses
    a cluster it does not take, another column tile, a ring deeper than
    shared memory and the stream design above 8 rows."""
    g = torch.Generator(device=dev).manual_seed(11)
    k, n, bk, bn = 1024, 384, 128, 128
    w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    c = torch.randn((n,), generator=g, device=dev).to(torch.bfloat16)
    wp = ops.pack_blocks(w, bk, bn)
    lib = cuda.load()["tsmm_skinny"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(x, out, design, bm, nt, cluster, stages):
        return lib.tsmm_skinny_launch(
            x.data_ptr(), wp.data_ptr(), c.data_ptr(), out.data_ptr(), None,
            x.shape[0], k, n, k, bk, bn, 0, 1, tsmm.EPILOGUE, 3, 1, design,
            bm, nt, cluster, stages, stream)

    for m, design, plans in (
            (300, 1, [(bm, 128, 1, st) for bm in (64, 128)
                      for st in (2, 3, 4, 5, 6)
                      if st * (bm + 128) * 128 >= bm * 136 * 4]),
            (5, 2, [(8, 128, cl, st) for cl in (1, 2, 4, 8)
                    for st in (2, 4, 6)])):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        want = tsmm._torch_skinny(x, wp, c, "gelu", natural=False, splits=1,
                                  mode=tsmm.EPILOGUE)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        for bm, nt, cluster, stages in plans:
            out.zero_()
            cuda.check(launch(x, out, design, bm, nt, cluster, stages),
                       "skinny")
            _close(out, want, torch.bfloat16)
        bm, nt = plans[0][:2]
        assert launch(x, out, design, bm, nt, 3, 4) != 0
        assert launch(x, out, design, bm, nt, 1, 20) != 0
        assert launch(x, out, design, bm, 256, 1, 4) != 0
    x = torch.zeros((9, k), dtype=torch.bfloat16, device=dev)
    assert launch(x, torch.empty((9, n), dtype=torch.bfloat16, device=dev),
                  2, 8, 128, 1, 4) != 0


@pytest.mark.parametrize("design", ["skinny_f32", "skinny_tf32x3"])
def test_skinny_fp32_designs_match_plain_and_refuse_bad_layouts(dev, design):
    """fp32 skinny-A through each of its two designs (``f32`` at m <=
    ``SKINNY_F32_CROSSOVER``, ``tf32x3`` above): packed and natural W,
    mode 0 with bias and every activation, mode 1 at splits 2 and 4,
    ragged m, each against the plain version at 1e-4 (3xTF32 held to the
    same fp32 tolerance); a layout neither design takes raises."""
    g = torch.Generator(device=dev).manual_seed(13)
    k, n, bk, bn = 1024, 384, 128, 128
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    c = torch.randn((n,), generator=g, device=dev)
    wp = ops.pack_blocks(w, bk, bn)
    cross = tsmm.SKINNY_F32_CROSSOVER
    rows = ((1, 3, 8, 13, cross) if design == "skinny_f32"
            else (cross + 1, 70, 129, 300))
    for m in rows:
        x = torch.randn((m, k), generator=g, device=dev)

        def run():
            for wq, natural in ((wp, False), (w, True)):
                for act in (None, "relu", "silu", "gelu"):
                    for bias in (None, c):
                        _close(tsmm.launch_skinny(
                            "t", x, wq, bias, act, natural=natural, splits=1,
                            mode=tsmm.EPILOGUE, bk=bk, bn=bn),
                            tsmm._torch_skinny(x, wq, bias, act,
                                               natural=natural, splits=1,
                                               mode=tsmm.EPILOGUE),
                            torch.float32)
                for s in (2, 4):
                    _close(tsmm.launch_skinny(
                        "t", x, wq, None, None, natural=natural, splits=s,
                        mode=tsmm.RAW_F32, bk=bk, bn=bn),
                        tsmm._torch_skinny(x, wq, None, None, natural=natural,
                                           splits=s, mode=tsmm.RAW_F32),
                        torch.float32)

        _, designs = _designs(run)
        assert designs == {design: 2 * (8 + 2)}
    x = torch.randn((rows[0], k), generator=g, device=dev)
    flat = torch.zeros(rows[0] * k + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        tsmm.tsmm_skinny_a(flat[1:].view(rows[0], k), wp)
    with pytest.raises(ValueError, match="32-deep"):
        tsmm.launch_skinny("t", x[:, :48].contiguous(), w[:48], None, None,
                           natural=True, splits=1, mode=tsmm.EPILOGUE, bk=48,
                           bn=128)
    with pytest.raises(ValueError, match="do not tile"):
        tsmm.launch_skinny("t", x, w[:, :96].contiguous(), None, None,
                           natural=True, splits=1, mode=tsmm.EPILOGUE, bk=bk,
                           bn=96)


def test_skinny_fp32_every_plan_through_the_c_entry(dev):
    """Both fp32 designs at the kinds of plan ``launch/skinny_sweep.py
    --dtype float32`` times (f32: row tiles 8-64 x column tiles 32-128 x
    clusters 1-8 x rings 4 / 8; tf32x3: row tiles 8-128 x 64 / 128 W
    columns x clusters 1, 4, 8 x rings 2 / 4 that fit), through the C
    interface, against the plain version; the entry refuses an f32 tile
    shorter than m or than a consumer thread row, a cluster it does not
    take, a tf32x3 row tile off 8 or past 128, and
    tf32x3 without its scratch."""
    g = torch.Generator(device=dev).manual_seed(17)
    k, n, bk, bn = 2048, 512, 128, 128
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    c = torch.randn((n,), generator=g, device=dev)
    wp = ops.pack_blocks(w, bk, bn)
    lib = cuda.load()["tsmm_skinny"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(x, out, scratch, design, bm, nt, cluster, stages):
        return lib.tsmm_skinny_launch(
            x.data_ptr(), wp.data_ptr(), c.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), x.shape[0], k,
            n, k, bk, bn, 0, 1, tsmm.EPILOGUE, 2, 0, design, bm, nt, cluster,
            stages, stream)

    for m in (5, 30, 100):
        x = torch.randn((m, k), generator=g, device=dev)
        want = tsmm._torch_skinny(x, wp, c, "silu", natural=False, splits=1,
                                  mode=tsmm.EPILOGUE)
        out = torch.empty((m, n), device=dev)
        plans = []
        if m <= 64:
            plans += [(0, bm, nt, cl, st) for bm in (8, 16, 32, 64)
                      for nt in (32, 64, 128) for cl in (1, 2, 4, 8)
                      for st in (4, 8)
                      if bm >= max(m, 512 // nt)]
        plans += [(3, bm, nt, cl, st) for bm in (8, 24, 72, 128)
                  for nt in (64, 128) for cl in (1, 4, 8) for st in (2, 4)
                  if tsmm.skinny_smem(tsmm.SkinnyPlan("tf32x3", bm, nt, cl,
                                                      st))
                  <= tsmm.SKINNY_SMEM_MAX]
        for design, bm, nt, cluster, stages in plans:
            scratch = (torch.empty((2, -(-m // bm) * bm, k), device=dev)
                       if design == 3 else None)
            out.zero_()
            cuda.check(launch(x, out, scratch, design, bm, nt, cluster,
                              stages), f"skinny {design} {bm} {nt} {cluster}")
            _close(out, want, torch.float32)
        if m <= 64:
            assert launch(x, out, None, 0, 8, 32, 1, 4) != 0      # 8 < 16
            assert launch(x, out, None, 0, 64, 64, 3, 4) != 0     # cluster
            assert launch(x, out, None, 0, 64, 256, 1, 4) != 0
        if m > 8:
            assert launch(x, out, None, 0, 8, 128, 1, 4) != 0     # m > bm
        scratch = torch.empty((2, 256, k), device=dev)
        assert launch(x, out, None, 3, 64, 64, 1, 4) != 0         # scratch
        assert launch(x, out, scratch, 3, 12, 64, 1, 4) != 0
        assert launch(x, out, scratch, 3, 136, 64, 1, 2) != 0
        assert launch(x, out, scratch, 3, 64, 32, 1, 4) != 0


@pytest.mark.parametrize("shape", [(4, 2560, 6912), (2048, 4096, 256)],
                         ids=["skinny", "tall"])
def test_measure_plan_times_the_kernels_after_parity(dev, shape):
    """The evaluator times a plan's CUDA kernels (never a plain version),
    after holding the timed call to the serving path."""
    from repro_torch.core import evaluator, registry
    from repro_torch.core.autotuner import candidate_blocks
    from repro_torch.core.hw import for_device
    from repro_torch.core.plan import Problem
    registry.clear_memory()
    plan = candidate_blocks(Problem(*shape, "bfloat16"), for_device(dev))[0]
    before = sum(cuda.launches.values())
    rec = evaluator.measure_plan(plan, dev, iters=5)
    assert sum(cuda.launches.values()) >= before + 7   # parity + 2 + 5
    assert rec.impl == "cuda" and rec.iters == 5 and 0 < rec.seconds < 0.1
    assert registry.lookup_measurement(plan, dev) == rec
    registry.clear_memory()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grammar_check_on_the_card(dev, dtype):
    """Every sampled grammar point and schedule through the CUDA kernels,
    against their plain versions (install --check)."""
    from repro_torch.kernels.variants import verify_schedules, verify_variants
    rows = verify_variants("cuda", dtype=dtype) + \
        verify_schedules("cuda", dtype=dtype)
    assert rows and [r for r in rows if not r["ok"]] == []


def test_event_timing_is_positive_and_stable(dev):
    import numpy as np

    from repro_torch.core import evaluator
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4, 4096), generator=g, device=dev).to(torch.bfloat16)
    wp = ops.pack_blocks(torch.randn((4096, 4096), generator=g, device=dev)
                         .to(torch.bfloat16), 128, 128)

    def fn():
        return tsmm.tsmm_skinny_a(x, wp)

    a = evaluator.time_samples(fn, warmup=3, iters=30, device=dev)
    b = evaluator.time_samples(fn, warmup=3, iters=30, device=dev)
    assert len(a) == 30 and min(a) > 0 and min(b) > 0
    q25, q75 = np.percentile(a, (25, 75))
    spread = max((q75 - q25) / min(a), 0.1)
    assert abs(min(b) - min(a)) <= spread * min(a)


# ---------------------------------------------------------------------------
# the program store: captured CUDA graphs against eager cells
# ---------------------------------------------------------------------------


def _graph_engine(dev, arch, layers=2, **kw):
    """A ``layers``-layer ``arch`` at full width, bf16, seeded random
    weights, its buckets 1 and 2 and prompts to 256."""
    import dataclasses

    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
    return Engine(model, params, axes, max_len=256 + 16, max_batch=2,
                  max_prompt=256, device=dev, **kw), cfg


def _serve(eng, store, batch, steps):
    """One group through ``store``; returns (result, launches by kernel,
    by design) counted around it."""
    from collections import Counter
    eng.programs, prev = store, eng.programs
    before = Counter(cuda.launches), Counter(cuda.design_launches)
    try:
        res = eng.generate(batch, steps)
        torch.cuda.synchronize()
    finally:
        eng.programs = prev
    return (res, Counter(cuda.launches) - before[0],
            Counter(cuda.design_launches) - before[1])


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "glm4_9b"])
def test_graphed_cells_bit_equal_to_eager_with_equal_counts(dev, arch):
    from repro_torch.serve.programs import ProgramStore
    eng, cfg = _graph_engine(dev, arch)
    rows = eng.precompile()
    assert len(rows) == 2 * (1 + 3 * len(eng.grid.length))
    assert eng.programs.stats()["captured"] == len(rows)
    assert eng.programs.stats()["pool_bytes"] > 0
    eager = ProgramStore(eng.model, device=dev, capture=False)
    g = torch.Generator().manual_seed(1)
    groups = [{"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                       dtype=torch.int32)}
              for b, s in ((1, 256), (2, 128), (2, 64))]
    for batch in groups:
        want, wl, wd = _serve(eng, eager, batch, 6)
        got, gl, gd = _serve(eng, eng.programs, batch, 6)
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.logits_last, want.logits_last)
        assert gl == wl and gd == wd and sum(gl.values()) > 0
        assert got.compile_s == 0.0
    assert eng.programs.stats()["captured"] == len(rows)


def test_cells_of_several_buckets_interleaved_in_one_pool(dev):
    """Prefill and decode cells of both buckets and three lengths share
    the store's pool; replayed in an interleaved order, twice, every
    group stays bit-equal to its eager run."""
    from repro_torch.serve.programs import ProgramStore
    eng, cfg = _graph_engine(dev, "qwen1_5_4b")
    eng.precompile()
    eager = ProgramStore(eng.model, device=dev, capture=False)
    g = torch.Generator().manual_seed(2)
    groups = [{"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                       dtype=torch.int32)}
              for b, s in ((1, 256), (2, 32), (1, 64), (2, 256), (1, 32))]
    want = [_serve(eng, eager, batch, 5)[0] for batch in groups]
    for order in ([0, 3, 1, 4, 2], [4, 2, 0, 1, 3]):
        for i in order:
            got = _serve(eng, eng.programs, groups[i], 5)[0]
            assert torch.equal(got.tokens, want[i].tokens), i
            assert torch.equal(got.logits_last, want[i].logits_last), i
    ragged = [{"tokens": torch.randint(0, cfg.vocab_size, (n,), generator=g,
                                       dtype=torch.int32)} for n in (20, 31)]
    eng.programs, graphed = eager, eng.programs
    want_r = eng.serve(ragged, 4)
    eng.programs = graphed
    got_r = eng.serve(ragged, 4)
    for a, b in zip(got_r, want_r):
        assert torch.equal(a.tokens, b.tokens)
        assert torch.equal(a.logits_last, b.logits_last)
    assert eng.programs.stats()["captured"] == 2 * (1 + 3 * len(
        eng.grid.length))


def test_capture_while_the_background_tuner_times(dev):
    """The background tuner times registry misses on its own thread and
    stream; cells captured meanwhile (thread-local capture mode) succeed
    and serve the same tokens as eager cells."""
    from repro_torch.core import autotuner
    from repro_torch.core.plan import Problem
    from repro_torch.serve.programs import ProgramStore
    prev = autotuner.set_default_hw(None)
    try:
        eng, cfg = _graph_engine(dev, "qwen1_5_4b", background_tune=True,
                                 tuner_opts=dict(iters=50, warmup=2))
        store = eng.programs
        busy, capture = [], store._capture

        def capture_noting_the_tuner(*a, **k):
            busy.append(eng.tuner.busy())
            return capture(*a, **k)

        store._capture = capture_noting_the_tuner
        eng.tuner.submit([Problem(m, 2560, n, "bfloat16").key()
                          for m in (3, 5, 6, 7, 9, 12, 17, 24, 33, 48)
                          for n in (2560, 6912, 151936)])
        rows = eng.precompile()
        assert eng.programs.stats()["captured"] == len(rows) == len(busy)
        # the captures that ran while the tuner was timing (at least the
        # first one, which started right after the submit)
        assert busy[0], busy
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                         generator=torch.Generator()
                                         .manual_seed(3), dtype=torch.int32)}
        got = _serve(eng, eng.programs, batch, 4)[0]
        want = _serve(eng, ProgramStore(eng.model, device=dev,
                                        capture=False), batch, 4)[0]
        assert torch.equal(got.tokens, want.tokens)
        eng.tuner.join(timeout=600)
        assert not eng.tuner.busy() and eng.tuner.committed
        print(f"captures made while the tuner timed: {sum(busy)} of "
              f"{len(busy)}")
    finally:
        autotuner.set_default_hw(prev)


# ---------------------------------------------------------------------------
# continuous batching: the captured prefill_row cells and the slot pool
# ---------------------------------------------------------------------------


def test_captured_prefill_row_replays_bit_equal_to_eager(dev):
    """Every ``prefill_row`` cell of the grid, captured at load, replays
    at a seeded row and clock bit-equal to its eager run: logits and the
    written cache row (``check_cells`` scrubs the row between the runs),
    and an admission through an eager store writes the same row."""
    from repro_torch.serve.programs import ProgramStore, check_cells, row_args
    eng, cfg = _graph_engine(dev, "qwen1_5_4b")
    eng.precompile()
    checks = check_cells(eng.programs, seed=5)
    rows = [c for c in checks if c["kind"] == "prefill_row"]
    assert len(rows) == 2 * len(eng.grid.length)
    assert all(c["equal"] for c in checks), [c for c in checks
                                             if not c["equal"]]
    eager = ProgramStore(eng.model, device=dev, capture=False)
    g = torch.Generator().manual_seed(6)
    lb = 64
    outs = []
    for store in (eager, eng.programs):
        cache = store.static_cache(2, eng.max_len)
        for k in ("k", "v"):
            cache[k].zero_()
        args = row_args(store, eng.params, cache, lb)
        args[1]["tokens"].copy_(torch.randint(0, cfg.vocab_size, (1, lb),
                                              generator=g.manual_seed(6),
                                              dtype=torch.int32))
        args[1]["pad"].fill_(9)
        args[3].fill_(1)
        args[4].fill_(200)
        prog = store.program("prefill_row", args, bucket=2, tokens=lb)
        with torch.inference_mode():
            logits = prog.fn(*args)[0].clone()
        torch.cuda.synchronize()
        outs.append((logits, cache["k"][:, 1, 136:200].clone(),
                     int(cache["valid_from"][1])))
    (a, ka, va), (b, kb, vb) = outs
    assert torch.equal(a, b) and torch.equal(ka, kb) and va == vb == 145


def test_graphed_serve_queue_bit_equal_to_eager(dev):
    """A ragged queue from a 2-slot pool (later requests join a running
    batch) through the captured cells and through an eager store: the
    same tokens, the same launches, nothing captured by traffic."""
    from collections import Counter

    import numpy as np

    from repro_torch.serve.programs import ProgramStore
    from repro_torch.serve.scheduler import Request
    eng, cfg = _graph_engine(dev, "qwen1_5_4b")
    rows = eng.precompile()
    loaded = eng.programs.stats()
    rng = np.random.default_rng(7)
    spec = [(5, 4), (12, 2), (40, 6), (9, 3), (3, 5), (100, 2)]

    def queue():
        return [Request(tokens=rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=m, rid=i)
                for i, (n, m) in enumerate(spec)]

    reqs = queue()
    runs = []
    for store in (ProgramStore(eng.model, device=dev, capture=False),
                  eng.programs):
        eng.programs, prev = store, eng.programs
        before = Counter(cuda.launches), Counter(cuda.design_launches)
        try:
            results, stats = eng.serve_queue(reqs)
        finally:
            eng.programs = prev
        torch.cuda.synchronize()
        runs.append((results, stats, Counter(cuda.launches) - before[0],
                     Counter(cuda.design_launches) - before[1]))
    (want, wstats, wl, wd), (got, gstats, gl, gd) = runs
    for a, b in zip(got, want):
        assert a.tokens.tolist() == b.tokens.tolist() and a.completed
        assert (a.admitted_at, a.finished_at) == (b.admitted_at, b.finished_at)
    assert max(r.admitted_at for r in got) > min(r.admitted_at for r in got)
    assert gl == wl and gd == wd and gl["tsmm_skinny_a"] > 0
    assert gstats.compile_s == 0.0
    st = eng.programs.stats()
    assert st["captured"] == loaded["captured"] == len(rows)


def test_launcher_queue_precompiled_captures_nothing_on_traffic(dev, tmp_path):
    """``launch/serve.py --queue --precompile`` on the card: the ragged
    trace runs through the slot pool on cells captured at load."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"),
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans.json"),
               REPRO_TORCH_MEASURE_CACHE=str(tmp_path / "meas.json"),
               REPRO_TORCH_MISS_LOG=str(tmp_path / "misses.json"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1_5_4b", "--reduced", "--override",
         "d_model=512,d_ff=1024,num_heads=4,num_kv_heads=4,head_dim=128",
         "--trace", "2:9,3:30,1:5", "--max-batch", "4", "--steps", "4",
         "--queue", "--precompile"], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "-- scheduler telemetry --" in out.stdout
    assert "0 acquired cold by traffic" in out.stdout


# ---------------------------------------------------------------------------
# the MoE family at its published widths: the card against the CPU
# ---------------------------------------------------------------------------

# OLMoE-1B-7B's MoE layer whole; DeepSeek-V2's at its widths (d 5120,
# expert width 1536, top-6, 2 shared) with 16 routed experts (its 160
# fp32 experts are 15 GB on the host)
MOE_WIDTHS = {"olmoe_1b_7b": {}, "deepseek_v2_236b": {"num_experts": 16}}


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("arch", sorted(MOE_WIDTHS))
def test_moe_apply_on_the_card_matches_the_cpu(dev, arch, factor):
    """fp32 ``moe_apply`` on 2 x 64 tokens, with drops (1.25) and
    drop-free (8): the same output as the CPU's within 1e-4 (the GEMMs'
    sums in another order) and the same aux; the routing runs on the
    card (sort, searchsorted, gather), nothing reads the host."""
    import dataclasses

    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              **MOE_WIDTHS[arch])
    p, _ = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = 0.5 * torch.randn((2, 64, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_apply(p, cfg, x, capacity_factor=factor)
    got, aux = moe.moe_apply({k: v.to(dev) for k, v in p.items()}, cfg,
                             x.to(dev), capacity_factor=factor)
    _close(got.cpu(), want, torch.float32)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("arch", sorted(MOE_WIDTHS))
def test_moe_apply_captured_replays_bit_equal(dev, arch):
    """bf16 ``moe_apply`` on the card, where a scatter-add combine would
    add with atomics: two eager calls give the same bits (the combine
    sums each token's contributions in one order), and so does every
    replay of the call captured in a CUDA graph (topk, the stable
    argsort, searchsorted and the sort-inverting combine inside it), on
    new inputs too."""
    import dataclasses

    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(arch), **MOE_WIDTHS[arch])
    p, _ = moe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((4, 1, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        moe.moe_apply(p, cfg, x)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, aux = moe.moe_apply(p, cfg, x)
    for _ in range(3):
        want, want_aux = moe.moe_apply(p, cfg, x)
        again, again_aux = moe.moe_apply(p, cfg, x)
        assert torch.equal(again, want) and torch.equal(again_aux, want_aux)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(aux, want_aux)
        x.copy_(torch.randn(x.shape, generator=g, device=dev))


def test_mla_at_deepseek_widths_on_the_card_matches_the_cpu(dev):
    """DeepSeek-V2's MLA at its published widths (128 heads, ranks 1536 /
    512), fp32: a 64-token prefill (the chunked body: Q/K 192 wide, V
    128) and one absorbed decode step against the CPU's."""
    import dataclasses

    from repro_torch.models import attention as A
    cfg = dataclasses.replace(get_config("deepseek_v2_236b"),
                              dtype="float32")
    p, _ = A.init_mla(torch.Generator().manual_seed(0), cfg)
    pd = {k: v.to(dev) for k, v in p.items()}
    x = 0.1 * torch.randn((1, 64, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    before = cuda.launches["flash_attention"]
    want, (c, kr) = A.mla_forward(p, cfg, x)
    got, (tc, tkr) = A.mla_forward(pd, cfg, x.to(dev))
    assert cuda.launches["flash_attention"] == before
    _close(got.cpu(), want, torch.float32)
    _close(tc.cpu(), c, torch.float32)
    caches = []
    for device, params, c_, kr_ in (("cpu", p, c, kr), (dev, pd, tc, tkr)):
        cache_c = torch.zeros((1, 72, cfg.kv_lora_rank), device=device)
        cache_kr = torch.zeros((1, 72, cfg.rope_head_dim), device=device)
        cache_c[:, :64] = c_
        cache_kr[:, :64] = kr_
        pos = torch.tensor(64, dtype=torch.int32, device=device)
        step = A.mla_decode(params, cfg, x[:, -1:].to(device), cache_c,
                            cache_kr, pos, pos.reshape(1).long())
        caches.append((step.cpu(), cache_c.cpu()))
    _close(caches[1][0], caches[0][0], torch.float32)
    _close(caches[1][1], caches[0][1], torch.float32)


@pytest.mark.parametrize("arch", sorted(MOE_WIDTHS))
def test_moe_family_graphed_cells_bit_equal_to_eager(dev, arch):
    """A 2-layer model of the MoE family at its widths (DeepSeek-V2: the
    dense first layer and one MoE layer of 16 experts), bf16: its grid
    captured, a group served graphed bit-equal to an eager store, equal
    launch counts."""
    import dataclasses

    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.programs import ProgramStore, check_cells
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              **MOE_WIDTHS[arch])
    model = build_model(cfg)
    params, axes = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, axes, max_len=256 + 16, max_batch=2,
                 max_prompt=256, device=dev)
    rows = eng.precompile()
    assert all(c["equal"] for c in check_cells(eng.programs))
    eager = ProgramStore(eng.model, device=dev, capture=False)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                     generator=torch.Generator().manual_seed(3),
                                     dtype=torch.int32)}
    want, wl, wd = _serve(eng, eager, batch, 6)
    got, gl, gd = _serve(eng, eng.programs, batch, 6)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits_last, want.logits_last)
    assert gl == wl and gd == wd and gl["tsmm_skinny_a"] > 0
    assert (gl["flash_attention"] > 0) == (not cfg.use_mla)
    assert eng.programs.stats()["captured"] == len(rows)


# ---------------------------------------------------------------------------
# the SSM family and flash at Zamba2's head dim


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [256, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_d80_matches_plain(dev, dtype, s, causal):
    """Flash at D = 80 (Zamba2-2.7B's shared block): bf16 through the
    wgmma design (the 128-wide tiles, columns past 80 zero-filled), fp32
    through the SIMT kernel, both against the plain version."""
    h = 8
    g = torch.Generator(device=dev).manual_seed(s + causal)
    q, k, v = (torch.randn((1, s, h, 80), generator=g, device=dev).to(dtype)
               for _ in range(3))
    got, designs = _designs(lambda: flash_attention(q, k, v, causal=causal))
    assert designs == {"flash_wgmma" if dtype == torch.bfloat16
                       else "flash_simt": 1}
    _close(got, _torch_attention(q, k, v, causal=causal), dtype)


def test_mamba2_captured_decode_replays_like_two_eager_steps(dev):
    """Mamba2-780m at full width (2 layers), bf16: its captured decode
    cell replayed twice from one state gives the same logits and the same
    recurrent state, bit for bit, as two eager steps from that state (the
    step writes its state into the cache's slabs in place)."""
    from repro_torch.core.linear import serving_ctx
    from repro_torch.serve.programs import recurrent_state, restore
    eng, cfg = _graph_engine(dev, "mamba2_780m")
    rows = eng.precompile()
    assert {r["kind"] for r in rows} == {"prefill", "decode"}
    store, b, width = eng.programs, 2, 64
    cache, tok = store.static_cache(b, eng.max_len), store.static_tokens(b)
    cell = store.static_batch({"tokens": torch.zeros((b, width),
                                                     dtype=torch.int32)})
    cell["tokens"].copy_(torch.randint(0, cfg.vocab_size, (b, width),
                                       generator=torch.Generator()
                                       .manual_seed(4), dtype=torch.int32))
    with torch.inference_mode(), serving_ctx():
        pprog = store.program("prefill", (eng.params, cell, cache), bucket=b,
                              tokens=width)
        logits, _ = pprog.fn(eng.params, cell, cache)
        tok.copy_(logits[:, -1].argmax(-1, keepdim=True))
        dprog = store.program("decode", (eng.params, cache, tok), bucket=b,
                              tokens=1)
        assert not dprog.cold and dprog.source == "memory"
        start = recurrent_state(cache)
        want = [eng.model.decode_step(eng.params, cache, tok)[0].clone()
                for _ in range(2)]
        want_state = recurrent_state(cache)
        restore(cache, start)
        got = [dprog.fn(eng.params, cache, tok)[0].clone() for _ in range(2)]
        torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert not torch.equal(got[0], got[1])       # the state moved on
    state = recurrent_state(cache)
    assert all(torch.equal(state[k], want_state[k]) for k in want_state)
    assert int(state["pos"]) == width + 2


@pytest.mark.parametrize("arch,layers", [("mamba2_780m", 2),
                                         ("zamba2_2_7b", 12)])
def test_ssm_family_graphed_cells_bit_equal_to_eager(dev, arch, layers):
    """Mamba2-780m (2 layers) and Zamba2-2.7B (12 layers: two groups, the
    shared block over two K/V caches) at full width, bf16: the grid
    (prefill and decode cells only) captured and checked cell by cell, a
    2 x 256 group served graphed bit-equal to an eager store with equal
    launch counts, no pack launch, flash only in the hybrid."""
    from repro_torch.serve.programs import ProgramStore, check_cells
    eng, cfg = _graph_engine(dev, arch, layers=layers)
    rows = eng.precompile()
    assert len(rows) == 2 * (1 + len(eng.grid.length))
    assert all(c["equal"] for c in check_cells(eng.programs))
    eager = ProgramStore(eng.model, device=dev, capture=False)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                     generator=torch.Generator().manual_seed(3),
                                     dtype=torch.int32)}
    want, wl, wd = _serve(eng, eager, batch, 6)
    got, gl, gd = _serve(eng, eng.programs, batch, 6)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits_last, want.logits_last)
    assert gl == wl and gd == wd and gl["tsmm_skinny_a"] > 0
    assert gl["pack_blocks"] == 0
    assert (gl["flash_attention"] > 0) == (cfg.family == "hybrid")
    assert eng.programs.stats()["captured"] == len(rows)


def test_pack_past_2_31_bytes_bit_equal(dev):
    """The paper's A, 25600 x 25600 fp32 (2.62 GB: 655 M elements, past
    2^31 bytes), packed into 256 x 256 blocks by the TMA design: bit-equal
    to ``pack_ref`` and unpacked back bit for bit."""
    g = torch.Generator(device=dev).manual_seed(21)
    m = k = 25600
    a = torch.randn((m, k), generator=g, device=dev)
    assert a.numel() * a.element_size() > 2 ** 31
    got, ran = _designs(lambda: ops.pack_blocks(a, 256, 256))
    assert ran == {"pack_tma": 1}
    assert torch.equal(got, ref.pack_ref(a, 256, 256))
    assert torch.equal(ref.unpack_ref(got, m, k), a)


@pytest.mark.parametrize("n", [4, 240])
def test_paper_planned_row_at_full_size(dev, n):
    """The paper tool's planned row at ``PAPER_WORKLOAD``'s shape: the
    pack-once tournament's plan, A packed once, the fp32 tall design of its
    N (``f32`` at 4, ``tf32x3`` at 240) replayed, held to ``torch.matmul``
    (TF32 off) within the K-scaled fp32 tolerance."""
    from repro_torch.launch import prepack_vs_conventional as pvc
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(n)
    m = k = 25600
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((k, n), generator=g, device=dev)
    plan = pvc.plan_packed_once(m, k, n, dev, top_k=2, iters=2)
    assert plan.prepack and plan.chosen_by == "measured"
    (seconds, out), ran = _designs(lambda: pvc.replay(plan, a, b, 2, dev))
    assert seconds > 0 and out.shape == (m, n)
    tall = {"tall_f32" if n < tsmm.TALL_F32_CROSSOVER else "tall_tf32x3"}
    assert set(ran) - {"pack_tma", "pack_vec"} == tall
    pvc.check_planned(out, torch.matmul(a, b), k)


def test_pack_once_timing_leaves_the_pack_out(dev):
    """The evaluator under ``pack_once`` times a packed tall plan without
    its pack: faster than the per-call placement serving pays."""
    from repro_torch.core.evaluator import measure_plan
    from repro_torch.core.plan import Plan, Problem
    from repro_torch.core.registry import Registry
    plan = Plan(Problem(16384, 1024, 128, "float32"), "tall_a", 256, 1024,
                128, prepack=True)
    reg = Registry()
    once = measure_plan(plan, dev, reg=reg, pack_once=True)
    per_call = measure_plan(plan, dev, reg=reg)
    assert once.seconds < per_call.seconds


# the kernel ladder (core/tsmm.py) on the card: rung 2 is the plain
# version on the same CUDA tensors, and no kernel launches for it
LADDER_RUNG2 = {"kernels.lower.skinny": "raise", "kernels.lower.tall": "raise"}


@pytest.mark.parametrize("m,k,n,layout", [
    (2048, 512, 16, "natural"),          # the planned tall-A path
    (2048, 512, 16, "packed_w"),         # skinny-A on a PackedTensor
    (2, 2560, 6912, "packed_w"),         # a decode step's projection
])
def test_ladder_rung2_on_the_card(dev, m, k, n, layout):
    from repro_torch.core import packing, registry
    from repro_torch.core.tsmm import tsmm_dot
    from repro_torch.resilience import degrade, failpoints
    # each case plans on an empty registry (a packed weight would
    # otherwise peek the natural case's tall plan for the same problem)
    registry.clear_memory()
    g = torch.Generator(device=dev).manual_seed(m + n)
    a = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    b = packing.pack(w, 128, 128) if layout == "packed_w" else w
    before = sum(cuda.launches.values())
    healthy = tsmm_dot(a, b)
    assert sum(cuda.launches.values()) > before      # rung 1: the kernel
    stats = degrade.DegradeStats()
    failpoints.reset()
    failpoints.configure(LADDER_RUNG2)
    try:
        before = sum(cuda.launches.values())
        with degrade.use(stats):
            degraded = tsmm_dot(a, b)
        torch.cuda.synchronize()
        launched = sum(cuda.launches.values()) - before
    finally:
        failpoints.reset()
    assert launched == 0
    assert stats.counts == {"kernel.variant": 1}
    _close(degraded, healthy, torch.float32)
    _close(degraded, a @ w, torch.float32)


def test_train_step_on_the_card_matches_the_cpu_without_kernels(dev):
    """One fp32 train step of a 2-layer qwen whose attention the flash
    kernel would take at inference (head dim 128, 256 tokens): card
    against CPU from the same params and batch.  No hand-written kernel
    launches (flash has no backward; the TSMM kernels serve only), and
    every gradient (through the first moment, 0.1 x the clipped
    gradient) is finite, nonzero and within 1e-4 of the leaf's largest
    value + 1e-4 relative of the CPU's."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config("qwen1_5_4b").reduced(
        d_model=512, num_heads=4, num_kv_heads=4, head_dim=128, d_ff=1024,
        vocab_size=1024, dtype="float32")
    model = build_model(cfg)
    ocfg = OptConfig()
    state = init_train_state(model, ocfg,
                             generator=torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(dev), state)
    data = SyntheticData(cfg, ShapeSpec("t", 256, 1, "train"), seed=1,
                         device="cpu")
    batch = data.batch(0)
    step = make_train_step(model, ocfg)
    state, m_cpu = step(state, batch)
    cuda.reset_launches()
    gpu, m_gpu = step(gpu, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert sum(cuda.launches.values()) == 0, dict(cuda.launches)
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= 1e-4
    for a, b in zip(tree_leaves(gpu["opt"]["m"]),
                    tree_leaves(state["opt"]["m"])):
        a = a.cpu()
        assert bool(torch.isfinite(a).all()) and bool(a.abs().max() > 0)
        bound = 1e-4 * float(b.abs().max()) + 1e-4 * b.abs()
        assert bool(((a - b).abs() <= bound).all())
