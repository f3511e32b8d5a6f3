"""TSMM kernels: the wrappers of the CUDA kernels ``csrc/tsmm_skinny.cu``,
``csrc/tsmm_tall.cu`` and ``csrc/pack_blocks.cu``, their launch plans and
their plain PyTorch versions.

Ports of the reference's Pallas kernels of the same names
(``kernels/tsmm.py`` there), with the reference's signatures:

* ``tsmm_skinny_a`` — act(X @ unpack(Wp) + bias), skinny X, packed W;
* ``tsmm_tall_a``   — act(A @ B + bias), tall natural A, skinny B;
* ``tsmm_packed_a`` — the same on a block-major packed A;
* ``pack_blocks_kernel`` — the block-major re-tile with alpha folded.

All accumulate in fp32 and cast once.  ``kernels/gen.py`` drives the
skinny and tall CUDA kernels in their other modes for the non-baseline
grammar points.  The TPU grid schedule's ``dims`` (dimension semantics)
and ``m_split`` (a leading parallel row-panel axis) are accepted and have
no effect on the card: a CUDA grid has no dimension semantics and already
spreads the row tiles over every SM.

A wrapper launches the kernel for a CUDA tensor and takes the plain
version for a tensor on the CPU; there is no fallback between them.
Only ``core/tsmm.py``'s ladder asks otherwise: ``impl="torch"`` runs the
plain version on any device, its rung 2 once a caller has armed a fault
on the planned rung.  A layout that the host-side launch plan
(:func:`skinny_plan`, :func:`tall_plan`, :func:`pack_plan`) or the TMA
check (:func:`check_tma`) refuses raises :class:`LaunchRefused`, before
anything reaches the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import act_ref, pack_ref

_ACT = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

class LaunchRefused(ValueError):
    """A launch plan or the TMA check refused the layout on the host:
    nothing was enqueued."""


def plain(t, impl, name: str) -> bool:
    """Whether a wrapper runs the plain version for tensor ``t``: with
    ``impl="torch"`` yes, with ``impl`` None by ``t``'s device (the CPU:
    yes; the card: no, the kernel launches)."""
    if impl == "torch":
        return True
    if impl is not None:
        raise ValueError(f"{name}: unknown impl {impl!r} (None | 'torch')")
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


# kernel output modes (csrc/tsmm_skinny.cu, csrc/tsmm_tall.cu): the cast
# epilogue, raw fp32 sums one slab per k-split, and (tall only)
# accumulate-into an fp32 output
EPILOGUE, RAW_F32, ACCUM_F32 = 0, 1, 2


def _torch_skinny(x, w, bias, act, *, natural: bool, splits: int, mode: int):
    """Plain version of the CUDA kernel: the blocked einsum over the packed
    (or natural) weight with fp32 accumulation, the k range cut into
    ``splits`` partial sums.  Mode ``RAW_F32`` returns the fp32 partials
    (splits, m, N); mode ``EPILOGUE`` applies bias and the activation to
    the fp32 sum and casts once."""
    m, k = x.shape
    xf = x.float()
    if natural:
        n = w.shape[1]
        parts = torch.einsum("msk,skn->smn", xf.reshape(m, splits, k // splits),
                             w.float().reshape(splits, k // splits, n))
    else:
        nk, nn, bk, bn = w.shape
        nki = nk // splits
        parts = torch.einsum("msjb,sjnbc->smnc", xf.reshape(m, splits, nki, bk),
                             w.float().reshape(splits, nki, nn, bk, bn)
                             ).reshape(splits, m, nn * bn)
    if mode == RAW_F32:
        return parts
    out = parts.sum(0)
    if bias is not None:
        out = out + bias.float()[None, :]
    return act_ref(out, act).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (the launch plans' CTA
    target), read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# the bf16 skinny kernel's designs (csrc/tsmm_skinny.cu): at most
# SKINNY_STREAM_M rows stream W (one 8-row wgmma N), more rows run the
# wgmma GEMM; 128-column tiles and 64-deep ring stages for both.  The
# wgmma ring is 3 stages deep, so two 128-row CTAs (or three 64-row ones)
# share an SM; the stream ring 4 (~68 KB in flight per CTA).  The stream
# design splits a tile's k range over a cluster of at most 8 CTAs (the
# portable limit), each keeping at least SKINNY_MIN_RANK_STAGES stages.
SKINNY_STREAM_M, SKINNY_NT, SKINNY_BK = 8, 128, 64
SKINNY_WGMMA_STAGES, SKINNY_STREAM_STAGES = 3, 4
SKINNY_MAX_CLUSTER, SKINNY_MIN_RANK_STAGES = 8, 10

# the fp32 skinny kernel's designs (csrc/tsmm_skinny.cu), both on 32-deep
# stages (SKINNY_FBK: one 128-byte swizzle row of fp32) with the k range
# split over a cluster as the bf16 stream's: at most SKINNY_F32_CROSSOVER
# rows run ``f32``, the TMA-fed FMA stream (bound by W's bytes), on
# column tiles of SKINNY_F32_NT, a power of two of rows (at least 8, and
# one a consumer thread row: 512 / nt), rings of SKINNY_F32_STAGES, each
# rank at least SKINNY_F32_MIN_RANK_STAGES stages; more rows run
# ``tf32x3`` (3xTF32 on wgmma, bound by the FMA rate) on row tiles of at
# most SKINNY_X3_ROWS and 128 or 64 W columns, each rank at least
# SKINNY_X3_MIN_RANK_STAGES stages, its ring as deep as shared memory
# allows, up to SKINNY_X3_STAGES.  The crossover and the rules are
# launch/skinny_sweep.py --dtype float32's (PERF.md §6).
SKINNY_F32_CROSSOVER = 16
SKINNY_FBK, SKINNY_F32_NT = 32, (128, 64, 32)
SKINNY_F32_STAGES, SKINNY_F32_MIN_RANK_STAGES = 4, 8
# the share of the SMs a column tile's 8-CTA clusters must reach for
# ``f32`` to take it over a narrower one
SKINNY_F32_FILL = 7 / 8
SKINNY_X3_ROWS, SKINNY_X3_NT, SKINNY_X3_STAGES = 128, (128, 64), 4
SKINNY_X3_MIN_RANK_STAGES = 8
# the share of the SMs a tf32x3 launch's clusters grow to: one CTA of two
# consumer warpgroups on half the SMs measured faster than on all
SKINNY_X3_FILL = 0.45
SKINNY_SMEM_MAX = 232448          # opt-in shared memory of one CTA
_SKINNY_DESIGN = {"f32": 0, "wgmma": 1, "stream": 2, "tf32x3": 3}


@dataclasses.dataclass(frozen=True)
class SkinnyPlan:
    """How ``csrc/tsmm_skinny.cu`` runs one launch: ``design`` (bf16:
    ``wgmma`` or ``stream``; fp32: ``f32`` or ``tf32x3``), the CTA row
    tile ``bm`` (the rows a CTA covers, m padded to it) and column tile
    ``nt`` (tf32x3: W columns), the ``cluster`` of CTAs that split each
    tile's k range (stream, f32, tf32x3) and the ring ``stages``.  The
    grid is
    ceil(m / bm) x n / nt x splits x cluster CTAs."""
    design: str
    bm: int
    nt: int
    cluster: int
    stages: int


def _cluster(base: int, ktiles: int, min_stages: int, sms: float) -> int:
    """The smallest cluster (1, 2, 4, 8) that launches at least ``sms``
    CTAs over ``base`` tiles, as long as each rank of ``ktiles`` stages
    keeps at least ``min_stages``."""
    cluster = 1
    while (cluster < SKINNY_MAX_CLUSTER and base * cluster < sms
           and ktiles >= 2 * cluster * min_stages):
        cluster *= 2
    return cluster


def _fp32_skinny_plan(m: int, n: int, *, natural: bool, bn: int,
                      splits: int, kps: int, sms: int) -> SkinnyPlan:
    """The fp32 branch of :func:`skinny_plan` (its layout checks passed)."""
    fits = [t for t in SKINNY_F32_NT if n % t == 0 and (natural or bn % t == 0)]
    if m <= SKINNY_F32_CROSSOVER:
        # the widest tile whose 8-CTA clusters fill the card to
        # SKINNY_F32_FILL, else the narrowest
        bm = max(8, 1 << (m - 1).bit_length())
        nt = next((t for t in fits if (n // t) * splits * SKINNY_MAX_CLUSTER
                   >= SKINNY_F32_FILL * sms), fits[-1])
        cluster = _cluster((n // nt) * splits, kps // SKINNY_FBK,
                           SKINNY_F32_MIN_RANK_STAGES, sms)
        return SkinnyPlan("f32", max(bm, 512 // nt), nt, cluster,
                          SKINNY_F32_STAGES)
    tiles = -(-m // SKINNY_X3_ROWS)
    bm = -(-m // (8 * tiles)) * 8
    nt = next(t for t in SKINNY_X3_NT if t in fits)
    cluster = _cluster(tiles * (n // nt) * splits, kps // SKINNY_FBK,
                       SKINNY_X3_MIN_RANK_STAGES, SKINNY_X3_FILL * sms)
    stages = next(s for s in range(SKINNY_X3_STAGES, 1, -1)
                  if skinny_smem(SkinnyPlan("tf32x3", bm, nt, cluster, s))
                  <= SKINNY_SMEM_MAX)
    return SkinnyPlan("tf32x3", bm, nt, cluster, stages)


@functools.lru_cache(maxsize=1024)
def skinny_plan(m: int, k: int, n: int, *, dtype, natural: bool, bk: int,
                bn: int, mode: int, splits: int, kps: int,
                sms: int) -> SkinnyPlan:
    """The launch plan of the skinny kernel for X (m, k) times W (k, n),
    natural or packed at (bk, bn), ``splits`` k ranges of ``kps`` each, on
    a card of ``sms`` SMs.  Pure: the CPU tests reach it.

    bf16, m <= ``SKINNY_STREAM_M`` (decode, bound by W's bytes): the
    stream design on 128-column tiles; the smallest cluster (1, 2, 4, 8)
    that gives every SM a CTA, as long as each CTA keeps at least
    ``SKINNY_MIN_RANK_STAGES`` 64-deep stages (160 KB of W) to amortise
    its fixed cost.  bf16, larger m (prefill, bound by operations): the
    wgmma design, 128 x 128 tiles of two consumer warpgroups when they
    give every SM two CTAs, else 64 x 128 tiles of one (three CTAs an
    SM).  ``launch/skinny_sweep.py`` times every plan these rules choose
    from; the rules were set from its measurements at qwen1.5-4b's and
    GLM-4-9B's projections (PERF.md §6), not from a table of shapes.

    fp32, m <= ``SKINNY_F32_CROSSOVER`` (bound by W's bytes): ``f32``, the
    widest column tile of 128, 64, 32 that divides N (and a packed bn)
    and whose 8-CTA clusters reach ``SKINNY_F32_FILL`` of the SMs, else
    the narrowest; the rows m rounded up to a power of two (at least 8
    and 512 / nt: one a consumer thread row); the cluster by the stream
    design's rule (each rank at least ``SKINNY_F32_MIN_RANK_STAGES``
    32-deep stages); a ring of ``SKINNY_F32_STAGES``.  fp32, more rows
    (bound by the FMA rate): ``tf32x3``, X's rows in the fewest equal
    tiles of at most ``SKINNY_X3_ROWS`` (a multiple of 8: a wide tile
    amortises the fixed cost of a stage), 128 W columns where they divide
    N (and a packed bn), else 64; the smallest cluster that gives
    ``SKINNY_X3_FILL`` of the SMs a CTA (each rank at least
    ``SKINNY_X3_MIN_RANK_STAGES`` stages); the deepest ring of up to
    ``SKINNY_X3_STAGES`` that fits.  ``launch/skinny_sweep.py --dtype
    float32`` times every plan of both designs; the rules follow its
    measurements at the gate's and qwen1.5-4b's widths (PERF.md §6).

    Raises LaunchRefused on a layout no design takes (there is no other
    path): a k range off the stage (bf16 64 deep, fp32 32), packed blocks
    the tile would cut, N off the column tile (bf16 128, fp32 a multiple
    of 64)."""
    if m <= 0 or n <= 0 or splits <= 0 or kps <= 0 or kps * splits != k:
        raise LaunchRefused(f"skinny plan: ({m}, {k}, {n}) in {splits} splits "
                            f"of {kps}")
    if splits > 1 and mode != RAW_F32:
        raise LaunchRefused(f"skinny plan: {splits} splits in mode {mode}")
    if dtype == torch.bfloat16:
        if n % SKINNY_NT:
            raise LaunchRefused(f"skinny plan: N={n} is not a multiple of the "
                                f"{SKINNY_NT}-column tile")
        if kps % SKINNY_BK:
            raise LaunchRefused(f"skinny plan: a k range of {kps} is not a "
                                f"multiple of the {SKINNY_BK}-deep stage")
        if not natural and (bk % SKINNY_BK or bn % SKINNY_NT):
            raise LaunchRefused(f"skinny plan: packed blocks ({bk}, {bn}) are "
                                f"cut by the tile ({SKINNY_BK}, {SKINNY_NT})")
        if m <= SKINNY_STREAM_M:
            cluster = _cluster((n // SKINNY_NT) * splits, kps // SKINNY_BK,
                               SKINNY_MIN_RANK_STAGES, sms)
            return SkinnyPlan("stream", SKINNY_STREAM_M, SKINNY_NT, cluster,
                              SKINNY_STREAM_STAGES)
        tiles = -(-m // 128) * (n // SKINNY_NT) * splits
        return SkinnyPlan("wgmma", 128 if tiles >= 2 * sms else 64, SKINNY_NT,
                          1, SKINNY_WGMMA_STAGES)
    if dtype != torch.float32:
        raise TypeError(f"skinny plan: dtype {dtype} not supported")
    if n % 64:
        raise LaunchRefused(f"skinny plan: N={n} is not a multiple of 64")
    if kps % SKINNY_FBK:
        raise LaunchRefused(f"skinny plan: a k range of {kps} is not a "
                            f"multiple of the {SKINNY_FBK}-deep fp32 stage")
    if not natural and (bk % SKINNY_FBK or bn % 64):
        raise LaunchRefused(f"skinny plan: packed blocks ({bk}, {bn}) are cut "
                            f"by the fp32 tiles ({SKINNY_FBK}, 64)")
    return _fp32_skinny_plan(m, n, natural=natural, bn=bn, splits=splits,
                             kps=kps, sms=sms)


def skinny_smem(plan: SkinnyPlan) -> int:
    """Shared memory of one CTA of ``plan``, as ``csrc/tsmm_skinny.cu`` lays
    it out: 1 KB of alignment slack, then the ring's stages and an
    mbarrier pair per stage.  A stage: bf16, the X rows x 64 k and 64 k x
    128 W columns; f32, X's bm rows and W's nt columns x 32 k; tf32x3,
    W's nt columns and X big and small's bm rows x 32 k (fp32)."""
    if plan.design == "f32":
        stage = (plan.bm + plan.nt) * SKINNY_FBK * 4
    elif plan.design == "tf32x3":
        stage = (plan.nt + 2 * plan.bm) * SKINNY_FBK * 4
    else:
        stage = plan.bm * SKINNY_BK * 2 + SKINNY_BK * SKINNY_NT * 2
    return 1024 + plan.stages * (stage + 16)


def launch_skinny(name: str, x, w, bias, act, *, natural: bool, splits: int,
                  mode: int, bk: int = 0, bn: int = 0, impl=None):
    """Run the skinny-A function on ``x``'s device: the CUDA kernel for a
    CUDA tensor (counted under ``name``), the plain version on the CPU.

    ``x`` (m, K) contiguous; ``w`` packed (nk, nn, bk, bn) or, with
    ``natural``, (K, N) with N a multiple of ``bn``; ``bias`` (N,) or None.
    :func:`skinny_plan` picks the design (bf16: ``wgmma`` above
    ``SKINNY_STREAM_M`` rows, ``stream`` at or below; fp32: ``tf32x3``
    above ``SKINNY_F32_CROSSOVER`` rows, ``f32`` at or below) and its
    launch configuration; a layout no design takes (:func:`skinny_plan`,
    :func:`check_tma`) raises.  ``tf32x3`` also gets the scratch its
    split pass writes X big and small to.
    Returns (m, N) in ``x``'s type, or (splits, m, N) fp32 for
    ``RAW_F32``.  ``impl``: see the module docstring."""
    if plain(x, impl, name):
        return _torch_skinny(x, w, bias, act, natural=natural, splits=splits,
                             mode=mode)
    if x.dtype not in _DTYPE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if act not in _ACT:
        raise ValueError(f"{name}: unknown activation {act!r}")
    for t, what in ((w, "weight"), (bias, "bias")):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}, "
                            f"input is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: input must be a contiguous (m, K) matrix")
    m, k = x.shape
    if natural:
        if w.dim() != 2 or w.shape[0] != k or w.shape[1] % bn:
            raise ValueError(f"{name}: natural weight {tuple(w.shape)} does "
                             f"not match input {tuple(x.shape)} / bn={bn}")
        n = w.shape[1]
    else:
        if w.dim() != 4 or w.shape[0] * w.shape[2] != k:
            raise ValueError(f"{name}: packed weight {tuple(w.shape)} does "
                             f"not match input {tuple(x.shape)}")
        _, nn, bk, bn = w.shape
        n = nn * bn
    if bn % 64 or (k // bk) % splits or k % bk:
        raise ValueError(f"{name}: blocks ({bk}, {bn}) / splits {splits} "
                         f"do not tile K={k}, N={n}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({n},)")
    plan = skinny_plan(m, k, n, dtype=x.dtype, natural=natural, bk=bk, bn=bn,
                       mode=mode, splits=splits, kps=k // splits,
                       sms=_sm_count(x.device.index))
    check_tma(x, name, "X")
    check_tma(w, name, "W")
    out = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
           if mode == RAW_F32 else
           torch.empty((m, n), dtype=x.dtype, device=x.device))
    # tf32x3: X big and small over the row tiles, written by its split pass
    scratch = (torch.empty((2, -(-m // plan.bm) * plan.bm, k),
                           dtype=torch.float32, device=x.device)
               if plan.design == "tf32x3" else None)
    lib = cuda.load()["tsmm_skinny"]
    rc = lib.tsmm_skinny_launch(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), m,
        k, n, k, bk, bn, int(natural), splits, mode,
        _ACT[act], _DTYPE[x.dtype], _SKINNY_DESIGN[plan.design], plan.bm,
        plan.nt, plan.cluster, plan.stages,
        cuda.stream(x.device))
    cuda.check(rc, name)
    fused = mode == EPILOGUE and act not in (None, "none")
    cuda.count(name, f"skinny_{plan.design}",
               (("bias_" if bias is not None else "") + act) if fused
               else None)
    return out


def tsmm_skinny_a(x, wp, bias=None, *, act=None, impl=None):
    """C = act(X @ unpack(Wp) + bias).

    X (m, K) with skinny m (the decode batch, or the prefill tokens);
    Wp (nk, nn, bk, bn) packed weights with K == nk * bk; bias (nn*bn,).
    Returns (m, nn*bn) in X's type."""
    return launch_skinny("tsmm_skinny_a", x, wp, bias, act, natural=False,
                         splits=1, mode=EPILOGUE, impl=impl)


# the bf16 wgmma tall kernel's tile: 64 x 128 (one wgmma m64n128k16
# warpgroup) and 64-deep ring stages (one 128-byte swizzle row of bf16);
# 4 stages (99 KB, so two CTAs share an SM), 3 with clusters of 4 or
# more; clusters of at most 8 (the portable limit).  The ring's layout and
# the shared memory it takes are ``csrc/tsmm_tall.cu``'s, which refuses a
# ring that does not fit.
TALL_BM, TALL_NT, TALL_BK, TALL_STAGES, TALL_MAX_CLUSTER = 64, 128, 64, 4, 8

# the fp32 tall designs (``csrc/tsmm_tall.cu``): N (padded to 8) below
# TALL_F32_CROSSOVER runs ``f32``, FMA tiles of TALL_F32_NT columns fed by
# a TMA ring of TALL_F32_STAGES stages (the byte-bound side); at or above
# it ``tf32x3``, 3xTF32 on wgmma over a column tile of up to TALL_X3_NT
# (two sets of fp32 sums a thread cap it: the side bound by the FMA
# rate), its ring as deep as shared memory allows, up to TALL_X3_STAGES.  Both take 32-deep k stages (TALL_FBK: one
# 128-byte swizzle row of fp32) and row tiles of 128 or 64.  The crossover
# is launch/tall_sweep.py --dtype float32's at the paper's shape (A 25600 x
# 25600; PERF.md §6).
TALL_F32_CROSSOVER = 32
TALL_FBK, TALL_F32_NT, TALL_F32_STAGES = 32, (8, 16, 32, 64), 4
TALL_X3_NT, TALL_X3_STAGES = 128, 4
# a tf32x3 CTA's fixed cost a stage, in columns of its tile's work: a row
# tile's k loop took 0.604 ms at 64 columns and 1.002 at 128 at the
# paper's shape (launch/tall_sweep.py --dtype float32), ~33 columns at 0
TALL_X3_TILE_COST = 32
TALL_SMEM_MAX = 232448            # opt-in shared memory of one CTA
_TALL_DESIGN = {"wgmma": 0, "f32": 1, "tf32x3": 2}


def tall_width(n: int, dtype) -> int:
    """The width a tall B (and its output and bias) is padded to: bf16, a
    multiple of the wgmma design's 128-column tile; fp32, a multiple of 8
    (both fp32 designs mask the columns of their last tile, so N is never
    padded to 128)."""
    q = TALL_NT if dtype == torch.bfloat16 else 8
    return -(-n // q) * q


@dataclasses.dataclass(frozen=True)
class TallPlan:
    """How ``csrc/tsmm_tall.cu`` runs one launch: ``design`` (``wgmma`` for
    bf16; ``f32`` or ``tf32x3`` for fp32), the CTA row tile ``bm`` and
    column tile ``nt``, the ``cluster`` of CTAs that split each k range
    (wgmma) and the ring ``stages``.  The grid is ceil(m / bm) x
    ceil(n / nt) x splits x cluster CTAs."""
    design: str
    bm: int
    nt: int
    cluster: int
    stages: int


def tall_smem(plan: TallPlan) -> int:
    """Shared memory of one CTA of ``plan``, as ``csrc/tsmm_tall.cu`` lays
    it out: 1 KB of alignment slack, then the ring's stages (wgmma: a
    64 x 64 A tile and a 64 x 128 B tile, bf16; f32: a bm x 32 A tile and a
    32 x nt B tile, fp32; tf32x3: a bm x 32 A tile and B^T big and small,
    nt x 32 each, fp32) and an mbarrier pair per stage."""
    if plan.design == "wgmma":
        stage = TALL_BM * TALL_BK * 2 + TALL_BK * TALL_NT * 2
    else:
        b_tiles = 2 if plan.design == "tf32x3" else 1
        stage = (plan.bm + b_tiles * plan.nt) * TALL_FBK * 4
    return 1024 + plan.stages * (stage + 16)


@functools.lru_cache(maxsize=1024)
def tall_plan(m: int, k: int, n: int, *, dtype, packed: bool, pbm: int,
              pbk: int, mode: int, splits: int, kps: int,
              sms: int) -> TallPlan:
    """The launch plan of the tall kernel for A (m, k) (packed at
    (pbm, pbk) when ``packed``), B (k, n), ``splits`` k ranges of ``kps``
    each, on a card of ``sms`` SMs.  Pure: the CPU tests reach it.

    bf16 (wgmma): 64 x 128 tiles; the smallest cluster (1, 2, 4, 8) whose
    k split gives every SM a CTA, limited to what divides the range's
    64-deep k tiles (a single 128-deep ``kouter`` block gets 2); a ring of
    4 stages, 3 with a cluster of 4 or more.  The rule fills the card at
    any m without a table of measured shapes; ``launch/tall_sweep.py``
    times it against every other cluster and ring depth (at GLM-4-9B's
    m = 2048 a 2-CTA cluster, 128 CTAs with 4 SMs idle, measured faster:
    PERF.md §6).

    fp32: by N padded to 8, ``f32`` below ``TALL_F32_CROSSOVER`` (the
    narrowest of 8, 16, 32, 64 columns that holds N, else 64-column
    tiles; a ring of ``TALL_F32_STAGES``) and ``tf32x3`` at or above it
    (N rounded up to 8 in equal tiles of at most ``TALL_X3_NT`` columns:
    the fewest such tiles or one more, whichever takes fewer waves of the
    card times the work of a CTA (its columns and ``TALL_X3_TILE_COST``),
    the fewer on a tie; the deepest ring of up
    to ``TALL_X3_STAGES`` that fits); both a row tile of 128 where that
    still gives every SM a CTA, else 64.  At the paper's M = 25600 the
    wave rule splits N = 192 into three 64-column tiles (600 CTAs, 4.5
    waves) rather than two of 96 (400, 3.03 waves): 20 % faster in
    ``launch/tall_sweep.py --dtype float32``; at N = 240 its three tiles
    of 80 and two of 120 measured within 1-3 % (PERF.md §6).  ``launch/tall_sweep.py --dtype float32`` times every
    design, column tile, row tile and ring depth.

    Raises LaunchRefused on a layout the design cannot take (no design takes
    another's layouts): bf16 N off the 128-column tile, a k range off the
    64-deep stage, packed blocks the tile cuts; fp32 N off a multiple of 4
    (B's rows must be 16-byte multiples for TMA), a k range off the
    32-deep stage, a natural K off a multiple of 4, packed blocks off
    (8, 32)."""
    if n <= 0 or m <= 0:
        raise LaunchRefused(f"tall plan: an ({m}, {n}) output")
    if kps <= 0 or splits <= 0 or (splits > 1 and mode != RAW_F32):
        raise LaunchRefused(f"tall plan: {splits} splits of {kps} in mode "
                            f"{mode}")
    if dtype == torch.bfloat16:
        if n % TALL_NT:
            raise LaunchRefused(f"tall plan: N={n} is not a multiple of 128")
        if packed and (pbm % TALL_BM or pbk % TALL_BK):
            raise LaunchRefused(f"tall plan: packed blocks ({pbm}, {pbk}) are "
                                f"not cut by the wgmma tile ({TALL_BM}, "
                                f"{TALL_BK})")
        if kps % TALL_BK:
            raise LaunchRefused(f"tall plan: a k range of {kps} is not a "
                                f"multiple of the {TALL_BK}-deep wgmma stage")
        base = -(-m // TALL_BM) * (n // TALL_NT) * splits
        ktiles = kps // TALL_BK
        cluster = 1
        while (cluster < TALL_MAX_CLUSTER and base * cluster < sms
               and ktiles % (2 * cluster) == 0):
            cluster *= 2
        return TallPlan("wgmma", TALL_BM, TALL_NT, cluster,
                        TALL_STAGES - (cluster >= 4))
    if dtype != torch.float32:
        raise TypeError(f"tall plan: dtype {dtype} not supported")
    if n % 4:
        raise LaunchRefused(f"tall plan: N={n} is not a multiple of 4 (B's "
                            f"rows are TMA rows of 16-byte multiples)")
    if kps % TALL_FBK:
        raise LaunchRefused(f"tall plan: a k range of {kps} is not a multiple "
                            f"of the {TALL_FBK}-deep fp32 stage")
    if packed and (pbm % 8 or pbk % TALL_FBK):
        raise LaunchRefused(f"tall plan: packed blocks ({pbm}, {pbk}) are not "
                            f"cut by the fp32 tiles (8, {TALL_FBK})")
    if not packed and k % 4:
        raise LaunchRefused(f"tall plan: K={k} is not a multiple of 4 (A's "
                            f"rows are TMA rows of 16-byte multiples)")
    def row_tile(nt):
        cols = -(-n // nt) * splits
        return 128 if -(-m // 128) * cols >= sms else 64

    if tall_width(n, dtype) < TALL_F32_CROSSOVER:
        nt = next((t for t in TALL_F32_NT if t >= n), TALL_F32_NT[-1])
        return TallPlan("f32", row_tile(nt), nt, 1, TALL_F32_STAGES)

    def rounds_x_width(tiles):
        nt = tall_width(-(-n // tiles), dtype)
        ctas = -(-m // row_tile(nt)) * tiles * splits
        return -(-ctas // sms) * (nt + TALL_X3_TILE_COST), tiles

    tiles = -(-n // TALL_X3_NT)
    _, tiles = min(rounds_x_width(t) for t in (tiles, tiles + 1))
    nt = tall_width(-(-n // tiles), dtype)
    bm = row_tile(nt)
    stages = next(s for s in range(TALL_X3_STAGES, 1, -1)
                  if tall_smem(TallPlan("tf32x3", bm, nt, 1, s))
                  <= TALL_SMEM_MAX)
    return TallPlan("tf32x3", bm, nt, 1, stages)


def grid_ctas(plan, m: int, n: int, splits: int) -> int:
    """CTAs of one launch of ``plan`` over (m, n) outputs in ``splits`` k
    ranges: ceil(m / bm) x ceil(n / nt) x splits x cluster.  Every design
    (tall and skinny) keeps its loads in flight from one CTA's TMA ring,
    so one CTA an SM runs it at its rate: the cost model's occupancy term
    (``core/smem_model.py::occupancy``) sets these CTAs against the SMs."""
    return -(-m // plan.bm) * -(-n // plan.nt) * splits * plan.cluster


def check_tma(t, name: str, what: str) -> None:
    """Raise unless ``t`` can be read through a TMA tensor map: a 16-byte
    aligned base, the last dim contiguous and every other stride a
    multiple of 16 bytes."""
    es = t.element_size()
    if t.data_ptr() % 16:
        raise LaunchRefused(f"{name}: {what} is not 16-byte aligned (TMA)")
    if t.stride(-1) != 1:
        raise LaunchRefused(f"{name}: the last dim of {what} must be "
                            f"contiguous")
    for d in range(t.dim() - 1):
        if (t.stride(d) * es) % 16:
            raise LaunchRefused(f"{name}: {what} stride {t.stride(d)} of dim "
                                f"{d} is not a multiple of 16 bytes (TMA)")


def _tall_dims(a) -> tuple:
    """(M, K) of a natural (M, K) or a packed (nm, nk, bm, bk) A."""
    if a.dim() == 4:
        nm, nk, bm, bk = a.shape
        return nm * bm, nk * bk
    return tuple(a.shape)


def _torch_tall(a, b, bias, act, *, mode: int, splits: int, k0: int, k1: int,
                out):
    """Plain version of the tall CUDA kernel over k in [k0, k1): the blocked
    einsum of the reference's ``impl="xla"`` twins (natural or packed A)
    with fp32 accumulation, the k range cut into ``splits`` partial sums.
    Mode ``RAW_F32`` returns the fp32 partials (splits, M, N);
    ``ACCUM_F32`` adds the sum into the fp32 ``out``, applies bias and the
    activation there, and returns ``out``; ``EPILOGUE`` applies them to
    the fp32 sum and casts once to B's type."""
    n = b.shape[1]
    bf = b[k0:k1].float()
    if a.dim() == 4:
        nm, _, bm, bk = a.shape
        ap = a[:, k0 // bk:k1 // bk].float()
        nki = ap.shape[1] // splits
        parts = torch.einsum("msjab,sjbn->sman",
                             ap.reshape(nm, splits, nki, bm, bk),
                             bf.reshape(splits, nki, bk, n)
                             ).reshape(splits, nm * bm, n)
    else:
        m = a.shape[0]
        kk = (k1 - k0) // splits
        parts = torch.einsum("msk,skn->smn",
                             a[:, k0:k1].float().reshape(m, splits, kk),
                             bf.reshape(splits, kk, n))
    if mode == RAW_F32:
        return parts
    acc = parts.sum(0)
    if mode == ACCUM_F32:
        acc = acc + out
    if bias is not None:
        acc = acc + bias.float()[None, :]
    acc = act_ref(acc, act)
    if mode == ACCUM_F32:
        return out.copy_(acc)
    return acc.to(b.dtype)


def launch_tall(name: str, a, b, bias, act, *, mode: int, splits: int = 1,
                k0: int = 0, k1=None, out=None, impl=None):
    """Run the tall-A function on ``a``'s device: the CUDA kernel for a
    CUDA tensor (counted under ``name``), the plain version on the CPU.

    ``a`` natural (M, K) or packed (nm, nk, bm, bk), contiguous; ``b``
    (K, N) (bf16: N a multiple of 128; fp32: of 4, padded by the callers
    to :func:`tall_width`); ``bias`` (N,) or None.  The k range is
    [k0, k1) (default all of K), cut into ``splits`` equal parts.
    :func:`tall_plan` picks the design (bf16: ``wgmma``; fp32: ``f32`` or
    ``tf32x3`` by N) and its launch configuration; a layout the design
    cannot take (:func:`tall_plan`, :func:`check_tma`) raises.
    ``EPILOGUE`` returns (M, N) in B's type; ``RAW_F32`` the fp32 partials
    (splits, M, N); ``ACCUM_F32`` updates and returns the fp32 (M, N)
    ``out``.  ``impl``: see the module docstring."""
    m, k = _tall_dims(a)
    k1 = k if k1 is None else k1
    if (b.dim() != 2 or b.shape[0] != k or not 0 <= k0 < k1 <= k
            or (k1 - k0) % splits or (splits > 1 and mode != RAW_F32)):
        raise ValueError(f"{name}: A {tuple(a.shape)}, B {tuple(b.shape)}, "
                         f"k range [{k0}, {k1}) / {splits} splits, mode "
                         f"{mode} do not fit")
    n = b.shape[1]
    if mode == ACCUM_F32 and (out is None or out.shape != (m, n)
                              or out.dtype != torch.float32):
        raise ValueError(f"{name}: accumulate mode needs an fp32 ({m}, {n}) "
                         f"output")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({n},)")
    if plain(a, impl, name):
        return _torch_tall(a, b, bias, act, mode=mode, splits=splits, k0=k0,
                           k1=k1, out=out)
    if a.dtype not in _DTYPE:
        raise TypeError(f"{name}: dtype {a.dtype} not supported")
    if act not in _ACT:
        raise ValueError(f"{name}: unknown activation {act!r}")
    for t, what in ((a, "A"), (b, "B"), (bias, "bias"), (out, "output")):
        if t is None:
            continue
        if t.device != a.device or (t.dtype != a.dtype and what != "output"):
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}, "
                            f"A is {a.dtype} on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    packed = a.dim() == 4
    pbm, pbk = (a.shape[2], a.shape[3]) if packed else (0, 0)
    kps = (k1 - k0) // splits
    plan = tall_plan(m, k, n, dtype=a.dtype, packed=packed, pbm=pbm, pbk=pbk,
                     mode=mode, splits=splits, kps=kps,
                     sms=_sm_count(a.device.index))
    check_tma(a, name, "A")
    check_tma(b, name, "B")
    if out is not None and out.data_ptr() % 16:
        raise ValueError(f"{name}: the output is not 16-byte aligned")
    if out is None:
        out = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device) if mode == RAW_F32 else
               torch.empty((m, n), dtype=b.dtype, device=a.device))
    # tf32x3: B^T big and small of the launch's k range, written by the
    # design's split pass
    scratch = (torch.empty((2, -(-n // plan.nt) * plan.nt, k1 - k0),
                           dtype=torch.float32, device=a.device)
               if plan.design == "tf32x3" else None)
    lib = cuda.load()["tsmm_tall"]
    rc = lib.tsmm_tall_launch(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), m, k,
        n, int(packed), pbm, pbk, k0, kps, splits, _TALL_DESIGN[plan.design],
        plan.bm, plan.nt, plan.cluster, plan.stages, mode, _ACT[act],
        _DTYPE[a.dtype], cuda.stream(a.device))
    cuda.check(rc, name)
    cuda.count(name, f"tall_{plan.design}")
    return out


def tsmm_tall_a(a, b, bias=None, *, bm: int, bk: int, act=None, dims=(),
                m_split: int = 1, impl=None):
    """C = act(A @ B + bias).  A (M, K) with M % bm == 0, K % bk == 0; B
    (K, N), N at :func:`tall_width` (bf16 a multiple of 128, fp32 of 8).
    The epilogue is fused into the kernel's store.  ``dims`` and
    ``m_split`` have no effect on the card (see the module docstring)."""
    del dims, m_split
    m, k = a.shape
    if b.shape[0] != k or m % bm or k % bk:
        raise ValueError(f"tsmm_tall_a: A {tuple(a.shape)}, B "
                         f"{tuple(b.shape)} do not tile by ({bm}, {bk})")
    return launch_tall("tsmm_tall_a", a, b, bias, act, mode=EPILOGUE,
                       impl=impl)


def tsmm_packed_a(ap, b, bias=None, *, act=None, dims=(), m_split: int = 1,
                  impl=None):
    """C = act(unpack(Ap) @ B + bias) with Ap (nm, nk, bm, bk) block-major;
    returns (nm*bm, N) in B's type.  Epilogue fused as in
    ``tsmm_tall_a``; ``dims`` and ``m_split`` have no effect."""
    del dims, m_split
    return launch_tall("tsmm_packed_a", ap, b, bias, act, mode=EPILOGUE,
                       impl=impl)


# the pack kernel's designs (csrc/pack_blocks.cu): packs whose output
# reaches PACK_TMA_MIN_BYTES run the TMA design where its layout rules
# allow (chunks of at most PACK_TMA_CHUNK_BYTES, a ring of
# PACK_TMA_STAGES, PACK_TMA_CTAS_PER_SM persistent CTAs an SM); the rest
# run the vec design (CTAs of PACK_VEC_THREADS threads, each with up to
# PACK_VEC_UNROLL rows of one 16-byte column vector in flight).
PACK_TMA_MIN_BYTES = 8 << 20
PACK_TMA_CHUNK_BYTES = 16 << 10
PACK_TMA_STAGES, PACK_TMA_CTAS_PER_SM, PACK_TMA_THREADS = 4, 2, 128
PACK_VEC_THREADS, PACK_VEC_UNROLL = 256, 4
PACK_BOX_MAX = 256                # elements a side of a TMA box
PACK_SMEM_MAX = 232448            # opt-in shared memory of one CTA
_PACK_DESIGN = {"vec": 0, "tma": 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """How ``csrc/pack_blocks.cu`` runs one pack: ``design`` (``tma`` or
    ``vec``), the block ``rows`` of one chunk (tma) or of one CTA (vec),
    the ``grid`` of CTAs of ``threads`` threads, the ring ``stages`` (tma;
    0 for vec) and ``box``: the columns of one TMA box (tma) or the
    elements of one access (vec)."""
    design: str
    rows: int
    grid: int
    threads: int
    stages: int
    box: int


def pack_tma_box(k: int, bk: int, esize: int, align: int) -> int:
    """The TMA box width (columns) of a pack of rows of ``k`` elements into
    ``bk``-wide blocks from a source base aligned to ``align`` bytes, or 0
    where TMA cannot take the layout: the base and the row stride must be
    16-byte aligned, a box is at most ``PACK_BOX_MAX`` elements (a wider
    bk moves as bk / 256 boxes, so it must divide by 256) and its row a
    multiple of 16 bytes."""
    if align % 16 or (k * esize) % 16:
        return 0
    box = bk if bk <= PACK_BOX_MAX else PACK_BOX_MAX
    if bk % box or (box * esize) % 16:
        return 0
    return box


def pack_tma_rows(bm: int) -> tuple:
    """The chunk heights the TMA design takes for ``bm``-row blocks:
    divisors of bm, multiples of 8 (a box of 128-byte multiples), at most
    ``PACK_BOX_MAX``."""
    return tuple(r for r in range(8, min(bm, PACK_BOX_MAX) + 1, 8)
                 if bm % r == 0)


def pack_tma_smem(rows: int, bk: int, esize: int, stages: int) -> int:
    """Shared memory of one TMA-design CTA, as ``csrc/pack_blocks.cu``
    lays it out: 128 bytes of alignment slack, then per stage a chunk and
    an 8-byte mbarrier."""
    return 128 + stages * (rows * bk * esize + 8)


def pack_vec_shape(bk: int, esize: int, threads: int) -> tuple:
    """(elements per access, rows a pass) of a vec-design CTA: the widest
    access of at most 16 bytes that divides a block row of ``bk``
    elements; the threads lie over the row's accesses first, so a pass
    covers threads // (bk / access) rows (at least one)."""
    box = math.gcd(16, bk * esize) // esize
    return box, threads // min(bk // box, threads)


def pack_tma_plan(L: int, M: int, K: int, bm: int, bk: int, esize: int,
                  align: int, sms: int):
    """The TMA design's plan for a pack of any size, or None where its
    layout rules refuse it: the box of :func:`pack_tma_box`, the tallest
    chunk of :func:`pack_tma_rows` within ``PACK_TMA_CHUNK_BYTES``, a ring
    of ``PACK_TMA_STAGES`` and a persistent grid of
    ``PACK_TMA_CTAS_PER_SM`` CTAs an SM (fewer if there are fewer
    chunks)."""
    box = pack_tma_box(K, bk, esize, align)
    rows = [r for r in pack_tma_rows(bm)
            if r * bk * esize <= PACK_TMA_CHUNK_BYTES]
    if not box or not rows:
        return None
    chunks = L * -(-M // bm) * -(-K // bk) * (bm // rows[-1])
    return PackPlan("tma", rows[-1], min(chunks, PACK_TMA_CTAS_PER_SM * sms),
                    PACK_TMA_THREADS, PACK_TMA_STAGES, box)


@functools.lru_cache(maxsize=1024)
def pack_plan(L: int, M: int, K: int, bm: int, bk: int, dtype, align: int,
              sms: int) -> PackPlan:
    """The launch plan of the pack kernel for ``L`` stacked (M, K)
    matrices into (bm, bk) blocks, the source base aligned to ``align``
    bytes, on a card of ``sms`` SMs.  Pure: the CPU tests reach it.

    Packs whose output reaches ``PACK_TMA_MIN_BYTES`` (weights at load,
    the prefill A pack) take the TMA design where its layout rules allow
    (:func:`pack_tma_plan`).  Every other pack takes the vec design: one
    CTA per chunk of rows, the chunk cut from ``PACK_VEC_UNROLL`` rows a
    thread down to one until the grid fills a wave of the card (``sms`` x
    2048 threads), so the per-call decode pack of a (4096, 256) weight
    spreads over every SM.  Below the threshold the vec design also spares
    the host the two tensor-map encodings.  ``launch/pack_sweep.py`` times
    every plan these rules choose from.  Raises LaunchRefused on sizes the
    kernel does not take, TypeError on a dtype other than float32 and
    bfloat16."""
    if dtype not in _ESIZE:
        raise TypeError(f"pack plan: dtype {dtype} not supported")
    if min(L, M, K, bm, bk) <= 0 or align <= 0:
        raise LaunchRefused(f"pack plan: {L} x ({M}, {K}) by ({bm}, {bk}), "
                            f"align {align}")
    es = _ESIZE[dtype]
    blocks = L * -(-M // bm) * -(-K // bk)
    if bm * bk >= 2 ** 31 or blocks >= 2 ** 31:
        raise LaunchRefused(f"pack plan: {blocks} blocks of ({bm}, {bk}) are "
                            f"out of range")
    if blocks * bm * bk * es >= PACK_TMA_MIN_BYTES:
        plan = pack_tma_plan(L, M, K, bm, bk, es, align, sms)
        if plan is not None:
            return plan
    box, ty = pack_vec_shape(bk, es, PACK_VEC_THREADS)
    wave = sms * (2048 // PACK_VEC_THREADS)
    rows = min(ty * PACK_VEC_UNROLL, -(-bm // ty) * ty)
    while rows > ty and blocks * -(-bm // rows) < wave:
        rows //= 2
    grid = blocks * -(-bm // rows)
    if grid >= 2 ** 31:
        raise LaunchRefused(f"pack plan: a grid of {grid} CTAs")
    return PackPlan("vec", rows, grid, PACK_VEC_THREADS, 0, box)


def pack_smem(plan: PackPlan, bk: int, esize: int) -> int:
    """Shared memory of one CTA of ``plan``: the TMA design's ring
    (:func:`pack_tma_smem`); the vec design holds none."""
    if plan.design == "tma":
        return pack_tma_smem(plan.rows, bk, esize, plan.stages)
    return 0


def pack_work(plan: PackPlan, L: int, M: int, K: int, bm: int, bk: int):
    """The chunks each CTA of ``plan`` moves, in the kernel's order: yields
    (cta, blk, l, i, j, r0, r1): rows [r0, r1) of output block ``blk`` =
    (l, i, j) (layer, block row, block column), read from rows i*bm + r0
    .. i*bm + r1 and columns j*bk .. j*bk + bk of layer l (zero past M and
    K) and written to the output's elements (blk*bm + r0)*bk ..
    (blk*bm + r1)*bk.  The vec design gives CTA c chunk c; the TMA design
    chunks c, c + grid, ...  Pure: the CPU tests replay it."""
    nm, nk = -(-M // bm), -(-K // bk)
    cpb = -(-bm // plan.rows)
    chunks = L * nm * nk * cpb
    for cta in range(plan.grid):
        for chunk in (range(cta, chunks, plan.grid) if plan.design == "tma"
                      else (cta,)):
            blk, g = divmod(chunk, cpb)
            l, ij = divmod(blk, nm * nk)
            i, j = divmod(ij, nk)
            yield (cta, blk, l, i, j, g * plan.rows,
                   min(bm, (g + 1) * plan.rows))


def launch_pack(a, out, bm: int, bk: int, alpha: float, plan: PackPlan):
    """Launch ``csrc/pack_blocks.cu`` by ``plan``: ``a`` (..., M, K)
    contiguous on the card, ``out`` its (..., nm, nk, bm, bk) pack.
    Counts the launch under ``pack_blocks`` and its design."""
    m, k = a.shape[-2:]
    rc = cuda.load()["pack_blocks"].pack_blocks_launch(
        a.data_ptr(), out.data_ptr(), a.numel() // (m * k), m, k, bm, bk,
        alpha, _DTYPE[a.dtype], _PACK_DESIGN[plan.design], plan.rows,
        plan.grid, plan.threads, plan.stages, plan.box,
        cuda.stream(a.device))
    cuda.check(rc, "pack_blocks")
    cuda.count("pack_blocks", f"pack_{plan.design}")
    return out


def pack_blocks_kernel(a, bm: int, bk: int, *, alpha: float = 1.0,
                       impl=None):
    """(..., M, K) -> (..., nm, nk, bm, bk) block-major, zero-padded to
    block multiples, alpha folded (fp32 multiply, cast back).

    A CUDA tensor launches ``csrc/pack_blocks.cu`` (which writes the
    padding itself, so M and K need not divide) by :func:`pack_plan`'s
    design; a CPU tensor takes the plain reshape/transpose,
    ``kernels/ref.py::pack_ref`` (``impl``: see the module docstring)."""
    if plain(a, impl, "pack_blocks"):
        return pack_ref(a, bm, bk, alpha=alpha)
    if a.dtype not in _DTYPE:
        raise TypeError(f"pack_blocks: dtype {a.dtype} not supported")
    if a.dim() < 2 or bm <= 0 or bk <= 0:
        raise ValueError(f"pack_blocks: {tuple(a.shape)} by ({bm}, {bk})")
    a = a.contiguous()
    m, k = a.shape[-2:]
    lead = a.shape[:-2]
    out = torch.empty((*lead, -(-m // bm), -(-k // bk), bm, bk),
                      dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    plan = pack_plan(math.prod(lead), m, k, bm, bk, a.dtype,
                     math.gcd(a.data_ptr(), 16), _sm_count(a.device.index))
    return launch_pack(a, out, bm, bk, float(alpha), plan)
