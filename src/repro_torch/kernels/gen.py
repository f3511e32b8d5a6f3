"""Grammar points lowered onto the CUDA TSMM kernels.

The port of the reference package's ``kernels/gen.py``.  Each valid
:class:`~repro_torch.kernels.variants.grammar.GenSpec` runs one kernel
in the mode its axes ask for: ``csrc/tsmm_skinny.cu`` for skinny-A,
``csrc/tsmm_tall.cu`` for tall-A.  The reference's epilogue placement is
kept for every point:

* ``ksplit>1``      — :func:`_skinny_ksplit` / :func:`_tall_ksplit`: fp32
  partials (splits, m, N) from the kernel's split grid axis; the caller's
  ``sum(0)`` and :func:`_epilogue_f32` are the reduction (plain torch,
  outside any kernel, as in the reference);
* ``acc=revisit``   — the k-inner kernel writes fp32 (skinny: raw sums,
  then the cast pass with the epilogue; tall: the epilogue applied in
  place on the fp32 output, then one cast);
* ``acc=vmem``      — the k-inner kernel with the epilogue fused, output
  in the input type;
* ``loop=kouter``   — tall only, :func:`_tall_kouter`: one launch per k
  block over every row, each adding its k slice into one fp32 (M, N)
  accumulator; the epilogue rides the final cast pass;
* ``epi=split``     — the kernel writes the raw sums cast to the output
  type and :func:`_split_epilogue` applies bias and activation to the
  cast result (it rounds twice, as the reference does);
* ``packfuse``      — skinny only: the kernel reads the natural (K, N)
  weight;
* ``bres=resident`` — the same kernel: operand residency is a
  shared-memory choice on the TPU with the same result; on the card the
  L2 holds the resident operand (see the kernels' source notes).

:func:`tall_steps` and :func:`skinny_steps` name the kernels and plain
passes of each point; the emitters run them and :func:`launches` plans
them (the cost model's launch gate and launch key read it), so the
dispatch lives here only.

The grid schedule (``dims``, ``m_split``) has nothing to apply to on the
GPU (a CUDA grid has no dimension semantics and already spreads row tiles
over every SM), so it is accepted and ignored.  The
baseline points delegate to ``ops.tsmm_skinny`` / ``ops.tsmm`` /
``ops.tsmm_packed``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import packing
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tsmm as _k
from repro_torch.kernels.ops import _ceil_to, _pad_bias
from repro_torch.kernels.variants.grammar import BASELINE_POINT, GenSpec


def split_divisor(nk: int, want: int) -> int:
    """Largest divisor of ``nk`` that is <= ``want`` (>= 1) — the runtime
    clamp for k-split plans whose block count the split does not divide
    (override plans; enumerated plans are gated by the cost model)."""
    d = max(1, min(int(want), int(nk)))
    while nk % d:
        d -= 1
    return d


def _epilogue_f32(out, bias, act, dtype):
    """Bias + activation on an fp32 result, then one cast (the k-split
    reduction's and the revisit cast pass's epilogue)."""
    if bias is not None:
        out = out + bias.float()[None, :]
    return _ref.act_ref(out, act).to(dtype)


def _split_epilogue(out, bias, act):
    """The ``epi=split`` second pass over the CAST output: bias and
    activation in fp32, cast back."""
    o = out.float()
    if bias is not None:
        o = o + bias.float()[None, :]
    return _ref.act_ref(o, act).to(out.dtype)


def _tall_blocks(a, b, bm, bk, packed):
    """(M, nm, nk, bm, bk) of a tall operand pair, checked as the
    reference's Pallas kernels assert."""
    if packed:
        nm, nk, bm, bk = a.shape
        m, k = nm * bm, nk * bk
    else:
        m, k = a.shape
        if m % bm or k % bk:
            raise ValueError(f"tall-A: A {tuple(a.shape)} does not tile by "
                             f"({bm}, {bk})")
        nm, nk = m // bm, k // bk
    if b.shape[0] != k:
        raise ValueError(f"tall-A: A {tuple(a.shape)} vs B {tuple(b.shape)}")
    return m, nm, nk, bm, bk


def _tall_kinner(a, b, bias, *, bm, bk, act, packed, resident, revisit):
    """K-inner tall-A (TPU: ``gen.py::_tall_kinner``).  ``revisit``
    accumulates into a zeroed fp32 output with the epilogue applied there
    (the caller casts); otherwise the epilogue is fused and the output is
    in B's type.  ``resident`` selects the same kernel (see the module
    docstring)."""
    del resident
    m, _, _, _, _ = _tall_blocks(a, b, bm, bk, packed)
    if revisit:
        out = torch.zeros((m, b.shape[1]), dtype=torch.float32,
                          device=a.device)
        return _k.launch_tall("tall_kinner", a, b, bias, act,
                              mode=_k.ACCUM_F32, out=out)
    return _k.launch_tall("tall_kinner", a, b, bias, act, mode=_k.EPILOGUE)


def _tall_ksplit(a, b, *, bm, bk, splits, packed, resident):
    """K-split tall-A (TPU: ``gen.py::_tall_ksplit``): fp32 partials
    (splits, M, N); the caller reduces and applies the epilogue."""
    del resident
    _, _, nk, _, _ = _tall_blocks(a, b, bm, bk, packed)
    if nk % splits:
        raise ValueError(f"tall-A k-split: {splits} splits do not divide "
                         f"{nk} k blocks")
    return _k.launch_tall("tall_ksplit", a, b, None, None, mode=_k.RAW_F32,
                          splits=splits)


def _tall_kouter(a, b, *, bm, bk, packed):
    """K-outer tall-A (TPU: ``gen.py::_tall_kouter``): nk launches, launch
    j adding A[:, k block j] @ B[k block j] into one fp32 (M, N)
    accumulator over every row, so each reads and writes the accumulator
    (the traffic the cost model prices).  Returns the fp32 sums; the
    caller applies the epilogue and casts."""
    m, _, nk, bm, bk = _tall_blocks(a, b, bm, bk, packed)
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for j in range(nk):
        _k.launch_tall("tall_kouter", a, b, None, None, mode=_k.ACCUM_F32,
                       k0=j * bk, k1=(j + 1) * bk, out=acc)
    return acc


def _skinny_kinner(x, w, bias, *, bk, bn, act, natural, resident, revisit):
    """K-inner skinny-A (TPU: ``gen.py::_skinny_kinner``).  ``natural``
    reads W in its (K, N) layout; ``revisit`` returns the raw fp32 sums
    (the caller's cast pass applies the epilogue); otherwise bias and
    activation are fused and the output is in X's type.  ``resident``
    selects the same kernel (see the module docstring)."""
    del resident
    if revisit:
        return _k.launch_skinny("skinny_kinner", x, w, None, None,
                                natural=natural, splits=1, mode=_k.RAW_F32,
                                bk=bk, bn=bn)[0]
    return _k.launch_skinny("skinny_kinner", x, w, bias, act, natural=natural,
                            splits=1, mode=_k.EPILOGUE, bk=bk, bn=bn)


def _skinny_ksplit(x, w, *, bk, bn, splits, natural, resident):
    """K-split skinny-A (TPU: ``gen.py::_skinny_ksplit``): fp32 partials
    (splits, m, N); the caller reduces and applies the epilogue."""
    del resident
    return _k.launch_skinny("skinny_ksplit", x, w, None, None,
                            natural=natural, splits=splits, mode=_k.RAW_F32,
                            bk=bk, bn=bn)


def tall_steps(g: GenSpec, nk: int, packed: bool) -> tuple:
    """What a tall grammar point runs over ``nk`` k blocks, in order: each
    kernel as ``(launch counter, mode, splits, count)`` and each plain pass
    between kernels as ``("torch", pass, arg, 0)``.  For a call without
    bias and activation: an ``epi=split`` point adds its second pass only
    when there is an epilogue to apply.  :func:`emit_tall_a` follows it,
    and :func:`launches` plans it for the cost model's launch gate."""
    if g == BASELINE_POINT:
        return (("tsmm_packed_a" if packed else "tsmm_tall_a",
                 _k.EPILOGUE, 1, 1),)
    if g.loop == "kouter":
        return (("tall_kouter", _k.ACCUM_F32, 1, nk),
                ("torch", "epilogue_cast", None, 0))
    s = split_divisor(nk, g.ksplit)
    if s > 1:
        return (("tall_ksplit", _k.RAW_F32, s, 1), ("torch", "reduce", s, 0))
    if g.acc == "revisit":
        return (("tall_kinner", _k.ACCUM_F32, 1, 1), ("torch", "cast", None, 0))
    return (("tall_kinner", _k.EPILOGUE, 1, 1),)


def skinny_steps(g: GenSpec, nk: int, packed: bool) -> tuple:
    """:func:`tall_steps` for the skinny-A orientation; a natural weight
    that the point does not read in place is packed first, every call
    (``("pack_blocks", 0, 1, 1)``)."""
    out = ()
    if not packed and not g.packfuse:
        out = (("pack_blocks", 0, 1, 1),)
    if g == BASELINE_POINT or (g.packfuse and packed):
        return out + (("tsmm_skinny_a", _k.EPILOGUE, 1, 1),)
    s = split_divisor(nk, g.ksplit)
    if s > 1:
        return out + (("skinny_ksplit", _k.RAW_F32, s, 1),
                      ("torch", "reduce", s, 0))
    if g.acc == "revisit":
        return out + (("skinny_kinner", _k.RAW_F32, 1, 1),
                      ("torch", "epilogue_cast", None, 0))
    return out + (("skinny_kinner", _k.EPILOGUE, 1, 1),)


def _post(out, passes, bias, act, dtype):
    """The plain passes of a step list on the last kernel's output."""
    for _, what, _, _ in passes:
        if what == "cast":
            out = out.to(dtype)
        else:   # "reduce" the fp32 partials, or "epilogue_cast"
            out = _epilogue_f32(out.sum(0) if what == "reduce" else out,
                                bias, act, dtype)
    return out


@functools.lru_cache(maxsize=8192)
def launches(g: GenSpec, orientation: str, m: int, k: int, n: int, *,
             dtype, bm: int, bk: int, bn: int, prepack: bool,
             sms: int) -> tuple:
    """The launches ``core/tsmm.py::tsmm_dot`` makes for one plan on a card
    of ``sms`` SMs, as the wrappers would plan them (pure: nothing is
    launched), for a call without bias and activation.

    Each entry is ``(kernel, mode, splits, kps, launch plan, layout, dims,
    count, smem)``: the kernel source (``tsmm_tall``, ``tsmm_skinny``,
    ``pack_blocks``), its output mode and k split, the k range of one
    split, the :class:`~repro_torch.kernels.tsmm.TallPlan` /
    ``SkinnyPlan`` / ``PackPlan``, the operand layout it reads, the padded
    (M, K, N) (a tall N at ``tall_width``; a pack: (L, M, K, bm, bk)),
    how many times it runs per call and the shared memory of one of its
    CTAs; the plain passes of
    :func:`tall_steps` / :func:`skinny_steps` enter as ``("torch", pass,
    arg, 0)``.  ``tsmm_dot`` packs a tall A on every call; a pre-packed
    skinny weight was packed at load.  Raises ValueError where a wrapper
    refuses the layout."""
    eb = torch.empty((), dtype=dtype).element_size()
    out = []

    def pack(rows, cols, b0, b1):
        pp = _k.pack_plan(1, rows, cols, b0, b1, dtype, 16, sms)
        out.append(("pack_blocks", 0, 1, 0, pp, "natural",
                    (1, rows, cols, b0, b1), 1, _k.pack_smem(pp, b1, eb)))

    if orientation == "tall_a":
        np_ = _k.tall_width(n, dtype)
        if prepack:
            pack(m, k, bm, bk)
            layout, pbm, pbk = ("packed", bm, bk), bm, bk
        else:
            bm = ops.tall_row_block(m, bm, dtype)
            layout, pbm, pbk = ("natural",), 0, 0
        mp, kp = _ceil_to(m, bm), _ceil_to(k, bk)
        for name, mode, splits, count in tall_steps(g, kp // bk, prepack):
            if name == "torch":
                out.append((name, mode, splits, 0))
                continue
            kps = kp // (splits * count)
            tp = _k.tall_plan(mp, kp, np_, dtype=dtype, packed=prepack,
                              pbm=pbm, pbk=pbk, mode=mode, splits=splits,
                              kps=kps, sms=sms)
            out.append(("tsmm_tall", mode, splits, kps, tp, layout,
                        (mp, kp, np_), count, _k.tall_smem(tp)))
        return tuple(out)
    if bn % 64:
        raise ValueError(f"skinny launch: bn={bn} is not a multiple of 64")
    natural = bool(g.packfuse) and not prepack
    kp, np_ = _ceil_to(k, bk), _ceil_to(n, bn)
    layout = ("natural",) if natural else ("packed", bk, bn)
    for name, mode, splits, count in skinny_steps(g, kp // bk, prepack):
        if name == "torch":
            out.append((name, mode, splits, 0))
        elif name == "pack_blocks":
            pack(k, n, bk, bn)
        else:
            sp = _k.skinny_plan(m, kp, np_, dtype=dtype, natural=natural,
                                bk=bk, bn=bn, mode=mode, splits=splits,
                                kps=kp // splits, sms=sms)
            out.append(("tsmm_skinny", mode, splits, kp // splits, sp,
                        layout, (m, kp, np_), count, _k.skinny_smem(sp)))
    return tuple(out)


def emit_tall_a(g: GenSpec, a, b, bias=None, act=None, *, bm: int = 0,
                bk: int = 0, packed: bool = False, schedule=None):
    """Lower grammar point ``g`` for the tall-A orientation, running the
    kernels of :func:`tall_steps`.

    ``a`` is natural (M, K) or packed (nm, nk, bm, bk) per ``packed``.
    Returns (M, N) for natural inputs (padding sliced off) or (nm*bm, N)
    for packed inputs (the caller slices rows)."""
    del schedule
    if g == BASELINE_POINT:
        if packed:
            return ops.tsmm_packed(a, b, bias, act=act)
        return ops.tsmm(a, b, bias, bm=bm, bk=bk, act=act)
    n = b.shape[1]
    if packed:
        _, nk, bm, bk = a.shape
        ap, bp = a, ops.pad_b_for_packed(a, b)
    else:
        m = a.shape[0]
        ap, bp, bm = ops.pad_tall(a, b, bm, bk)
        nk = bp.shape[0] // bk
    fused = g.epi != "split"
    biasp = _pad_bias(bias, bp.shape[1])
    bias_, act_ = (biasp, act) if fused else (None, None)
    (kernel, mode, splits, _), *passes = tall_steps(g, nk, packed)
    if kernel == "tall_kouter":
        out = _tall_kouter(ap, bp, bm=bm, bk=bk, packed=packed)
    elif kernel == "tall_ksplit":
        out = _tall_ksplit(ap, bp, bm=bm, bk=bk, splits=splits,
                           packed=packed, resident=g.bres == "resident")
    else:
        out = _tall_kinner(ap, bp, bias_, bm=bm, bk=bk, act=act_,
                           packed=packed, resident=g.bres == "resident",
                           revisit=mode == _k.ACCUM_F32)
    out = _post(out, passes, bias_, act_, b.dtype)
    if not fused and (bias is not None or act not in (None, "none")):
        out = _split_epilogue(out, biasp, act)
    if packed:
        return out[:, :n]
    return out[:m, :n]


def emit_skinny_a(g: GenSpec, x, w, bias=None, act=None, *, bk: int = 0,
                  bn: int = 0, packed: bool = True, schedule=None):
    """Lower grammar point ``g`` for the skinny-A orientation, running the
    steps of :func:`skinny_steps`.

    ``w`` is the packed (nk, nn, bk, bn) weight when ``packed`` else the
    natural (K, N) layout — non-packfuse points then pack it per call;
    packfuse points read the natural layout inside the kernel.  Returns
    (m, n_padded); the caller slices padded columns."""
    del schedule
    m = x.shape[0]
    nk = w.shape[0] if packed else _ceil_to(x.shape[1], bk) // bk
    steps = skinny_steps(g, nk, packed)
    if steps[0][0] == "pack_blocks":
        w = packing.pack(w, bk, bn).blocks
        steps = steps[1:]
    (kernel, mode, splits, _), *passes = steps
    if kernel == "tsmm_skinny_a":
        return ops.tsmm_skinny(x, w, bias, act=act)
    natural = w.dim() == 2
    if natural:
        kp, np_ = _ceil_to(x.shape[1], bk), _ceil_to(w.shape[1], bn)
        wq = ops.pad2(w, kp, np_).contiguous()
    else:
        _, nn, bk, bn = w.shape
        wq, kp, np_ = w, nk * bk, nn * bn
    xp = ops.pad2(x, m, kp).contiguous()
    fused = g.epi != "split"
    biasp = _pad_bias(bias, np_)
    bias_, act_ = (biasp, act) if fused else (None, None)
    if kernel == "skinny_ksplit":
        out = _skinny_ksplit(xp, wq, bk=bk, bn=bn, splits=splits,
                             natural=natural,
                             resident=g.bres == "resident")
    else:
        out = _skinny_kinner(xp, wq, bias_, bk=bk, bn=bn, act=act_,
                             natural=natural, resident=g.bres == "resident",
                             revisit=mode == _k.RAW_F32)
    out = _post(out, passes, bias_, act_, x.dtype)
    if not fused and (bias is not None or act not in (None, "none")):
        out = _split_epilogue(out, biasp, act)
    return out[:m]
